"""The SH kernels' choice of route (``ops.sh_encode.route``), on the CPU: for
every degree, n_to_pad 0-15 and around the widest vector row, bf16 and fp32
rows and aligned and misaligned addresses, against the rule written out by
hand; the vector route's row layout (whole padding vectors, then a
compile-time layout shifted by kShift, as ``csrc/sh_encode.cu:VectorRow``
builds it) against the plain version's row; every route's entry point is
defined in the source; and the CPU path launches nothing.
"""

import itertools
import re

import numpy as np
import pytest
import torch

from tcnn_tpu_torch.ops import _build, sh_encode

ITEMSIZES = {"bf16": 2, "fp32": 4}
ADDRESSES = (0, 256, 4096 + 16, 2, 4, 8, 12, 4096 + 8)


def _expected(degree, n_to_pad, itemsize, address):
    values_a_vector = 16 // itemsize
    width = n_to_pad + degree * degree
    whole = width % values_a_vector == 0 and width <= 24 * values_a_vector
    return "vector" if whole and address % 16 == 0 else "staged"


@pytest.mark.parametrize("dtype", list(ITEMSIZES))
@pytest.mark.parametrize("degree", range(1, sh_encode.MAX_DEGREE + 1))
def test_route(degree, dtype):
    itemsize = ITEMSIZES[dtype]
    wide = range(24 * 16 // itemsize - degree * degree - 9, 24 * 16 // itemsize - degree * degree + 9)
    for n_to_pad, address in itertools.product([*range(16), *wide], ADDRESSES):
        assert sh_encode.route(degree, n_to_pad, itemsize, address) == _expected(degree, n_to_pad, itemsize,
                                                                                 address), (n_to_pad, address)
    # At every degree some padding takes the vector route (the smallest that
    # fills the last vector) and the next one does not.
    vector_pads = [n for n in range(16) if sh_encode.route(degree, n, itemsize, 0) == "vector"]
    smallest = (-degree * degree) % (16 // itemsize)
    assert vector_pads[0] == smallest and sh_encode.route(degree, smallest + 1, itemsize, 0) == "staged"


def test_route_at_the_paths_shapes():
    # The NeRF sample: degree 3 with 7 padding columns in bf16 (16 columns,
    # 32 bytes); NERF_CONFIG: degree 4, no padding; fp32 at both.
    assert sh_encode.route(3, 7, 2, 0) == sh_encode.route(3, 7, 4, 0) == "vector"
    assert sh_encode.route(4, 0, 2, 0) == sh_encode.route(4, 0, 4, 0) == "vector"
    # A 16-column row 8 bytes past a boundary, a 9-column row.
    assert sh_encode.route(3, 7, 2, 8) == sh_encode.route(3, 0, 2, 0) == "staged"
    # The widest rows the vector route takes: 24 vectors (384 bytes).
    assert sh_encode.route(8, 128, 2, 0) == sh_encode.route(8, 32, 4, 0) == "vector"
    assert sh_encode.route(8, 136, 2, 0) == sh_encode.route(8, 36, 4, 0) == "staged"


def _vector_row(values, n_to_pad, pad_value, values_a_vector):
    """A row as the vector kernels lay it out: n_to_pad // V whole vectors
    of padding, then kVectors vectors whose column i of vector k holds SH
    value k V + i - kShift (padding where that is negative)."""
    d2 = len(values)
    shift = (values_a_vector - d2 % values_a_vector) % values_a_vector
    assert n_to_pad % values_a_vector == shift  # what makes the layout a compile-time one
    row = [pad_value] * (n_to_pad // values_a_vector * values_a_vector)
    for k in range((shift + d2) // values_a_vector):
        for i in range(values_a_vector):
            c = k * values_a_vector + i - shift
            row.append(pad_value if c < 0 else values[c])
    return row


@pytest.mark.parametrize("dtype", list(ITEMSIZES))
@pytest.mark.parametrize("degree", range(1, sh_encode.MAX_DEGREE + 1))
def test_vector_layout_is_the_plain_row(degree, dtype):
    values_a_vector = 16 // ITEMSIZES[dtype]
    x = torch.from_numpy(np.random.default_rng(degree).uniform(0, 1, (2, 3)).astype(np.float32))
    for n_to_pad in range(16):
        if sh_encode.route(degree, n_to_pad, ITEMSIZES[dtype], 0) != "vector":
            continue
        want = sh_encode.sh_encode_plain(x, degree, n_to_pad, 0.5, torch.float32)
        values = sh_encode.sh_encode_plain(x, degree, 0, 0.5, torch.float32)
        for r in range(x.shape[0]):
            got = _vector_row(values[r].tolist(), n_to_pad, 0.5, values_a_vector)
            assert got == want[r].tolist(), n_to_pad


def test_route_entry_points_exist():
    text = (_build.CSRC / "sh_encode.cu").read_text()
    assert set(sh_encode.SYMBOLS) == set(itertools.product(("forward", "backward"), ("vector", "staged")))
    for symbol in sh_encode.SYMBOLS.values():
        assert re.search(rf'extern "C" int {symbol}\(', text), symbol


def test_cpu_launches_nothing():
    x = torch.rand((5, 3))
    before = dict(sh_encode.ROUTE_LAUNCHES), sh_encode.LAUNCHES, sh_encode.BWD_LAUNCHES
    y = sh_encode.sh_encode(x, 3, 7)
    sh_encode.sh_backward_input(x, torch.ones_like(y, dtype=torch.float32), 3, 7)
    assert (dict(sh_encode.ROUTE_LAUNCHES), sh_encode.LAUNCHES, sh_encode.BWD_LAUNCHES) == before
