"""The Rng hash's field-decomposed jump (csrc/grid_common.cuh:rng_corners),
modelled with Python integers, against the JAX package's
``_grid_hash(..., HashType.Rng)`` and the port's ``ops.pcg32_jump.rng_hash``.

The hash of corner c of a cell jumps pcg32(1337) by a 64-bit step: the XOR
of the corner's coordinates p_i + bit_i(c), coordinate i shifted to bit s_i
= i * (64 // d). Every jump is a power of one LCG, so the jumps commute and
compose additively, with period 2^64. Where the fields of every corner stay
apart (every field but the top one has p_i + 1 < 2^(64 // d)) and no
coordinate wraps (p_i + 1 < 2^32), the XOR is a sum, and

    J(step of corner c) = prod_i J(p_i << s_i) o J(1 << s_i)^bit_i(c).

The kernels take one jump over each field's own bits (all fields in one
loop), one composition with J(1 << s_i) a dim, then 2^d multiply-adds
from the seeded state; elsewhere they jump corner by corner. The card runs
this only inside a kernel, so this test pins its arithmetic here: bit for
bit, the same integers.
"""

from functools import reduce
from operator import or_

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcnn_tpu.common import HashType
from tcnn_tpu.encodings.grid import _grid_hash
from tcnn_tpu_torch.encodings import create_encoding
from tcnn_tpu_torch.ops import grid_encode as ge
from tcnn_tpu_torch.ops import pcg32_jump as pj

M32, M64 = 2**32 - 1, 2**64 - 1
TABLE = pj.PCG32_JUMP_TABLE


def _then(acc, jump):
    """The affine map ``jump`` applied after ``acc``, both (mult, plus)."""
    return jump[0] * acc[0] & M64, (acc[1] * jump[0] + jump[1]) & M64


def _apply(jump, state):
    return (jump[0] * state + jump[1]) & M64


def _output(state):
    """pcg32's output permutation of a state (next_uint reads the old one)."""
    xorshifted = (((state >> 18) ^ state) >> 27) & M32
    rot = state >> 59
    return ((xorshifted >> rot) | (xorshifted << ((32 - rot) & 31))) & M32


def _jump_output(step):
    """pcg32_jump_output: the jump to the step's highest set bit."""
    acc = (1, 0)
    for bit in range(step.bit_length()):
        if step >> bit & 1:
            acc = _then(acc, TABLE[bit])
    return _output(_apply(acc, pj.PCG32_STATE0))


def per_corner_keys(pg):
    """rng_hash corner by corner: the XORed step, wrapping uint32 coordinates."""
    d, w = len(pg), 64 // len(pg)
    keys = []
    for c in range(2**d):
        step = 0
        for i, p in enumerate(pg):
            step ^= ((p + (c >> i & 1)) & M32) << (i * w)
        keys.append(_jump_output(step & M64))
    return keys


def fields_apart(pg):
    """The condition the kernels check on each (sample, Rng level)."""
    d, w = len(pg), 64 // len(pg)
    return all(p != M32 for p in pg) and (w >= 32 or all(p + 1 < 2**w for p in pg[:-1]))


def decomposed_keys(pg):
    """The field-decomposed jump, whether or not the fields stay apart."""
    d, w = len(pg), 64 // len(pg)
    lower = [(1, 0)] * d
    for k in range(reduce(or_, pg).bit_length()):  # one loop for every field
        for i, p in enumerate(pg):
            if i * w + k < 64 and p >> k & 1:  # bits past 63: the period
                lower[i] = _then(lower[i], TABLE[i * w + k])
    states = [pj.PCG32_STATE0]
    for i in range(d):
        upper = _then(lower[i], TABLE[i * w])
        states = [_apply(lower[i], s) for s in states] + [_apply(upper, s) for s in states]
    return [_output(s) for s in states]


def rng_corners(pg):
    """The 2^d keys as the kernels compute them: (keys, whether the fields
    stayed apart)."""
    if fields_apart(pg):
        return decomposed_keys(pg), True
    return per_corner_keys(pg), False


def _cells(d, n, seed):
    """Random cells (all bit widths) and the edge coordinates in every dim."""
    rng = np.random.default_rng(seed)
    w = 64 // d
    widths = rng.integers(0, 33, (n, d))
    cells = [[int(v) for v in rng.integers(0, 2**32, d, dtype=np.uint64) >> (32 - widths[j]).astype(np.uint64)]
             for j in range(n)]
    edges = [0, 1, 2**32 - 2, M32] + ([2**w - 2, 2**w - 1, 2**w] if w < 32 else [])
    for k, e in enumerate(edges):
        for i in range(d):
            base = cells[k % n][:]
            base[i] = e
            cells.append(base)
        cells.append([e] * d)
    return cells


def _reference_keys(cells):
    """The JAX package's and the port's plain hash of every corner."""
    d = len(cells[0])
    bits = np.asarray([[(c >> i) & 1 for i in range(d)] for c in range(2**d)], np.uint64)
    corners = ((np.asarray(cells, np.uint64)[:, None, :] + bits[None]) & np.uint64(M32)).astype(np.uint32)
    want = np.asarray(_grid_hash(jnp.asarray(corners), HashType.Rng)).astype(np.int64)
    port = pj.rng_hash(torch.from_numpy(corners.astype(np.int64))).numpy()
    np.testing.assert_array_equal(port, want)
    return want


@pytest.mark.parametrize("d", [1, 2, 3, 4, 5])
def test_field_decomposed_jump_matches_the_hash(d):
    cells = _cells(d, 300, seed=d)
    want = _reference_keys(cells)
    took = []
    for cell, w in zip(cells, want):
        keys, apart = rng_corners(cell)
        assert keys == w.tolist(), f"cell {cell}"
        took.append(apart)
    assert any(took) and not all(took)  # both paths ran
    # The condition is needed: the decomposition alone misses where fields
    # run into each other or a coordinate wraps.
    assert any(decomposed_keys(c) != w.tolist() for c, w, a in zip(cells, want, took) if not a)


@pytest.mark.parametrize("d,p", [(1, [M32 - 1]), (2, [M32 - 1, M32 - 1]), (3, [2**21 - 2, 2**21 - 2, M32 - 1]),
                                 (2, [M32, 5]), (3, [2**21 - 1, 0, 0]), (3, [0, 0, M32])])
def test_the_condition_at_its_edges(d, p):
    apart = fields_apart(p)
    assert apart == (M32 not in p and not (d == 3 and p[0] == 2**21 - 1))
    keys, _ = rng_corners(p)
    assert keys == per_corner_keys(p) == _reference_keys([p])[0].tolist()


@pytest.mark.parametrize("d", [2, 3])
def test_every_point_of_the_unit_cube_keeps_its_fields_apart(d):
    """At the flagship encoding with "hash": "Rng" (5 Rng levels in 2D),
    every point in [0, 1]^d takes the field-decomposed jump: the grid
    position grows with x, and at x = 1 it meets the condition."""
    from __graft_entry__ import FLAGSHIP_CONFIG

    enc = create_encoding(d, dict(FLAGSHIP_CONFIG["encoding"], hash="Rng"), alignment=16)
    lt = enc.level_table()
    rows = [row for row in lt.view(np.uint32).astype(np.int64) if int(row[2]) == ge.MODE_RNG]
    if d == 2:
        assert len(rows) == 5
    corners = torch.tensor([[0.0] * d, [1.0] * d])
    for row in rows:
        pos_grid, _ = ge._level_cell(corners, row, ge.INTERP_LINEAR)
        lo, hi = (v.tolist() for v in pos_grid & M32)
        assert lo == [0] * d and fields_apart(hi), (row[3], hi)
