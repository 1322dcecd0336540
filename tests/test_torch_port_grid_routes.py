"""The table gradient's choice of kernel instantiation
(``ops.grid_encode._backward_route``), on the CPU: for every combination of
Rng levels, uint32 positions (fixed_point_pos), stochastic interpolation's
uniforms and d = 1..MAX_DIMS, the library and C entry point, against the
table below written out by hand; and every entry point it names is defined
in its library's source.
"""

import itertools
import re

import pytest

from tcnn_tpu_torch.ops import _build, grid_encode


def _expected(rng, fixed, sampled, d):
    if d in (2, 3) and (rng, fixed, sampled) == (True, False, False):
        return "grid_bwd_rng", "tcnn_grid_backward_rng"
    if d in (2, 3) and (rng, fixed, sampled) == (False, True, False):
        return "grid_bwd_modes", "tcnn_grid_backward_fixed"
    if d in (2, 3) and (rng, fixed, sampled) == (False, False, True):
        return "grid_bwd_modes", "tcnn_grid_backward_sampled"
    return "grid_bwd", "tcnn_grid_backward"


@pytest.mark.parametrize("rng,fixed,sampled", list(itertools.product([False, True], repeat=3)))
def test_backward_route(rng, fixed, sampled):
    for d in range(1, grid_encode.MAX_DIMS + 1):
        assert grid_encode._backward_route(rng, fixed, sampled, d) == _expected(rng, fixed, sampled, d), d
    # The kExtras instantiation keeps d = 1 and d >= 4 with any extra, and
    # uint32 positions or uniforms with an Rng level, or both together.
    if (rng and (fixed or sampled)) or (fixed and sampled):
        assert all(grid_encode._backward_route(rng, fixed, sampled, d)[0] == "grid_bwd" for d in (2, 3))


def test_routed_entry_points_exist():
    routes = {grid_encode._backward_route(*c, d) for c in itertools.product([False, True], repeat=3)
              for d in range(1, grid_encode.MAX_DIMS + 1)}
    assert {lib for lib, _ in routes} == {"grid_bwd", "grid_bwd_rng", "grid_bwd_modes"}
    for lib, symbol in routes:
        text = (_build.CSRC / f"{lib}.cu").read_text()
        assert re.search(rf'extern "C" int {symbol}\(', text), (lib, symbol)
