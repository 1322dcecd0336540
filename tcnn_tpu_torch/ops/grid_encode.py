"""Multiresolution grid lookup and its derivatives: the CUDA kernels'
wrappers, their plain versions and the autograd Functions that bind them.

The lookup kernel (``csrc/grid_fwd.cu``) covers every level in one launch:
a block owns 32 consecutive samples, a warp takes one level of them at a
time, with 32-bit index arithmetic and no division; the earlier kernel (one
thread per (sample, level)) stays as ``grid_encode_v1``, for timing and the
bitwise check only. Its plain version ``grid_encode_plain`` is a vectorised
torch lookup level by level. The table-gradient kernel
(``csrc/grid_bwd.cu:tcnn_grid_backward``) recomputes each (sample, level)'s
corners the same way and adds the rounded contributions into the table
gradient, level-major, as the host's ``backward_plan`` lays it out: small
levels in shared-memory copies, equal rows of neighbouring samples summed in
the warp first, one vector atomic a row; its plain version is
``grid_backward_plain``. The input gradient (``tcnn_grid_backward_input``,
plain ``grid_backward_input_plain``) and the double backward
(``tcnn_grid_backward_backward``, plain ``grid_backward_backward_plain``;
both in ``csrc/grid_input_grad.cu``) replace what the JAX package gets from XLA
autodiff of ``GridEncoding.apply`` (tcnn_tpu/encodings/grid.py:1354): they
differentiate the corner weights with respect to x, exactly in every term
(``jax.grad`` of ``jax.grad``). Both run level-major like the lookup (a
block owns 32 samples, a warp one level of them) and sum d/dx and
d/d(dL_dy) in one fixed order without atomics, so two calls give the same
bits; G2 adds its table gradient as the table-gradient kernel does (equal
rows of neighbouring samples merged in the warp, one vector atomic a
row). The third order (G3: ``tcnn_grid_backward3`` in
``csrc/grid_third_order.cu``, plain ``grid_third_order_plain``) is the
gradient of G2, with the same layout, its table-shaped outputs scattered in
the level's class; the fourth order and beyond are autograd of the plain G3
(``GridEncodeThirdOrderFunction``), as the JAX package takes every order
from XLA autodiff. All of them read the
same description of the grid: the (n_levels, 32) int32 level table built
by ``level_table``; the table-gradient scatters also read the per-level
gradient rounding classes (``ops.scatter_rows`` codes).

Index arithmetic is uint32 with wrap-around, as in the JAX package
(``tcnn_tpu/encodings/grid.py:_grid_hash`` and the affine corner fold).
torch has no uint32 add/shift/remainder on the CPU, so the plain version
holds uint32 values in int64 and masks to 32 bits after every add; its
products are split so they never overflow int64 (``_mul32``). The
``"Rng"`` hash runs its 64-bit PCG32 jump on (hi, lo) halves the same way
(``ops.pcg32_jump``); ``fixed_point_pos`` positions are uint32 (held in
int64 by the plain versions), and their cell comes from the level table's
fixed-point columns. The lookup and the table gradient take both; the
table gradient also takes stochastic interpolation's uniforms ``u``, and
its transpose, the gather of one sampled corner a (sample, level), is
``grid_encode_sampled`` (``csrc/grid_bwd_modes.cu``).

The windowed lookup and table gradient (``csrc/grid_sharded.cu``:
``grid_encode_windowed``, ``grid_backward_windowed``) serve a table whose
every level is row-sharded over the ranks of a model-parallel group
(``parallel.table_parallel``): a rank holds the level-local rows [first,
first + rows) of each level, its *window*, at the level table's offset;
corners outside it read zeros and take no gradient. Their plain versions
are ``grid_encode_plain`` and ``grid_backward_plain`` given ``window``, the
(n_levels, 2) int32 windows; so are those of the windowed input gradient,
double backward and third order (``grid_backward_input_windowed``,
``grid_backward_backward_windowed``, ``grid_backward3_windowed``: a rank's
partials).

Every wrapper dispatches on the device of ``x``: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

# Launches of the CUDA kernels (each incremented once per launch of its
# wrapper's kernel, nowhere else): the lookup, the table gradient, the input
# gradient (G1), the double backward (G2) and the earlier lookup kept for
# the A/B (``grid_encode_v1``).
LAUNCHES = 0
V1_LAUNCHES = 0
BWD_LAUNCHES = 0
# The table gradient's launches by route, (library, symbol) as
# _backward_route gives it: which instantiation each launch took.
BWD_ROUTE_LAUNCHES: Dict[Tuple[str, str], int] = {}
INPUT_LAUNCHES = 0
BWDBWD_LAUNCHES = 0
# The third order's (G3) launches, whole-table and windowed.
THIRD_LAUNCHES = 0
WINDOWED_THIRD_LAUNCHES = 0
# The windowed lookup's launches (its table gradient counts under its route
# in BWD_ROUTE_LAUNCHES), and those of the windowed G1 and G2.
WINDOWED_LAUNCHES = 0
WINDOWED_INPUT_LAUNCHES = 0
WINDOWED_BWDBWD_LAUNCHES = 0
# The sampled-corner gather's launches (grid_encode_sampled).
SAMPLED_LAUNCHES = 0
WINDOWED_BWD_ROUTE = ("grid_sharded", "tcnn_grid_backward_windowed")

# Level index modes (csrc/grid_fwd.cu switches on the same values).
MODE_FOLD = 0  # affine: (sum_d uint32(pos_grid_d + bit_d) * stride_d) mod size
MODE_QUAD = 1  # affine: (base mod size + corner delta mod size) mod size
MODE_XOR = 2  # Prime / CoherentPrime / ReversedPrime hash
MODE_BASECONVERT = 3
MODE_RNG = 4  # pcg32(1337) jumped by the packed corner coordinates (ops.pcg32_jump)

INTERP_NEAREST = 0
INTERP_LINEAR = 1
INTERP_SMOOTHSTEP = 2

ROUND_NONE = 0
ROUND_FP16 = 1
ROUND_BF16 = 2
_ROUND_DTYPES = {ROUND_FP16: torch.float16, ROUND_BF16: torch.bfloat16}

MAX_DIMS = 10
MAX_FEATURES = 8
MAX_LEVELS = 128  # csrc/grid_fwd.cu, grid_bwd.cu kMaxLevels (common.MAX_N_LEVELS)
_SERVE_COL = 4 + 2 * MAX_DIMS
_OWN_COL = _SERVE_COL + 1
_MAGIC_COL = _OWN_COL + 1
_SHIFT_COL = _MAGIC_COL + 1
# fixed_point_pos: the cell width in uint32 units, half of it, int(scale)
# and the fp32 factor scale / (2^32 - 1) (reference: grid.h:1143-1151).
_CELL_COL = _SHIFT_COL + 1
_HALF_COL = _CELL_COL + 1
_INT_SCALE_COL = _HALF_COL + 1
_FACTOR_COL = _INT_SCALE_COL + 1
_LEVEL_COLS = _FACTOR_COL + 1
_M32 = 0xFFFFFFFF
_BASE_CONVERT_FACTOR = 2531011


def level_table(
    offsets: Sequence[int],
    sizes: Sequence[int],
    modes: Sequence[int],
    scales: Sequence[float],
    strides: Sequence[Sequence[int]],
    serve_rounds: Optional[Sequence[int]] = None,
    own_rounds: Optional[Sequence[int]] = None,
    fixed_point: bool = False,
) -> np.ndarray:
    """The (n_levels, 32) int32 level table: per level the row offset, the
    row count, the index mode, the fp32 scale (bit pattern), the per-dim
    factors masked to 32 bits, the per-dim factors mod the level size, the
    serve-time rounding of the level's reads, the rounding of its reads
    to the encoding's own table dtype (ROUND_* codes; reads round by the
    own code first; ROUND_NONE where the sequence is None), the
    reciprocal of the level size (``mod_reciprocal``) and, with
    ``fixed_point``, the cell of uint32 positions (``fixed_point_cell``;
    zeros without). ``strides[l]`` are the exact (unmasked) per-dim factors
    of level l; ``scales`` the exact (float64) scales."""
    n = len(offsets)
    t = np.zeros((n, _LEVEL_COLS), np.uint32)
    for lvl in range(n):
        size = int(sizes[lvl])
        st = [int(s) for s in strides[lvl]]
        if len(st) > MAX_DIMS:
            raise ValueError(f"grid levels take at most {MAX_DIMS} dims")
        t[lvl, 0] = int(offsets[lvl])
        t[lvl, 1] = size
        t[lvl, 2] = int(modes[lvl])
        t[lvl, 3] = np.float32(scales[lvl]).view(np.uint32)
        t[lvl, 4 : 4 + len(st)] = [s & _M32 for s in st]
        t[lvl, 4 + MAX_DIMS : 4 + MAX_DIMS + len(st)] = [s % size for s in st]
        t[lvl, _SERVE_COL] = ROUND_NONE if serve_rounds is None else int(serve_rounds[lvl])
        t[lvl, _OWN_COL] = ROUND_NONE if own_rounds is None else int(own_rounds[lvl])
        t[lvl, _MAGIC_COL], t[lvl, _SHIFT_COL] = mod_reciprocal(size)
        if fixed_point:
            cell, factor = fixed_point_cell(float(scales[lvl]))
            t[lvl, _CELL_COL : _FACTOR_COL] = [cell, cell // 2, int(scales[lvl])]
            t[lvl, _FACTOR_COL] = factor.view(np.uint32)
    return t.view(np.int32)


def fixed_point_cell(scale: float) -> Tuple[int, np.float32]:
    """A level's cell in uint32 fixed point (positions spanning [0, 1) as
    0 .. 2^32 - 1): its width max(int((2^32 - 1) / scale), 1) and the fp32
    factor scale / (2^32 - 1) that turns a position within the cell into
    the interpolation fraction (tcnn_tpu/encodings/grid.py:1580-1592;
    reference: grid.h:1143-1151)."""
    cell = max(int(float(_M32) / scale), 1)
    if cell > _M32 or not 0 <= int(scale) <= _M32:
        raise ValueError(f"fixed_point_pos: a level of scale {scale} has no uint32 cell")
    return cell, np.float32(scale / float(_M32))


def mod_reciprocal(size: int) -> Tuple[int, int]:
    """(magic, shift) with which the kernels reduce a uint32 mod ``size``
    (csrc/grid_common.cuh:reduce): (0, 0) for a power of two, which they
    mask; else shift = floor(log2 size) and magic = floor(2^(33 + shift) /
    size) + 1 - 2^32, in [1, 2^32)."""
    size = int(size)
    if size < 1 or size >= 2**32:
        raise ValueError(f"a level holds 1 to 2^32 - 1 rows, not {size}")
    if size & (size - 1) == 0:
        return 0, 0
    shift = size.bit_length() - 1
    return 2 ** (33 + shift) // size + 1 - 2**32, shift


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2^32 for int64 ``a`` in [0, 2^32) and ``b`` in [0, 2^32),
    without overflowing int64: b is split into 16-bit halves."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _level_cell(x: torch.Tensor, row: np.ndarray, interpolation: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One level's cell for every sample: (grid position (B, d) int64,
    interpolation weights w (B, d) fp32, smoothstepped under Smoothstep).
    ``x`` fp32, or int64 holding the uint32 positions of fixed_point_pos."""
    if x.dtype == torch.int64:
        cell, half, int_scale = (int(v) for v in row[_CELL_COL:_FACTOR_COL])
        factor = float(np.int64(row[_FACTOR_COL]).astype(np.uint32).view(np.float32))
        pos = (x + half) & _M32
        pos_grid = pos // cell + torch.where(pos < half, int_scale, 0)
        # The remainder rounds once to fp32; the product is an fp32 one.
        t = ((pos - pos_grid * cell) & _M32).to(torch.float32) * factor
    else:
        scale = float(np.int64(row[3]).astype(np.uint32).view(np.float32))
        # x * scale is exact in double and rounds once to fp32: the same
        # value as the fp32 product; the +0.5 is a separate fp32 add.
        pos = x * scale + 0.5
        pos_floor = torch.floor(pos)
        pos_grid = pos_floor.to(torch.int32).to(torch.int64)
        t = pos - pos_floor
    if interpolation == INTERP_SMOOTHSTEP:
        t = t * t * (3.0 - 2.0 * t)
    return pos_grid, t


def _level_rows(
    x: torch.Tensor, row: np.ndarray, interpolation: int, bits_np: np.ndarray
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One level's corners for every sample: (table row (B, C) int64,
    weight (B, C) fp32), from the level's row of the level table."""
    return _level_corners(x, row, interpolation, bits_np)[:2]


def _level_corners(
    x: torch.Tensor, row: np.ndarray, interpolation: int, bits_np: np.ndarray
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``_level_rows`` and the per-dim weights w (B, d) fp32."""
    batch, d = x.shape
    dev = x.device
    offset, size, mode = int(row[0]), int(row[1]), int(row[2])
    s32 = [int(v) for v in row[4 : 4 + d]]
    smod = [int(v) for v in row[4 + MAX_DIMS : 4 + MAX_DIMS + d]]
    bits = torch.from_numpy(bits_np).to(dev)  # (C, d)
    pos_grid, t = _level_cell(x, row, interpolation)
    corner = (pos_grid[:, None, :] + bits[None]) & _M32  # (B, C, d) uint32 values
    if interpolation == INTERP_NEAREST:
        weights = torch.ones((batch, 1), dtype=torch.float32, device=dev)
    else:
        wt = torch.where(bits[None].bool(), t[:, None, :], 1.0 - t[:, None, :])
        weights = torch.prod(wt, dim=-1)  # (B, C)
    if mode == MODE_QUAD:
        base = torch.zeros((batch,), dtype=torch.int64, device=dev)
        for k in range(d):
            base = (base + _mul32(pos_grid[:, k] & _M32, s32[k])) & _M32
        delta = torch.from_numpy((bits_np @ np.asarray(smod, np.int64)) % size).to(dev)
        idx = (base[:, None] % size + delta[None]) % size
    elif mode == MODE_RNG:
        from .pcg32_jump import rng_hash

        idx = rng_hash(corner) % size
    else:
        h = torch.zeros(corner.shape[:-1], dtype=torch.int64, device=dev)
        for k in range(d):
            if mode == MODE_FOLD:
                h = (h + _mul32(corner[..., k], s32[k])) & _M32
            elif mode == MODE_XOR:
                h = h ^ _mul32(corner[..., k], s32[k])
            else:  # MODE_BASECONVERT
                h = _mul32((h + corner[..., k]) & _M32, _BASE_CONVERT_FACTOR)
        idx = h % size
    return idx + offset, weights, t


def _positions(x: torch.Tensor) -> torch.Tensor:
    """The positions as the plain versions read them: fp32, or the uint32
    positions of fixed_point_pos held in int64."""
    return x.to(torch.int64) if x.dtype == torch.uint32 else x


def _sampled_corner(t: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Stochastic interpolation's corner of each sample on one level: bit k
    set where u < w_k (the weight of the upper neighbour in dim k;
    reference: grid.h:284-299), as a (B, 1) index into the corners."""
    bits = (u[:, None] < t).to(torch.int64)  # (B, d)
    return torch.sum(bits << torch.arange(t.shape[1], device=t.device), dim=1, keepdim=True)


def _corner_bits(d: int, interpolation: int) -> np.ndarray:
    n_corners = 1 if interpolation == INTERP_NEAREST else 2**d
    return np.asarray([[(c >> k) & 1 for k in range(d)] for c in range(n_corners)], np.int64)


def _weight_factors(
    x: torch.Tensor, row: np.ndarray, interpolation: int, bits_np: np.ndarray
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Per corner and dim on one level (Linear or Smoothstep), the factor
    f_ck of the corner's weight and its signed first, second and third
    derivatives in x_k, each (B, C, d). The weight of corner c is prod_k
    f_ck with f_ck = w_k (bit k of c set) or 1 - w_k, w_k = s(t_k), t_k =
    pos_k - floor(pos_k) and pos = x * scale + 0.5; so the n-th derivative
    of f_ck is +-scale^n s^(n)(t_k), with s the identity (Linear: s' = 1,
    s'' = s''' = 0) or t^2 (3 - 2t) (Smoothstep: s' = 6t(1 - t), s'' = 6 -
    12t, s''' = -12); floor contributes nothing."""
    scale = float(np.int64(row[3]).astype(np.uint32).view(np.float32))
    pos = x * scale + 0.5
    t = pos - torch.floor(pos)
    if interpolation == INTERP_SMOOTHSTEP:
        w = t * t * (3.0 - 2.0 * t)
        s1, s2, s3 = 6.0 * t * (1.0 - t), 6.0 - 12.0 * t, torch.full_like(t, -12.0)
    else:
        w, s1, s2, s3 = t, torch.ones_like(t), torch.zeros_like(t), torch.zeros_like(t)
    bits = torch.from_numpy(bits_np).to(x.device).bool()[None]  # (1, C, d)
    sign = torch.where(bits, 1.0, -1.0)
    f = torch.where(bits, w[:, None, :], 1.0 - w[:, None, :])
    d1 = sign * (s1 * scale)[:, None, :]
    d2 = sign * (s2 * scale * scale)[:, None, :]
    d3 = sign * (s3 * scale * scale * scale)[:, None, :]
    return f, (d1, d2, d3)


def _replaced_product(f: torch.Tensor, ds, dims: Tuple[int, ...]) -> torch.Tensor:
    """The product of a corner's factors f_k, each dim k that ``dims``
    names n times replaced by its n-th signed derivative ``ds[n - 1]``: a
    derivative of the weight in the dims ``dims``. In dimension order from
    1.0, as the kernels multiply (csrc/grid_common.cuh:replaced_product):
    the table gradient's stochastic rounding reads the exact bits."""
    p = torch.ones_like(f[..., 0])
    for k in range(f.shape[-1]):
        n = dims.count(k)
        p = p * (f[..., k] if n == 0 else ds[n - 1][..., k])
    return p


def _weight_derivatives(
    x: torch.Tensor, row: np.ndarray, interpolation: int, bits_np: np.ndarray, second: bool
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Per corner, the derivatives of its weight with respect to x on one
    level: the gradient (B, C, d) and, with ``second``, the Hessian (B, C,
    d, d), else None (``_weight_factors``; the Nearest weight is constant).
    A derivative replaces its dimension's factor in the product
    (``_replaced_product``)."""
    batch, d = x.shape
    n_c = bits_np.shape[0]
    if interpolation == INTERP_NEAREST:
        return x.new_zeros((batch, n_c, d)), (x.new_zeros((batch, n_c, d, d)) if second else None)
    f, ds = _weight_factors(x, row, interpolation, bits_np)
    grad = torch.stack([_replaced_product(f, ds, (e,)) for e in range(d)], dim=-1)
    if not second:
        return grad, None
    hess = x.new_empty((batch, n_c, d, d))
    for a in range(d):
        for b in range(d):
            hess[:, :, a, b] = _replaced_product(f, ds, (a, b))
    return grad, hess


def _rounded(feats: torch.Tensor, codes: Tuple[int, ...]) -> torch.Tensor:
    for code in codes:
        feats = feats.to(_ROUND_DTYPES[code]).to(torch.float32)
    return feats


class _RoundedRead(torch.autograd.Function):
    """``_rounded`` with the identity for its gradient: a rounding of reads
    enters no derivative of the table, as in the JAX package's linear pairs
    (its table gradient scatters the unrounded cotangent;
    tcnn_tpu/encodings/grid.py:_forward_dtype)."""

    @staticmethod
    def forward(ctx, feats, codes):
        return _rounded(feats, codes)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _read_table(table: torch.Tensor, idx: torch.Tensor, row: np.ndarray) -> torch.Tensor:
    """Table rows at ``idx`` as the lookup reads them on the level whose
    level-table row is ``row``: fp32, rounded to the encoding's own table
    dtype, then to the serve-time dtype, each where the row names one;
    straight through for a gradient (``_RoundedRead``)."""
    feats = table[idx]
    codes = tuple(c for c in (int(row[_OWN_COL]), int(row[_SERVE_COL])) if c != ROUND_NONE)
    if not codes:
        return feats
    return _RoundedRead.apply(feats, codes) if feats.requires_grad else _rounded(feats, codes)


def _windows_np(window) -> Optional[np.ndarray]:
    return None if window is None else np.asarray(window.cpu() if isinstance(window, torch.Tensor) else window,
                                                  np.int64).reshape(-1, 2)


def _in_window(idx: torch.Tensor, row: np.ndarray, win) -> Tuple[torch.Tensor, torch.Tensor]:
    """The table rows ``idx`` (offset + level-local row r) of one level as
    a rank whose window of the level is ``win`` = (first, rows) holds them:
    (local table row offset + r - first, clamped into the window, and
    whether the rank holds it)."""
    first, rows = int(win[0]), int(win[1])
    offset = int(row[0])
    loc = idx - offset - first
    owned = (loc >= 0) & (loc < rows)
    return offset + torch.clamp(loc, 0, max(rows - 1, 0)), owned


def grid_encode_plain(
    x: torch.Tensor,
    params: torch.Tensor,
    levels: torch.Tensor,
    n_features_per_level: int,
    padded_width: int,
    interpolation: int,
    out_dtype: torch.dtype,
    window=None,
) -> torch.Tensor:
    """Plain torch lookup. ``x`` (B, d) fp32 (uint32 for fixed_point_pos),
    ``params`` the flat fp32 grid parameters, ``levels`` the level table
    (any device). Returns (B, padded_width) in ``out_dtype``. ``window``:
    the (n_levels, 2) windows of a rank of a row-sharded table (``params``
    then its local rows): a corner outside the level's window reads zeros
    (the plain version of ``grid_encode_windowed``)."""
    batch, d = x.shape
    x = _positions(x)
    F = int(n_features_per_level)
    table = params.view(-1, F)
    lt = levels.cpu().numpy().view(np.uint32).astype(np.int64)
    windows = _windows_np(window)
    bits_np = _corner_bits(d, interpolation)
    outs = []
    for lvl, row in enumerate(lt):
        idx, weights = _level_rows(x, row, interpolation, bits_np)
        if windows is None:
            feats = _read_table(table, idx, row)  # (B, C, F)
        else:
            idx, owned = _in_window(idx, row, windows[lvl])
            feats = torch.where(owned[..., None], _read_table(table, idx, row), 0.0)
        outs.append(torch.sum(feats * weights[..., None], dim=1))
    y = torch.stack(outs, dim=1).reshape(batch, -1)
    if padded_width > y.shape[1]:
        y = torch.cat([y, y.new_zeros((batch, padded_width - y.shape[1]))], dim=1)
    return y.to(out_dtype)


def _table_rows(lt: np.ndarray) -> int:
    return int(max(int(r[0]) + int(r[1]) for r in lt)) if len(lt) else 0


def grid_backward_plain(
    x: torch.Tensor,
    dL_dy: torch.Tensor,
    levels: torch.Tensor,
    n_features_per_level: int,
    interpolation: int,
    level_round: torch.Tensor,
    u: Optional[torch.Tensor] = None,
    window=None,
) -> torch.Tensor:
    """Plain table gradient: (n_rows * F,) fp32 for the flat grid
    parameters, where n_rows is the table size the level table describes.
    Per level, the contributions w_c * dL_dy[:, lvl*F:(lvl+1)*F] (fp32) are
    rounded by the level's class in ``level_round`` ((L, 2): contribution
    rounding, accumulation; ``ops.scatter_rows`` codes) and added with
    ``scatter_rows_plain``. A ``table_dtype`` rounding on read does not enter
    the backward (straight-through, as the JAX package's linear pair).

    ``u`` (B, L) fp32 uniforms: stochastic interpolation's table gradient
    (tcnn_tpu/encodings/grid.py:_stochastic_combine): per (sample, level)
    the whole dL_dy row, weight 1, to the one corner ``_sampled_corner``
    picks.

    ``window``: the (n_levels, 2) windows of a rank of a row-sharded table
    (the plain version of ``grid_backward_windowed``): the gradient of its
    local rows, (sum of the windows' rows * F,), from the contributions of
    the corners inside each level's window."""
    from .scatter_rows import ACC_BF16, ACC_DROP, scatter_rows_plain

    batch, d = x.shape
    x = _positions(x)
    F = int(n_features_per_level)
    lt = levels.cpu().numpy().view(np.uint32).astype(np.int64)
    windows = _windows_np(window)
    # The gradient's rows of each level: the level's, or the window's.
    sizes = lt[:, 1] if windows is None else windows[:, 1]
    classes = level_round.cpu().numpy().reshape(-1, 2)
    bits_np = _corner_bits(d, interpolation)
    n_rows = int(max(lt[:, 0] + sizes)) if len(lt) else 0
    grad = torch.zeros((n_rows, F), dtype=torch.float32, device=x.device)
    g = dL_dy.to(torch.float32)
    for lvl, row in enumerate(lt):
        contrib_round, acc = (int(v) for v in classes[lvl])
        if acc == ACC_DROP:
            continue
        offset, size = int(row[0]), int(sizes[lvl])
        idx, weights, t = _level_corners(x, row, interpolation, bits_np)
        if windows is not None:
            idx, owned = _in_window(idx, row, windows[lvl])
            weights = torch.where(owned, weights, 0.0)
        gl = g[:, None, lvl * F : (lvl + 1) * F]
        if u is None:
            contrib = weights[..., None] * gl  # (B, C, F)
        else:
            idx, contrib = torch.gather(idx, 1, _sampled_corner(t, u[:, lvl])), gl
        acc_dtype = torch.bfloat16 if acc == ACC_BF16 else torch.float32
        grad[offset : offset + size] += scatter_rows_plain(
            (idx - offset).reshape(-1), contrib.reshape(-1, F), size, contrib_round, acc_dtype
        )
    return grad.reshape(-1)


def contribution_magnitudes(
    x: torch.Tensor,
    dL_dy: torch.Tensor,
    levels: torch.Tensor,
    n_features_per_level: int,
    interpolation: int,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per entry of the table gradient, the sum of |w_c * dL_dy| over the
    contributions it takes (fp32, flat): the scale against which a kernel's
    sums in another order are held. Not the table gradient of |dL_dy|:
    fixed_point_pos cells give weights outside [0, 1] (a fraction above 1
    where int(scale) cells do not fill the uint32 range), so w_c may be
    negative."""
    batch, d = x.shape
    x = _positions(x)
    F = int(n_features_per_level)
    lt = levels.cpu().numpy().view(np.uint32).astype(np.int64)
    bits_np = _corner_bits(d, interpolation)
    out = torch.zeros((_table_rows(lt), F), dtype=torch.float32, device=x.device)
    g = dL_dy.to(torch.float32).abs()
    for lvl, row in enumerate(lt):
        idx, weights, t = _level_corners(x, row, interpolation, bits_np)
        gl = g[:, None, lvl * F : (lvl + 1) * F]
        if u is None:
            contrib = weights.abs()[..., None] * gl
        else:
            idx, contrib = torch.gather(idx, 1, _sampled_corner(t, u[:, lvl])), gl
        out.index_add_(0, idx.reshape(-1), contrib.reshape(-1, F))
    return out.reshape(-1)


def _held_rows(table: torch.Tensor, idx: torch.Tensor, row: np.ndarray, win) -> torch.Tensor:
    """``_read_table(table, idx, row)``; with ``win`` (a level's window of a
    rank of a row-sharded table, ``table`` its local rows) the rows the
    rank holds, zeros for the others."""
    if win is None:
        return _read_table(table, idx, row)
    idx, owned = _in_window(idx, row, win)
    return torch.where(owned[..., None], _read_table(table, idx, row), 0.0)


def grid_backward_input_plain(
    x: torch.Tensor,
    dL_dy: torch.Tensor,
    params: torch.Tensor,
    levels: torch.Tensor,
    n_features_per_level: int,
    interpolation: int,
    window=None,
) -> torch.Tensor:
    """Plain input gradient (B, d) fp32: dL/dx_e = sum over levels and
    corners of d w_c / d x_e * <dL_dy[:, level features], T[idx_c]>, the
    table read as the lookup reads it (the level table's roundings).
    ``window``: the (n_levels, 2) windows of a rank of a row-sharded table
    (``params`` its local rows): the rank's partial, from the corners it
    holds (the plain version of ``grid_backward_input_windowed``)."""
    batch, d = x.shape
    F = int(n_features_per_level)
    table = params.view(-1, F)
    lt = levels.cpu().numpy().view(np.uint32).astype(np.int64)
    windows = _windows_np(window)
    bits_np = _corner_bits(d, interpolation)
    g = dL_dy.to(torch.float32)
    dx = torch.zeros((batch, d), dtype=torch.float32, device=x.device)
    for lvl, row in enumerate(lt):
        idx, _ = _level_rows(x, row, interpolation, bits_np)
        dw, _ = _weight_derivatives(x, row, interpolation, bits_np, second=False)
        feats = _held_rows(table, idx, row, None if windows is None else windows[lvl])
        dots = torch.sum(feats * g[:, None, lvl * F : (lvl + 1) * F], dim=-1)
        dx += torch.sum(dw * dots[..., None], dim=1)
    return dx


def grid_backward_backward_plain(
    x: torch.Tensor,
    dL_dy: torch.Tensor,
    params: torch.Tensor,
    levels: torch.Tensor,
    n_features_per_level: int,
    interpolation: int,
    level_round: Optional[torch.Tensor],
    cgp: Optional[torch.Tensor],
    cgx: Optional[torch.Tensor],
    window=None,
) -> Tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor]:
    """Plain double backward. For the cotangents ``cgp`` (of the table
    gradient, flat like ``params``) and ``cgx`` (of the input gradient, (B,
    d)) of the first backward (dparams, dx) of the lookup, either of them
    None for zero, returns the gradients of <cgp, dparams> + <cgx, dx>:

    - d/dparams (flat fp32; None when ``level_round`` or ``cgx`` is None,
      for zero): per corner
      a_c * dL_dy, a_c = sum_e cgx_e d w_c / d x_e, scattered like the table
      gradient with the level's rounding class;
    - d/dx (B, d) fp32: sum_c d w_c/d x * <dL_dy, cgp[idx_c]> + sum_c (cgx^T
      Hess w_c) <dL_dy, T[idx_c]>;
    - d/d(dL_dy) (B, width of dL_dy) fp32: sum_c w_c cgp[idx_c] + a_c
      T[idx_c] per level, zero in the padding columns.

    A level whose class drops its table gradient has no cgp term (its
    dparams is 0) and scatters nothing. T and cgp are read as the lookup
    reads its table (the level's rounding): the JAX package's autodiff
    gathers the cotangent of its table gradient through the lookup's own
    gather (the transpose of the transpose of ``gather_rows``'s linear pair,
    tcnn_tpu/ops/scatter_rows.py:545).

    ``window``: the (n_levels, 2) windows of a rank of a row-sharded table
    (``params`` and ``cgp`` its local rows; the plain version of
    ``grid_backward_backward_windowed``): T and cgp read zeros outside the
    windows, d/dparams is the gradient of the local rows (sized as
    ``grid_backward_plain``'s with ``window``) and d/dx and d/d(dL_dy) are
    the rank's partials."""
    from .scatter_rows import ACC_BF16, ACC_DROP, scatter_rows_plain

    batch, d = x.shape
    F = int(n_features_per_level)
    table = params.view(-1, F)
    lt = levels.cpu().numpy().view(np.uint32).astype(np.int64)
    windows = _windows_np(window)
    sizes = lt[:, 1] if windows is None else windows[:, 1]
    classes = None if level_round is None else level_round.cpu().numpy().reshape(-1, 2)
    bits_np = _corner_bits(d, interpolation)
    g = dL_dy.to(torch.float32)
    cot_table = None if cgp is None else cgp.reshape(-1, F)
    d_params = None
    if classes is not None and cgx is not None:
        n_rows = int(max(lt[:, 0] + sizes)) if len(lt) else 0
        d_params = torch.zeros((n_rows, F), dtype=torch.float32, device=x.device)
    d_x = torch.zeros((batch, d), dtype=torch.float32, device=x.device)
    d_dy = torch.zeros((batch, dL_dy.shape[1]), dtype=torch.float32, device=x.device)
    for lvl, row in enumerate(lt):
        contrib_round, acc = (0, 0) if classes is None else (int(v) for v in classes[lvl])
        offset, size = int(row[0]), int(sizes[lvl])
        win = None if windows is None else windows[lvl]
        idx, weights = _level_rows(x, row, interpolation, bits_np)
        dw, hess = _weight_derivatives(x, row, interpolation, bits_np, second=cgx is not None)
        gl = g[:, lvl * F : (lvl + 1) * F]
        feats = _held_rows(table, idx, row, win)  # (B, C, F)
        cols = slice(lvl * F, (lvl + 1) * F)
        if cot_table is not None and acc != ACC_DROP:
            cot = _held_rows(cot_table, idx, row, win)
            d_dy[:, cols] += torch.sum(weights[..., None] * cot, dim=1)
            d_x += torch.sum(dw * torch.sum(cot * gl[:, None, :], dim=-1)[..., None], dim=1)
        if cgx is not None:
            a = torch.zeros_like(weights)  # (B, C): sum_e cgx_e dw_e, in the kernel's order
            for e in range(d):
                a = a + cgx[:, None, e] * dw[..., e]
            d_dy[:, cols] += torch.sum(a[..., None] * feats, dim=1)
            dots = torch.sum(feats * gl[:, None, :], dim=-1)  # (B, C)
            d_x += torch.sum(torch.sum(hess * cgx[:, None, :, None], dim=2) * dots[..., None], dim=1)
            if d_params is not None and acc != ACC_DROP:
                acc_dtype = torch.bfloat16 if acc == ACC_BF16 else torch.float32
                rows, contrib = idx, a[..., None] * gl[:, None, :]
                if win is not None:
                    rows, owned = _in_window(idx, row, win)
                    contrib = torch.where(owned[..., None], contrib, 0.0)
                d_params[offset : offset + size] += scatter_rows_plain(
                    (rows - offset).reshape(-1), contrib.reshape(-1, F), size, contrib_round, acc_dtype,
                )
    return (None if d_params is None else d_params.reshape(-1)), d_x, d_dy


class _ClassScatter(torch.autograd.Function):
    """``scatter_rows_plain`` of the rows ``contrib`` at the level-local
    rows ``rows`` into ``size`` rows, in a level's class, whose gradient is
    the gather of the cotangent at ``rows`` read as the lookup reads its
    table (the level-table row ``row``'s roundings): the JAX package's
    linear pair, whose class scatter and rounded gather are each other's
    transpose at every order (tcnn_tpu/ops/scatter_rows.py:gather_rows).

    ``_ClassScatter.apply(rows, contrib, size, contrib_round, acc_dtype, row)``"""

    @staticmethod
    def forward(ctx, rows, contrib, size, contrib_round, acc_dtype, row):
        from .scatter_rows import scatter_rows_plain

        ctx.save_for_backward(rows)
        ctx.row = row
        return scatter_rows_plain(rows, contrib, size, contrib_round, acc_dtype)

    @staticmethod
    def backward(ctx, g):
        (rows,) = ctx.saved_tensors
        return None, _read_table(g, rows, ctx.row), None, None, None, None


def grid_third_order_plain(
    x: torch.Tensor,
    dL_dy: torch.Tensor,
    params: torch.Tensor,
    levels: torch.Tensor,
    n_features_per_level: int,
    interpolation: int,
    level_round: Optional[torch.Tensor],
    cgp: Optional[torch.Tensor],
    cgx: Optional[torch.Tensor],
    g_params: Optional[torch.Tensor],
    g_x: Optional[torch.Tensor],
    g_dy: Optional[torch.Tensor],
    window=None,
    need: Tuple[bool, ...] = (True,) * 5,
) -> Tuple[Optional[torch.Tensor], ...]:
    """Plain third order (G3): the gradients of <g_params, P> + <g_x, X> +
    <g_dy, Y>, (P, X, Y) the double backward ``grid_backward_backward_plain``
    of the same operands, for its cotangents ``g_params`` (flat like
    ``params``), ``g_x`` ((B, d)) and ``g_dy`` ((B, width of dL_dy)), any of
    them None for zero. Per level l and corner c, with w_c its weight, dw_c
    its gradient, H_c its Hessian and T3_c its third derivatives in x, T_c,
    p_c and q_c the rows of the table, ``cgp`` and ``g_params`` at idx_c
    (each read as the lookup reads its table; p_c and q_c zero on a level
    whose class drops its table gradient), g the level's columns of dL_dy,
    gy those of ``g_dy``, a_c = cgx . dw_c, e_c = g_x . dw_c and h_c = g_x^T
    H_c cgx, it returns (each None where it is zero, or where ``need`` says
    it is not wanted; ``need`` in the order of the results):

    - d/dparams (flat fp32): h_c g + a_c gy scattered at idx_c in the
      level's class, as G2 scatters its table gradient (None without
      ``level_round``);
    - d/dx (B, d) fp32: (H_c cgx) <g, q_c> + (H_c g_x) <g, p_c> + T3_c[g_x,
      cgx] <g, T_c> + dw_c <gy, p_c> + (H_c cgx) <gy, T_c>;
    - d/d(dL_dy) (B, width) fp32: a_c q_c + e_c p_c + h_c T_c, zero in the
      padding columns;
    - d/dcgp (flat fp32): e_c g + w_c gy scattered at idx_c in the level's
      class, nothing on a dropped level;
    - d/dcgx (B, d) fp32: dw_c <g, q_c> + (H_c g_x) <g, T_c> + dw_c <gy,
      T_c>.

    The JAX package's autodiff gives the same: its lookup gathers through a
    linear pair whose transpose is the level's class scatter and back
    (tcnn_tpu/ops/scatter_rows.py:gather_rows), so every cotangent into the
    table or into ``cgp`` is class-scattered and every table-shaped operand
    is read rounded as the table is. The sums run in the kernel's order
    (``csrc/grid_input_grad.cuh:third_order_corner``) and the scatters are
    ``_ClassScatter``, so autograd of this function is the fourth order.

    ``window``: the (n_levels, 2) windows of a rank of a row-sharded table
    (``params``, ``cgp`` and ``g_params`` its local rows, read zeros outside
    the windows): the rank's local d/dparams and d/dcgp and its partials of
    the rest (the plain version of ``grid_backward3_windowed``)."""
    from .scatter_rows import ACC_BF16, ACC_DROP

    batch, d = x.shape
    F = int(n_features_per_level)
    table = params.view(-1, F)
    lt = levels.cpu().numpy().view(np.uint32).astype(np.int64)
    windows = _windows_np(window)
    sizes = lt[:, 1] if windows is None else windows[:, 1]
    classes = None if level_round is None else level_round.cpu().numpy().reshape(-1, 2)
    bits_np = _corner_bits(d, interpolation)
    g = dL_dy.to(torch.float32)
    gy_all = None if g_dy is None else g_dy.to(torch.float32)
    cot_table = None if cgp is None else cgp.reshape(-1, F)
    q_table = None if g_params is None else g_params.reshape(-1, F)
    has_gx, has_gy = g_x is not None, g_dy is not None
    n_rows = int(max(lt[:, 0] + sizes)) if len(lt) else 0

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=x.device)

    want_params, want_cgp, want_cgx = _third_wants(level_round, cgp, cgx, g_params, g_x, g_dy, need)
    d_params = zeros(n_rows, F) if want_params else None
    d_cgp = zeros(n_rows, F) if want_cgp else None
    d_x, d_dy, d_cgx = zeros(batch, d), zeros(batch, dL_dy.shape[1]), zeros(batch, d)
    derivs = interpolation != INTERP_NEAREST
    for lvl, row in enumerate(lt):
        contrib_round, acc = (0, 0) if classes is None else (int(v) for v in classes[lvl])
        offset, size = int(row[0]), int(sizes[lvl])
        win = None if windows is None else windows[lvl]
        idx, weights = _level_rows(x, row, interpolation, bits_np)
        n_c = weights.shape[1]
        gl = g[:, lvl * F : (lvl + 1) * F]
        gyl = None if gy_all is None else gy_all[:, lvl * F : (lvl + 1) * F]
        use_cgp = cot_table is not None and acc != ACC_DROP
        use_q = q_table is not None and acc != ACC_DROP
        # The weight's derivatives contracted as the kernel contracts them:
        # dw (d of (B, C)), H cgx and H g_x (d each), T3[g_x, cgx] (d).
        zero = torch.zeros_like(weights)
        dw, hcx, hgx, r = [zero] * d, [zero] * d, [zero] * d, [zero] * d
        if derivs:
            f, ds = _weight_factors(x, row, interpolation, bits_np)
            weights = _replaced_product(f, ds, ())  # in the kernel's order: the scatters' rounding reads its bits
            dw = [_replaced_product(f, ds, (e,)) for e in range(d)]
            if cgx is not None or has_gx:
                hess = [[_replaced_product(f, ds, (a, b)) for b in range(d)] for a in range(d)]
                if cgx is not None:
                    hcx = [_ordered_sum(cgx[:, None, a] * hess[a][b] for a in range(d)) for b in range(d)]
                if has_gx:
                    hgx = [_ordered_sum(g_x[:, None, a] * hess[a][b] for a in range(d)) for b in range(d)]
            if cgx is not None and has_gx:
                r = [_ordered_sum(g_x[:, None, a] * _ordered_sum(cgx[:, None, b] * _replaced_product(f, ds, (a, b, e))
                                                                 for b in range(d)) for a in range(d))
                     for e in range(d)]
        a_c = zero if cgx is None else _ordered_sum(cgx[:, None, e] * dw[e] for e in range(d))
        e_c = zero if not has_gx else _ordered_sum(g_x[:, None, e] * dw[e] for e in range(d))
        h_c = zero if cgx is None or not has_gx else _ordered_sum(g_x[:, None, e] * hcx[e] for e in range(d))
        feats = _held_rows(table, idx, row, win) if has_gx or has_gy else None  # (B, C, F)
        p = _held_rows(cot_table, idx, row, win) if use_cgp else None
        q = _held_rows(q_table, idx, row, win) if use_q else None

        def dot(rows_, cols):
            return zero if rows_ is None or cols is None else torch.sum(rows_ * cols[:, None, :], dim=-1)

        tg, pg, qg, ty, py = dot(feats, gl), dot(p, gl), dot(q, gl), dot(feats, gyl), dot(p, gyl)
        cols = slice(lvl * F, (lvl + 1) * F)
        terms = [t for t in ((a_c, q), (e_c, p), (h_c, feats)) if t[1] is not None]
        if terms:
            d_dy[:, cols] += torch.sum(sum(c[..., None] * rows_ for c, rows_ in terms), dim=1)
        d_x += torch.stack([torch.sum(hcx[e] * qg + hgx[e] * pg + r[e] * tg + dw[e] * py + hcx[e] * ty, dim=1)
                            for e in range(d)], dim=1)
        d_cgx += torch.stack([torch.sum(dw[e] * qg + hgx[e] * tg + dw[e] * ty, dim=1) for e in range(d)], dim=1)
        if acc == ACC_DROP:
            continue
        acc_dtype = torch.bfloat16 if acc == ACC_BF16 else torch.float32
        rows, owned = (idx, None) if win is None else _in_window(idx, row, win)

        def scatter(out, coef_g, coef_gy):
            contrib = torch.zeros((batch, n_c, F), dtype=torch.float32, device=x.device)
            if coef_g is not None:
                contrib = coef_g[..., None] * gl[:, None, :]
            if gyl is not None:
                contrib = contrib + coef_gy[..., None] * gyl[:, None, :]
            if owned is not None:
                contrib = torch.where(owned[..., None], contrib, 0.0)
            out[offset : offset + size] += _ClassScatter.apply(
                (rows - offset).reshape(-1), contrib.reshape(-1, F), size, contrib_round, acc_dtype, row)

        if d_params is not None:
            scatter(d_params, h_c if has_gx else None, a_c)
        if d_cgp is not None:
            scatter(d_cgp, e_c if has_gx else None, weights)
    flat = (None if t is None else t.reshape(-1) for t in (d_params, d_cgp))
    d_params, d_cgp = flat
    return (d_params, d_x if need[1] else None, d_dy if need[2] else None, d_cgp,
            d_cgx if want_cgx else None)


def _third_wants(level_round, cgp, cgx, g_params, g_x, g_dy, need) -> Tuple[bool, bool, bool]:
    """Which of G3's d/dparams, d/dcgp and d/dcgx it gives (the others are
    None): each where ``need`` asks for it, its operand is present and some
    term reaches it."""
    has_g = g_x is not None or g_dy is not None
    return (need[0] and level_round is not None and cgx is not None and has_g, need[3] and cgp is not None and has_g,
            need[4] and cgx is not None and (has_g or g_params is not None))


def _ordered_sum(terms) -> torch.Tensor:
    """The sum of ``terms`` added one after another from the first: the
    kernels' order, from 0.0."""
    out = None
    for t in terms:
        out = t if out is None else out + t
    return out


_FWD_ARGS =[ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]

# Whether a level table has an Rng level, kept on its tensor: the lookup
# and the table gradient then launch their instantiation with the extras'
# code (kExtras), which the other modes do not pay for in registers.
_RNG_ATTR = "_has_rng_levels"


def level_table_on(table: np.ndarray, device) -> torch.Tensor:
    """The level table ``table`` (``level_table``'s int32 array) on
    ``device``, with whether it has an Rng level noted on the host."""
    t = torch.from_numpy(table).to(device)
    setattr(t, _RNG_ATTR, bool((table[:, 2] == MODE_RNG).any()))
    return t


def _rng_levels(levels: torch.Tensor) -> bool:
    """Whether ``levels`` has an Rng level: noted by ``level_table_on``,
    else read once from the device and kept on the tensor."""
    hit = getattr(levels, _RNG_ATTR, None)
    if hit is None:
        hit = bool((levels[:, 2] == MODE_RNG).any())
        setattr(levels, _RNG_ATTR, hit)
    return hit
_INPUT_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_BWDBWD_ARGS = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_int64, ctypes.c_void_p]


def _check_kernel_inputs(what: str, x: torch.Tensor, levels: torch.Tensor, n_features_per_level: int,
                         fixed_point_ok: bool = False):
    dtypes = (torch.float32, torch.uint32) if fixed_point_ok else (torch.float32,)
    if x.dim() != 2 or x.dtype not in dtypes or not x.is_contiguous():
        raise ValueError(f"{what}: x must be a contiguous 2-D tensor of {' or '.join(map(str, dtypes))}")
    if levels.dtype != torch.int32 or levels.shape[1:] != (_LEVEL_COLS,) or levels.device != x.device:
        raise ValueError(f"{what}: levels must be the (L, {_LEVEL_COLS}) int32 level table on the device of x")
    if not 1 <= x.shape[1] <= MAX_DIMS or not 1 <= int(n_features_per_level) <= MAX_FEATURES:
        raise ValueError(f"{what}: unsupported shape (dims {x.shape[1]}, features per level {n_features_per_level})")


def _check_params(what: str, params: torch.Tensor, x: torch.Tensor):
    if params.dim() != 1 or params.dtype != torch.float32 or not params.is_contiguous() or params.device != x.device:
        raise ValueError(f"{what}: params must be a contiguous 1-D float32 tensor on the device of x")


def _check_dy(what: str, dL_dy: torch.Tensor, x: torch.Tensor, n_levels: int, F: int):
    batch = x.shape[0]
    if (
        dL_dy.dim() != 2 or dL_dy.shape[0] != batch or dL_dy.shape[1] < n_levels * F
        or dL_dy.dtype not in (torch.bfloat16, torch.float32) or dL_dy.device != x.device
        or not dL_dy.is_contiguous()
    ):
        raise ValueError(f"{what}: dL_dy must be a contiguous ({batch}, >= {n_levels * F}) bfloat16 or float32 tensor on the device of x")


def _check_classes(what: str, level_round: torch.Tensor, x: torch.Tensor, n_levels: int):
    if level_round.shape != (n_levels, 2) or level_round.dtype != torch.int32 or level_round.device != x.device:
        raise ValueError(f"{what}: level_round must be the (L, 2) int32 class table on the device of x")


def _check_uniforms(what: str, u: torch.Tensor, x: torch.Tensor, n_levels: int):
    if (u.shape != (x.shape[0], n_levels) or u.dtype != torch.float32 or not u.is_contiguous()
            or u.device != x.device):
        raise ValueError(f"{what}: u must be a contiguous ({x.shape[0]}, {n_levels}) float32 tensor on the device of x")


def _launch(what: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError {err})")


def _ptr(t: Optional[torch.Tensor]):
    """A tensor's data pointer for a C entry point; None (null) for None."""
    return None if t is None else t.data_ptr()


def _lookup(what, symbol, x, params, levels, n_features_per_level, padded_width, interpolation, out_dtype):
    """Checks the operands and launches the lookup kernel ``symbol``;
    returns the (B, padded_width) output."""
    _check_kernel_inputs(what, x, levels, n_features_per_level, fixed_point_ok=True)
    _check_params(what, params, x)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what}: the kernel writes bfloat16 or float32, not {out_dtype}")
    if params.numel() >= 2**31:
        raise ValueError(f"{what}: the kernel indexes the table in 32 bits (below 2^31 values)")
    F = int(n_features_per_level)
    batch, d = x.shape
    n_levels = levels.shape[0]
    if not 1 <= n_levels <= MAX_LEVELS or padded_width < n_levels * F:
        raise ValueError(f"{what}: {n_levels} levels (1 to {MAX_LEVELS}) of {F} features into width {padded_width}")
    out = torch.empty((batch, padded_width), dtype=out_dtype, device=x.device)
    if batch == 0:
        return out
    from ._build import kernel, stream

    _launch(what, kernel("grid_fwd", symbol, _FWD_ARGS)(
        x.data_ptr(), params.data_ptr(), levels.data_ptr(), out.data_ptr(),
        batch, d, n_levels, F, padded_width, int(interpolation), int(out_dtype == torch.bfloat16),
        int(x.dtype == torch.uint32), int(_rng_levels(levels)), stream(x.get_device()),
    ))
    return out


def grid_encode(
    x: torch.Tensor,
    params: torch.Tensor,
    levels: torch.Tensor,
    n_features_per_level: int,
    padded_width: int,
    interpolation: int,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """All-levels grid lookup of positions ``x`` (B, d): fp32, or uint32
    spanning [0, 1) for fixed_point_pos (``levels`` then built with
    ``fixed_point=True``). On a CUDA ``x`` the kernel runs; ``levels`` must
    then be the level table on that device."""
    if x.device.type == "cpu":
        return grid_encode_plain(x, params, levels, n_features_per_level, padded_width, interpolation, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"grid_encode: unsupported device {x.device}")
    global LAUNCHES
    out = _lookup("grid_encode", "tcnn_grid_forward", x, params, levels, n_features_per_level, padded_width,
                  interpolation, out_dtype)
    if x.shape[0]:
        LAUNCHES += 1
    return out


def grid_encode_v1(x, params, levels, n_features_per_level, padded_width, interpolation, out_dtype=torch.bfloat16):
    """The earlier lookup kernel (``tcnn_grid_forward_v1``: one thread per
    (sample, level), level fastest, 64-bit index arithmetic), kept only so
    that chip_smoke.py can time the new kernel against it in one call and
    hold the two bitwise equal; no path of the port calls it. CUDA tensors
    only; the contract of ``grid_encode`` for fp32 positions."""
    if x.device.type != "cuda" or x.dtype != torch.float32:
        raise ValueError("grid_encode_v1: fp32 CUDA tensors only")
    global V1_LAUNCHES
    out = _lookup("grid_encode_v1", "tcnn_grid_forward_v1", x, params, levels, n_features_per_level, padded_width,
                  interpolation, out_dtype)
    if x.shape[0]:
        V1_LAUNCHES += 1
    return out


# The table gradient's launch plan (csrc/grid_bwd.cu:tcnn_grid_backward):
# blocks of BWD_THREADS threads, one sample each per tile, about
# BWD_TARGET_BLOCKS of them (132 SMs, four times); shared memory a block may
# take for private copies; a level is privatised when its rows are at most
# BWD_PRIV_ROWS_PER_SAMPLE times a block's samples. Chosen from
# ``benchmarks.grid_bwd_plans`` on an H100 (PERF.md): the kernel waits on
# latency, so more blocks keep more warps in flight, and privatising levels
# whose rows each sample hits about once or less (the flagship's levels 3-4,
# the 3D model's level 0) costs more than it saves.
BWD_THREADS = 256
BWD_SMEM_LIMIT = 114_688
BWD_TARGET_BLOCKS = 528
BWD_PRIV_ROWS_PER_SAMPLE = 4
_LEVEL_BYTES = 4 * _LEVEL_COLS
_PLAN_HEADER = 4


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


class BackwardPlan:
    """How ``tcnn_grid_backward`` runs one call (see ``backward_plan``):
    blocks of ``threads`` threads (samples per tile), ``chunk`` consecutive
    samples a block, and the dynamic shared memory's layout in bytes: each
    privatised level's copy at ``priv_offsets[l]`` (-1: the level adds
    straight into the table gradient), then the level table and class codes
    at ``levels_offset``, ``smem_bytes`` in all. ``array`` is the int32 form
    the kernel reads."""

    def __init__(self, batch, F, n_rows, accumulates_bf16, threads, chunk, priv_offsets, levels_offset, smem_bytes):
        self.batch, self.F, self.n_levels = int(batch), int(F), len(priv_offsets)
        self.n_rows, self.accumulates_bf16 = int(n_rows), bool(accumulates_bf16)
        self.threads, self.chunk = int(threads), int(chunk)
        self.priv_offsets = tuple(int(o) for o in priv_offsets)
        self.levels_offset, self.smem_bytes = int(levels_offset), int(smem_bytes)
        self.blocks = -(-self.batch // self.chunk)
        self.array = np.asarray(
            [self.threads, self.chunk, self.levels_offset, self.smem_bytes, *self.priv_offsets], np.int32
        )

    @property
    def privatised(self) -> list:
        return [o >= 0 for o in self.priv_offsets]


def backward_plan(levels, n_features_per_level: int, batch: int, classes=None, target_blocks: int = None,
                  priv_rows_per_sample: int = None) -> BackwardPlan:
    """The launch plan of the table-gradient kernel for ``batch`` samples:
    ``levels`` the level table (numpy or tensor, any device), ``classes``
    the (L, 2) class table (None: every level sums in fp32). A plain host
    function.

    ``chunk`` spreads the batch over about ``target_blocks`` blocks
    (default BWD_TARGET_BLOCKS), a multiple of the block. Then, in level
    order, each level whose class adds something, whose rows are at most
    ``priv_rows_per_sample`` (default BWD_PRIV_ROWS_PER_SAMPLE) x ``chunk``
    and whose copy (rows x F in its accumulation type, fp32 or bf16) fits
    what the level table and class codes leave of BWD_SMEM_LIMIT is
    privatised. ``benchmarks.grid_bwd_plans`` times other values of the
    two."""
    from .scatter_rows import ACC_BF16, ACC_DROP

    lt = levels.cpu().numpy() if isinstance(levels, torch.Tensor) else np.asarray(levels)
    lt = lt.view(np.uint32).astype(np.int64)
    F, batch, L = int(n_features_per_level), int(batch), len(lt)
    if L > MAX_LEVELS:
        raise ValueError(f"backward_plan: at most {MAX_LEVELS} levels")
    acc = np.zeros(L, np.int64)
    if classes is not None:
        acc = (classes.cpu().numpy() if isinstance(classes, torch.Tensor) else np.asarray(classes)).reshape(L, 2)[:, 1]
    target_blocks = BWD_TARGET_BLOCKS if target_blocks is None else int(target_blocks)
    priv_rows = BWD_PRIV_ROWS_PER_SAMPLE if priv_rows_per_sample is None else int(priv_rows_per_sample)
    threads = BWD_THREADS
    blocks = max(1, min(target_blocks, -(-batch // threads)))
    per_block = -(-batch // blocks)
    chunk = max(threads, -(-per_block // threads) * threads)
    meta = L * (_LEVEL_BYTES + 8)
    offsets, used = [], 0
    for lvl in range(L):
        rows = int(lt[lvl, 1])
        size = _align16(rows * F * (2 if acc[lvl] == ACC_BF16 else 4))
        if acc[lvl] != ACC_DROP and rows <= priv_rows * chunk and used + size + meta <= BWD_SMEM_LIMIT:
            offsets.append(used)
            used += size
        else:
            offsets.append(-1)
    return BackwardPlan(batch, F, _table_rows(lt), bool((acc == ACC_BF16).any()), threads, chunk, offsets, used,
                        used + meta)


def _backward_route(rng: bool, fixed: bool, sampled: bool, d: int) -> Tuple[str, str]:
    """The (library, C entry point) of the table gradient for a table with
    (``rng``) or without Rng levels, uint32 (``fixed``) or fp32 positions,
    with (``sampled``) or without stochastic interpolation's uniforms, at
    ``d`` dims. The instantiations with the dims at compile time take
    d = 2, 3: an Rng table with fp32 positions and no uniforms
    (``grid_bwd_rng``); without Rng levels, uint32 positions and no
    uniforms (``grid_bwd_modes`` fixed), or fp32 positions with uniforms
    (``grid_bwd_modes`` sampled). A table with none of the three takes the
    common instantiation, and every other combination the ``kExtras`` one
    with the dims at run time (both ``grid_bwd``): d = 1 or >= 4 with any
    of them, uint32 positions with an Rng level, uniforms with an Rng level
    or with uint32 positions."""
    if d in (2, 3):
        if rng and not fixed and not sampled:
            return "grid_bwd_rng", "tcnn_grid_backward_rng"
        if not rng and fixed and not sampled:
            return "grid_bwd_modes", "tcnn_grid_backward_fixed"
        if not rng and sampled and not fixed:
            return "grid_bwd_modes", "tcnn_grid_backward_sampled"
    return "grid_bwd", "tcnn_grid_backward"


def grid_backward(
    x: torch.Tensor,
    dL_dy: torch.Tensor,
    levels: torch.Tensor,
    n_features_per_level: int,
    interpolation: int,
    level_round: torch.Tensor,
    plan: Optional[BackwardPlan] = None,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Table gradient of the all-levels lookup: (n_rows * F,) fp32 for the
    flat grid parameters, for the output gradient ``dL_dy`` (B, width >= L*F)
    in bf16 or fp32, at positions ``x`` as ``grid_encode`` takes them. On a
    CUDA ``x``, ``levels`` and ``level_round`` ((L, 2) int32 classes) must
    lie on that device, and the kernel ``tcnn_grid_backward`` runs with
    ``plan`` (``backward_plan`` of these tables and batch; None: made here,
    which reads the tables back from the device); ``_backward_route``
    picks the kernel's instantiation, counted in ``BWD_ROUTE_LAUNCHES``.
    ``u``: stochastic interpolation's (B, L) fp32 uniforms (see
    ``grid_backward_plain``)."""
    if x.device.type == "cpu":
        return grid_backward_plain(x, dL_dy, levels, n_features_per_level, interpolation, level_round, u)
    if x.device.type != "cuda":
        raise ValueError(f"grid_backward: unsupported device {x.device}")
    _check_kernel_inputs("grid_backward", x, levels, n_features_per_level, fixed_point_ok=True)
    F = int(n_features_per_level)
    batch, d = x.shape
    n_levels = levels.shape[0]
    _check_dy("grid_backward", dL_dy, x, n_levels, F)
    _check_classes("grid_backward", level_round, x, n_levels)
    if u is not None:
        _check_uniforms("grid_backward", u, x, n_levels)
    if plan is None:
        plan = backward_plan(levels, F, batch, level_round)
    elif (plan.batch, plan.n_levels, plan.F) != (batch, n_levels, F):
        raise ValueError(
            f"grid_backward: the plan is for batch {plan.batch}, {plan.n_levels} levels and F {plan.F}, "
            f"not {batch}, {n_levels} and {F}"
        )
    n_values = plan.n_rows * F
    grad, grad16 = _grad_buffers(levels.device, n_values, plan.accumulates_bf16)
    from ._build import kernel, stream

    global BWD_LAUNCHES
    rng = _rng_levels(levels)
    fixed = x.dtype == torch.uint32
    route = library, symbol = _backward_route(rng, fixed, u is not None, d)
    _launch("grid_backward", kernel(library, symbol, _BWD_ARGS)(
        x.data_ptr(), dL_dy.data_ptr(), levels.data_ptr(), level_round.data_ptr(),
        None if u is None else u.data_ptr(), grad.data_ptr(), None if grad16 is None else grad16.data_ptr(),
        batch, d, n_levels, F, dL_dy.shape[1], int(interpolation), int(dL_dy.dtype == torch.bfloat16),
        int(fixed), int(rng), n_values, plan.array.ctypes.data, stream(x.get_device()),
    ))
    BWD_LAUNCHES += 1
    BWD_ROUTE_LAUNCHES[route] = BWD_ROUTE_LAUNCHES.get(route, 0) + 1
    return grad


_FWD_WINDOWED_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_BWD_WINDOWED_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]


def windowed_tables(levels: np.ndarray, windows: np.ndarray, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A rank's level table ``levels`` ((L, 32) int32, ``level_table``'s)
    and windows ((L, 2) int32: first, rows) on ``device`` as views of ONE
    buffer, the windows right after the table: where the windowed kernels
    read them (``csrc/grid_sharded.cu``)."""
    L = len(levels)
    buf = torch.from_numpy(np.concatenate([np.asarray(levels, np.int32).reshape(-1),
                                           np.asarray(windows, np.int32).reshape(-1)])).to(device)
    t = buf[: L * _LEVEL_COLS].view(L, _LEVEL_COLS)
    setattr(t, _RNG_ATTR, bool((np.asarray(levels)[:, 2] == MODE_RNG).any()))
    return t, buf[L * _LEVEL_COLS :].view(L, 2)


def _check_windows(what: str, windows: torch.Tensor, levels: torch.Tensor, x: torch.Tensor, n_levels: int):
    if (windows.shape != (n_levels, 2) or windows.dtype != torch.int32 or not windows.is_contiguous()
            or windows.device != x.device):
        raise ValueError(f"{what}: windows must be the contiguous ({n_levels}, 2) int32 windows on the device of x")
    if windows.data_ptr() != levels.data_ptr() + levels.numel() * levels.element_size():
        raise ValueError(f"{what}: the windows must follow the level table in one buffer (windowed_tables)")


_F32_CLASS_TABLES: Dict[tuple, torch.Tensor] = {}


def _f32_classes(n_levels: int, device: torch.device) -> torch.Tensor:
    """The (n_levels, 2) class table of every level (no rounding, fp32
    sums) on ``device``, made once (a captured step copies nothing)."""
    from .scatter_rows import ACC_F32, CONTRIB_NONE

    key = (n_levels, device.type, device.index)
    t = _F32_CLASS_TABLES.get(key)
    if t is None:
        t = _F32_CLASS_TABLES[key] = torch.tensor([[CONTRIB_NONE, ACC_F32]] * n_levels, dtype=torch.int32,
                                                  device=device)
    return t


def windowed_plan(levels, windows, n_features_per_level: int, batch: int) -> BackwardPlan:
    """``backward_plan`` of the windowed table gradient: ``levels`` (the
    rank's level table: local offsets, global sizes) with each level's rows
    those of its window, every level summing in fp32; a host function
    (``levels`` and ``windows`` as numpy arrays or tensors on any device)."""
    lt = (levels.cpu().numpy() if isinstance(levels, torch.Tensor) else np.asarray(levels)).copy()
    lt[:, 1] = _windows_np(windows)[:, 1]
    return backward_plan(lt, n_features_per_level, batch)


def grid_encode_windowed(
    x: torch.Tensor,
    params: torch.Tensor,
    levels: torch.Tensor,
    windows: torch.Tensor,
    n_features_per_level: int,
    interpolation: int,
) -> torch.Tensor:
    """The lookup of a rank of a row-sharded table: (B, n_levels * F) fp32
    partial features of positions ``x`` (B, d) fp32, ``params`` the rank's
    local rows, ``levels`` its level table (each level's offset its first
    local row, its size the level's global size) and ``windows`` the
    (n_levels, 2) int32 (first, rows) of each level it holds, both from
    ``windowed_tables`` on a CUDA ``x``. A corner
    outside its level's window adds zero; the sum over the ranks is the
    lookup of the whole table. On a CUDA ``x`` the kernel
    ``tcnn_grid_forward_windowed`` runs (``csrc/grid_sharded.cu``)."""
    F = int(n_features_per_level)
    width = levels.shape[0] * F
    if x.device.type == "cpu":
        return grid_encode_plain(x, params, levels, F, width, interpolation, torch.float32, windows)
    if x.device.type != "cuda":
        raise ValueError(f"grid_encode_windowed: unsupported device {x.device}")
    what = "grid_encode_windowed"
    _check_kernel_inputs(what, x, levels, F)
    _check_params(what, params, x)
    n_levels = levels.shape[0]
    _check_windows(what, windows, levels, x, n_levels)
    if not 1 <= n_levels <= MAX_LEVELS:
        raise ValueError(f"{what}: {n_levels} levels (1 to {MAX_LEVELS})")
    if params.numel() >= 2**31:
        raise ValueError(f"{what}: the kernel indexes the table in 32 bits (below 2^31 values)")
    batch, d = x.shape
    out = torch.empty((batch, width), dtype=torch.float32, device=x.device)
    if batch == 0:
        return out
    from ._build import kernel, stream

    global WINDOWED_LAUNCHES
    _launch(what, kernel("grid_sharded", "tcnn_grid_forward_windowed", _FWD_WINDOWED_ARGS)(
        x.data_ptr(), params.data_ptr(), levels.data_ptr(), windows.data_ptr(), out.data_ptr(),
        batch, d, n_levels, F, width, int(interpolation), int(_rng_levels(levels)), stream(x.get_device()),
    ))
    WINDOWED_LAUNCHES += 1
    return out


def grid_backward_windowed(
    x: torch.Tensor,
    dL_dy: torch.Tensor,
    levels: torch.Tensor,
    windows: torch.Tensor,
    n_features_per_level: int,
    interpolation: int,
    plan: Optional[BackwardPlan] = None,
) -> torch.Tensor:
    """The table gradient of ``grid_encode_windowed``: the rank's local
    rows, (sum of the windows' rows * F,) fp32, from the contributions w *
    dL_dy (fp32, no rounding, fp32 sums: the class of the JAX package's
    autodiff of its sharded lookup) of the corners inside each level's
    window; ``dL_dy`` (B, >= n_levels * F) bf16 or fp32. On a CUDA ``x``
    the kernel ``tcnn_grid_backward_windowed`` runs with ``plan``
    (``windowed_plan``; None: made here), counted under
    ``WINDOWED_BWD_ROUTE`` in ``BWD_ROUTE_LAUNCHES``."""
    F = int(n_features_per_level)
    n_levels = levels.shape[0]
    classes = _f32_classes(n_levels, x.device)
    if x.device.type == "cpu":
        return grid_backward_plain(x, dL_dy, levels, F, interpolation, classes, window=windows)
    if x.device.type != "cuda":
        raise ValueError(f"grid_backward_windowed: unsupported device {x.device}")
    what = "grid_backward_windowed"
    _check_kernel_inputs(what, x, levels, F)
    _check_dy(what, dL_dy, x, n_levels, F)
    _check_windows(what, windows, levels, x, n_levels)
    batch, d = x.shape
    if plan is None:
        plan = windowed_plan(levels, windows, F, batch)
    elif (plan.batch, plan.n_levels, plan.F) != (batch, n_levels, F):
        raise ValueError(
            f"{what}: the plan is for batch {plan.batch}, {plan.n_levels} levels and F {plan.F}, "
            f"not {batch}, {n_levels} and {F}"
        )
    n_values = plan.n_rows * F
    grad = torch.empty(n_values, dtype=torch.float32, device=x.device)
    from ._build import kernel, stream

    _launch(what, kernel(*WINDOWED_BWD_ROUTE, _BWD_WINDOWED_ARGS)(
        x.data_ptr(), dL_dy.data_ptr(), levels.data_ptr(), classes.data_ptr(), windows.data_ptr(), grad.data_ptr(),
        batch, d, n_levels, F, dL_dy.shape[1], int(interpolation), int(dL_dy.dtype == torch.bfloat16),
        int(_rng_levels(levels)), n_values, plan.array.ctypes.data, stream(x.get_device()),
    ))
    BWD_ROUTE_LAUNCHES[WINDOWED_BWD_ROUTE] = BWD_ROUTE_LAUNCHES.get(WINDOWED_BWD_ROUTE, 0) + 1
    return grad


def _grad_buffers(device, n_values, accumulates_bf16):
    """The fp32 table-gradient buffer and, when a level's class sums in
    bf16, its bf16 scratch; both filled by the kernel."""
    grad16 = torch.empty(n_values, dtype=torch.bfloat16, device=device) if accumulates_bf16 else None
    return torch.empty(n_values, dtype=torch.float32, device=device), grad16


def grid_backward_input(
    x: torch.Tensor,
    dL_dy: torch.Tensor,
    params: torch.Tensor,
    levels: torch.Tensor,
    n_features_per_level: int,
    interpolation: int,
) -> torch.Tensor:
    """Input gradient of the all-levels lookup (G1): (B, d) fp32 for the
    output gradient ``dL_dy`` (B, width >= L*F) in bf16 or fp32; see
    ``grid_backward_input_plain``. On a CUDA ``x`` the kernel
    ``tcnn_grid_backward_input`` runs (``csrc/grid_input_grad.cu``)."""
    if x.device.type == "cpu":
        return grid_backward_input_plain(x, dL_dy, params, levels, n_features_per_level, interpolation)
    if x.device.type != "cuda":
        raise ValueError(f"grid_backward_input: unsupported device {x.device}")
    _check_kernel_inputs("grid_backward_input", x, levels, n_features_per_level)
    _check_params("grid_backward_input", params, x)
    F = int(n_features_per_level)
    batch, d = x.shape
    n_levels = levels.shape[0]
    _check_dy("grid_backward_input", dL_dy, x, n_levels, F)
    dx = torch.empty((batch, d), dtype=torch.float32, device=x.device)
    if batch == 0:
        return dx
    from ._build import kernel, stream

    global INPUT_LAUNCHES
    _launch("grid_backward_input", kernel("grid_input_grad", "tcnn_grid_backward_input", _INPUT_ARGS)(
        x.data_ptr(), dL_dy.data_ptr(), params.data_ptr(), levels.data_ptr(), dx.data_ptr(),
        batch, d, n_levels, F, dL_dy.shape[1], int(interpolation), int(dL_dy.dtype == torch.bfloat16),
        stream(x.get_device()),
    ))
    INPUT_LAUNCHES += 1
    return dx


def grid_backward_backward(
    x: torch.Tensor,
    dL_dy: torch.Tensor,
    params: torch.Tensor,
    levels: torch.Tensor,
    n_features_per_level: int,
    interpolation: int,
    level_round: Optional[torch.Tensor],
    cgp: Optional[torch.Tensor],
    cgx: Optional[torch.Tensor],
    accumulates_bf16: Optional[bool] = None,
) -> Tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor]:
    """Double backward of the all-levels lookup (G2): (d/dparams or None,
    d/dx, d/d(dL_dy)) as ``grid_backward_backward_plain`` defines them. On a
    CUDA ``x`` the kernel ``tcnn_grid_backward_backward`` runs (one launch,
    the gathers and the table scatter together; ``csrc/grid_input_grad.cu``)."""
    if x.device.type == "cpu":
        return grid_backward_backward_plain(
            x, dL_dy, params, levels, n_features_per_level, interpolation, level_round, cgp, cgx
        )
    if x.device.type != "cuda":
        raise ValueError(f"grid_backward_backward: unsupported device {x.device}")
    what = "grid_backward_backward"
    _check_kernel_inputs(what, x, levels, n_features_per_level)
    _check_params(what, params, x)
    F = int(n_features_per_level)
    batch, d = x.shape
    n_levels = levels.shape[0]
    _check_dy(what, dL_dy, x, n_levels, F)
    _check_cotangents(what, x, params, cgp, cgx)
    grad = grad16 = None
    n_values = params.numel()
    if level_round is not None:
        _check_classes(what, level_round, x, n_levels)
        if cgx is not None:
            if accumulates_bf16 is None:
                from .scatter_rows import ACC_BF16

                accumulates_bf16 = bool((level_round[:, 1] == ACC_BF16).any())
            grad, grad16 = _grad_buffers(x.device, n_values, accumulates_bf16)
    d_x = torch.empty((batch, d), dtype=torch.float32, device=x.device)
    d_dy = torch.empty((batch, dL_dy.shape[1]), dtype=torch.float32, device=x.device)
    from ._build import kernel, stream

    global BWDBWD_LAUNCHES
    _launch(what, kernel("grid_input_grad", "tcnn_grid_backward_backward", _BWDBWD_ARGS)(
        x.data_ptr(), dL_dy.data_ptr(), params.data_ptr(), _ptr(cgp), _ptr(cgx), levels.data_ptr(), _ptr(level_round),
        _ptr(grad), _ptr(grad16), d_x.data_ptr(), d_dy.data_ptr(),
        batch, d, n_levels, F, dL_dy.shape[1], int(interpolation), int(dL_dy.dtype == torch.bfloat16), n_values,
        stream(x.get_device()),
    ))
    BWDBWD_LAUNCHES += 1
    return grad, d_x, d_dy


def _check_cotangents(what, x, params, cgp, cgx):
    if cgp is not None and (cgp.shape != params.shape or cgp.dtype != torch.float32 or not cgp.is_contiguous()
                            or cgp.device != x.device):
        raise ValueError(f"{what}: cgp must be a contiguous float32 tensor shaped like params")
    if cgx is not None and (cgx.shape != x.shape or cgx.dtype != torch.float32 or not cgx.is_contiguous()
                            or cgx.device != x.device):
        raise ValueError(f"{what}: cgx must be a contiguous float32 tensor shaped like x")


_INPUT_WINDOWED_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_BWDBWD_WINDOWED_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_int64, ctypes.c_void_p]


def _check_windowed(what, x, dL_dy, params, levels, windows, F):
    _check_kernel_inputs(what, x, levels, F)
    _check_params(what, params, x)
    n_levels = levels.shape[0]
    _check_dy(what, dL_dy, x, n_levels, F)
    if dL_dy.dtype != torch.float32:
        raise ValueError(f"{what}: dL_dy must be float32 (the gradient of the windowed lookup's fp32 features)")
    _check_windows(what, windows, levels, x, n_levels)


def grid_backward_input_windowed(
    x: torch.Tensor,
    dL_dy: torch.Tensor,
    params: torch.Tensor,
    levels: torch.Tensor,
    windows: torch.Tensor,
    n_features_per_level: int,
    interpolation: int,
) -> torch.Tensor:
    """The input gradient of ``grid_encode_windowed`` (G1 of a rank of a
    row-sharded table): the rank's partial of dL/dx, (B, d) fp32, from the
    corners it holds, for the fp32 output gradient ``dL_dy`` (B, >= L*F);
    the sum over the ranks of the model group is the input gradient of the
    whole table. ``params``, ``levels`` and ``windows`` as
    ``grid_encode_windowed`` takes them. On a CUDA ``x`` the kernel
    ``tcnn_grid_backward_input_windowed`` runs (``csrc/grid_sharded.cu``)."""
    F = int(n_features_per_level)
    if x.device.type == "cpu":
        return grid_backward_input_plain(x, dL_dy, params, levels, F, interpolation, windows)
    if x.device.type != "cuda":
        raise ValueError(f"grid_backward_input_windowed: unsupported device {x.device}")
    what = "grid_backward_input_windowed"
    _check_windowed(what, x, dL_dy, params, levels, windows, F)
    batch, d = x.shape
    dx = torch.empty((batch, d), dtype=torch.float32, device=x.device)
    if batch == 0:
        return dx
    from ._build import kernel, stream

    global WINDOWED_INPUT_LAUNCHES
    _launch(what, kernel("grid_sharded", "tcnn_grid_backward_input_windowed", _INPUT_WINDOWED_ARGS)(
        x.data_ptr(), dL_dy.data_ptr(), params.data_ptr(), levels.data_ptr(), windows.data_ptr(), dx.data_ptr(),
        batch, d, levels.shape[0], F, dL_dy.shape[1], int(interpolation), stream(x.get_device()),
    ))
    WINDOWED_INPUT_LAUNCHES += 1
    return dx


def grid_backward_backward_windowed(
    x: torch.Tensor,
    dL_dy: torch.Tensor,
    params: torch.Tensor,
    levels: torch.Tensor,
    windows: torch.Tensor,
    n_features_per_level: int,
    interpolation: int,
    cgp: Optional[torch.Tensor],
    cgx: Optional[torch.Tensor],
) -> Tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor]:
    """The double backward of a rank of a row-sharded table (G2 of
    ``grid_encode_windowed``) for the cotangents ``cgp`` (of its local table
    gradient, shaped like ``params``) and ``cgx`` (of the whole input
    gradient, (B, d)), either None for zero: (d/dparams of its local rows,
    fp32 sums, or None without ``cgx``; its partial d/dx; its partial
    d/d(dL_dy)), as ``grid_backward_backward_plain`` with ``window`` defines
    them. The caller sums the partials over the model group. On a CUDA
    ``x`` the kernel ``tcnn_grid_backward_backward_windowed`` runs."""
    F = int(n_features_per_level)
    if x.device.type == "cpu":
        classes = _f32_classes(levels.shape[0], x.device)
        return grid_backward_backward_plain(x, dL_dy, params, levels, F, interpolation, classes, cgp, cgx, windows)
    if x.device.type != "cuda":
        raise ValueError(f"grid_backward_backward_windowed: unsupported device {x.device}")
    what = "grid_backward_backward_windowed"
    _check_windowed(what, x, dL_dy, params, levels, windows, F)
    _check_cotangents(what, x, params, cgp, cgx)
    batch, d = x.shape
    grad = None if cgx is None else torch.empty(params.numel(), dtype=torch.float32, device=x.device)
    d_x = torch.empty((batch, d), dtype=torch.float32, device=x.device)
    d_dy = torch.empty((batch, dL_dy.shape[1]), dtype=torch.float32, device=x.device)
    from ._build import kernel, stream

    global WINDOWED_BWDBWD_LAUNCHES
    _launch(what, kernel("grid_sharded", "tcnn_grid_backward_backward_windowed", _BWDBWD_WINDOWED_ARGS)(
        x.data_ptr(), dL_dy.data_ptr(), params.data_ptr(), _ptr(cgp), _ptr(cgx), levels.data_ptr(), windows.data_ptr(),
        _ptr(grad), d_x.data_ptr(), d_dy.data_ptr(), batch, d, levels.shape[0], F, dL_dy.shape[1], int(interpolation),
        params.numel(), stream(x.get_device()),
    ))
    WINDOWED_BWDBWD_LAUNCHES += 1
    return grad, d_x, d_dy


_THIRD_ARGS = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 7 + [ctypes.c_int64, ctypes.c_void_p]
_THIRD_WINDOWED_ARGS = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6 + [ctypes.c_int64, ctypes.c_void_p]


def _check_third(what, x, params, cgp, cgx, g_params, g_x, g_dy, dL_dy):
    _check_cotangents(what, x, params, cgp, cgx)
    _check_cotangents(what, x, params, g_params, g_x)
    if g_dy is not None and (g_dy.shape != dL_dy.shape or g_dy.dtype != torch.float32 or not g_dy.is_contiguous()
                             or g_dy.device != x.device):
        raise ValueError(f"{what}: g_dy must be a contiguous float32 tensor shaped like dL_dy")


def _third_outputs(x, params, dL_dy, level_round, cgp, cgx, g_params, g_x, g_dy, need, bf16):
    """The outputs ``grid_third_order_plain`` returns for these operands,
    allocated on the device of x (each filled by the kernel), None where it
    returns None; with ``bf16`` the bf16 scratch of the two scatters."""
    want_params, want_cgp, want_cgx = _third_wants(level_round, cgp, cgx, g_params, g_x, g_dy, need)
    n, dev = params.numel(), x.device

    def buf(want, shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev) if want else None

    return (buf(want_params, (n,)), buf(need[1], x.shape), buf(need[2], dL_dy.shape), buf(want_cgp, (n,)),
            buf(want_cgx, x.shape), buf(want_params and bf16, (n,), torch.bfloat16),
            buf(want_cgp and bf16, (n,), torch.bfloat16))


def grid_backward3(
    x: torch.Tensor,
    dL_dy: torch.Tensor,
    params: torch.Tensor,
    levels: torch.Tensor,
    n_features_per_level: int,
    interpolation: int,
    level_round: Optional[torch.Tensor],
    cgp: Optional[torch.Tensor],
    cgx: Optional[torch.Tensor],
    g_params: Optional[torch.Tensor],
    g_x: Optional[torch.Tensor],
    g_dy: Optional[torch.Tensor],
    need: Tuple[bool, ...] = (True,) * 5,
    accumulates_bf16: Optional[bool] = None,
) -> Tuple[Optional[torch.Tensor], ...]:
    """The third order of the all-levels lookup (G3): (d/dparams, d/dx,
    d/d(dL_dy), d/dcgp, d/dcgx) for the cotangents (g_params, g_x, g_dy) of
    G2's outputs, as ``grid_third_order_plain`` defines them, fp32 positions
    only. On a CUDA ``x`` the kernel ``tcnn_grid_backward3`` runs (one
    launch, the gathers and both class scatters together;
    ``csrc/grid_third_order.cu``), counted in THIRD_LAUNCHES."""
    F = int(n_features_per_level)
    if x.device.type == "cpu":
        return grid_third_order_plain(x, dL_dy, params, levels, F, interpolation, level_round, cgp, cgx, g_params,
                                      g_x, g_dy, need=need)
    if x.device.type != "cuda":
        raise ValueError(f"grid_backward3: unsupported device {x.device}")
    what = "grid_backward3"
    _check_kernel_inputs(what, x, levels, F)
    _check_params(what, params, x)
    n_levels = levels.shape[0]
    _check_dy(what, dL_dy, x, n_levels, F)
    _check_third(what, x, params, cgp, cgx, g_params, g_x, g_dy, dL_dy)
    if level_round is not None:
        _check_classes(what, level_round, x, n_levels)
        if accumulates_bf16 is None:
            from .scatter_rows import ACC_BF16

            accumulates_bf16 = bool((level_round[:, 1] == ACC_BF16).any())
    outs = _third_outputs(x, params, dL_dy, level_round, cgp, cgx, g_params, g_x, g_dy, need,
                          bool(accumulates_bf16))
    d_params, d_x, d_dy, d_cgp, d_cgx, params16, cgp16 = outs
    from ._build import kernel, stream

    global THIRD_LAUNCHES
    _launch(what, kernel("grid_third_order", "tcnn_grid_backward3", _THIRD_ARGS)(
        x.data_ptr(), dL_dy.data_ptr(), params.data_ptr(), _ptr(cgp), _ptr(cgx), _ptr(g_params), _ptr(g_x),
        _ptr(g_dy), levels.data_ptr(), _ptr(level_round), *(_ptr(t) for t in outs),
        x.shape[0], x.shape[1], n_levels, F, dL_dy.shape[1], int(interpolation), int(dL_dy.dtype == torch.bfloat16),
        params.numel(), stream(x.get_device()),
    ))
    THIRD_LAUNCHES += 1
    return d_params, d_x, d_dy, d_cgp, d_cgx


def grid_backward3_windowed(
    x: torch.Tensor,
    dL_dy: torch.Tensor,
    params: torch.Tensor,
    levels: torch.Tensor,
    windows: torch.Tensor,
    n_features_per_level: int,
    interpolation: int,
    cgp: Optional[torch.Tensor],
    cgx: Optional[torch.Tensor],
    g_params: Optional[torch.Tensor],
    g_x: Optional[torch.Tensor],
    g_dy: Optional[torch.Tensor],
    need: Tuple[bool, ...] = (True,) * 5,
) -> Tuple[Optional[torch.Tensor], ...]:
    """The third order of a rank of a row-sharded table (G3 of
    ``grid_encode_windowed``): its local d/dparams and d/dcgp (fp32 sums,
    no rounding: the windowed table gradient's class) and its partials of
    d/dx, d/d(dL_dy) and d/dcgx, as ``grid_third_order_plain`` with
    ``window`` defines them; fp32 ``dL_dy``. The caller sums the partials
    over the model group. On a CUDA ``x`` the kernel
    ``tcnn_grid_backward3_windowed`` runs, counted in
    WINDOWED_THIRD_LAUNCHES."""
    F = int(n_features_per_level)
    classes = _f32_classes(levels.shape[0], x.device)
    if x.device.type == "cpu":
        return grid_third_order_plain(x, dL_dy, params, levels, F, interpolation, classes, cgp, cgx, g_params, g_x,
                                      g_dy, windows, need)
    if x.device.type != "cuda":
        raise ValueError(f"grid_backward3_windowed: unsupported device {x.device}")
    what = "grid_backward3_windowed"
    _check_windowed(what, x, dL_dy, params, levels, windows, F)
    _check_third(what, x, params, cgp, cgx, g_params, g_x, g_dy, dL_dy)
    outs = _third_outputs(x, params, dL_dy, classes, cgp, cgx, g_params, g_x, g_dy, need, False)[:5]
    from ._build import kernel, stream

    global WINDOWED_THIRD_LAUNCHES
    _launch(what, kernel("grid_third_order", "tcnn_grid_backward3_windowed", _THIRD_WINDOWED_ARGS)(
        x.data_ptr(), dL_dy.data_ptr(), params.data_ptr(), _ptr(cgp), _ptr(cgx), _ptr(g_params), _ptr(g_x),
        _ptr(g_dy), levels.data_ptr(), windows.data_ptr(), *(_ptr(t) for t in outs),
        x.shape[0], x.shape[1], levels.shape[0], F, dL_dy.shape[1], int(interpolation), params.numel(),
        stream(x.get_device()),
    ))
    WINDOWED_THIRD_LAUNCHES += 1
    return outs


_SAMPLED_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def grid_encode_sampled_plain(
    x: torch.Tensor,
    table: torch.Tensor,
    levels: torch.Tensor,
    u: torch.Tensor,
    n_features_per_level: int,
    padded_width: int,
    interpolation: int,
) -> torch.Tensor:
    """Plain version of ``grid_encode_sampled``: per level, the row of
    ``table`` at the corner ``_sampled_corner`` picks, read as the lookup
    reads its table."""
    batch, d = x.shape
    x = _positions(x)
    F = int(n_features_per_level)
    tab = table.view(-1, F)
    lt = levels.cpu().numpy().view(np.uint32).astype(np.int64)
    bits_np = _corner_bits(d, interpolation)
    outs = []
    for lvl, row in enumerate(lt):
        idx, _, t = _level_corners(x, row, interpolation, bits_np)
        outs.append(_read_table(tab, torch.gather(idx, 1, _sampled_corner(t, u[:, lvl]))[:, 0], row))
    y = torch.stack(outs, dim=1).reshape(batch, -1).to(torch.float32)
    if padded_width > y.shape[1]:
        y = torch.cat([y, y.new_zeros((batch, padded_width - y.shape[1]))], dim=1)
    return y


def grid_encode_sampled(
    x: torch.Tensor,
    table: torch.Tensor,
    levels: torch.Tensor,
    u: torch.Tensor,
    n_features_per_level: int,
    padded_width: int,
    interpolation: int,
) -> torch.Tensor:
    """The gather of stochastic interpolation's sampled corners: (B,
    padded_width) fp32, per (sample, level) the F values of ``table`` (flat
    fp32, shaped like the grid parameters) at the one corner to which the
    stochastic table gradient (``grid_backward`` given ``u``) sends that
    sample's dL/dy row, weight 1, read as the lookup reads its table (the
    level table's rounding); the padding columns zeros.
    Its transpose: with ``table`` a cotangent of that table gradient, the
    gradient with respect to dL/dy (tcnn_tpu/encodings/grid.py:
    _stochastic_combine_bwd). ``x`` fp32 or uint32 (fixed_point_pos), ``u``
    the (B, L) fp32 uniforms; Linear or Smoothstep (Nearest has no sampled
    corner). On a CUDA ``x`` the kernel ``tcnn_grid_forward_sampled`` runs
    (``csrc/grid_bwd_modes.cu``)."""
    if int(interpolation) == INTERP_NEAREST:
        raise ValueError("grid_encode_sampled: Nearest interpolation samples no corner")
    F = int(n_features_per_level)
    if x.device.type == "cpu":
        return grid_encode_sampled_plain(x, table, levels, u, F, padded_width, interpolation)
    if x.device.type != "cuda":
        raise ValueError(f"grid_encode_sampled: unsupported device {x.device}")
    what = "grid_encode_sampled"
    _check_kernel_inputs(what, x, levels, F, fixed_point_ok=True)
    _check_params(what, table, x)
    n_levels = levels.shape[0]
    _check_uniforms(what, u, x, n_levels)
    if table.numel() >= 2**31:
        raise ValueError(f"{what}: the kernel indexes the table in 32 bits (below 2^31 values)")
    if not 1 <= n_levels <= MAX_LEVELS or padded_width < n_levels * F:
        raise ValueError(f"{what}: {n_levels} levels (1 to {MAX_LEVELS}) of {F} features into width {padded_width}")
    batch, d = x.shape
    out = torch.empty((batch, padded_width), dtype=torch.float32, device=x.device)
    if batch == 0:
        return out
    from ._build import kernel, stream

    global SAMPLED_LAUNCHES
    _launch(what, kernel("grid_bwd_modes", "tcnn_grid_forward_sampled", _SAMPLED_ARGS)(
        x.data_ptr(), table.data_ptr(), levels.data_ptr(), u.data_ptr(), out.data_ptr(), batch, d, n_levels, F,
        padded_width, int(interpolation), int(x.dtype == torch.uint32), int(_rng_levels(levels)),
        stream(x.get_device()),
    ))
    SAMPLED_LAUNCHES += 1
    return out


def _without_dropped(d_dy: torch.Tensor, level_round: torch.Tensor, F: int) -> torch.Tensor:
    """``d_dy`` with zeros in the columns of every level whose class drops
    its table gradient (no cotangent reaches those levels)."""
    from .scatter_rows import ACC_DROP

    width = level_round.shape[0] * F
    keep = (level_round[:, 1] != ACC_DROP).repeat_interleave(F)
    return torch.cat([torch.where(keep, d_dy[:, :width], 0.0), d_dy[:, width:]], dim=1)


def _cgp_term(x, cgp, levels, level_round, u, F, width, interp, plain):
    """d/d(dL_dy) of <cgp, table gradient> where the table gradient has no
    derivative in x (uint32 positions) or takes one sampled corner (``u``):
    the transpose of that gradient applied to ``cgp``, (B, width) fp32, zero
    in the padding columns and on the levels whose class drops it. Without
    ``u``, the lookup of ``cgp`` as a table at the positions
    (``tcnn_grid_forward``); with ``u``, the gather of its sampled corners
    (``grid_encode_sampled``); each reads ``cgp`` as the lookup reads its
    table, as the JAX package's autodiff does (``grid_backward_backward_plain``)."""
    if u is None:
        fwd = grid_encode_plain if plain else grid_encode
        y = fwd(x, cgp, levels, F, width, interp, torch.float32)
    else:
        fwd = grid_encode_sampled_plain if plain else grid_encode_sampled
        y = fwd(x, cgp, levels, u, F, width, interp)
    return _without_dropped(y, level_round, F)


def _double_backward(x, params, dy, levels, level_round, u, cgp, cgx, meta):
    """The lookup's second derivatives for the cotangents ``cgp`` and
    ``cgx`` of its first backward (dparams, dx), either None: (d/dparams,
    d/dx, d/d(dL_dy)), each None where it is zero, from the kernels (G2,
    and the lookups of ``_cgp_term``), or with ``plain`` in ``meta`` their
    plain versions. The JAX package's autodiff gives the same terms
    (tcnn_tpu/encodings/grid.py:1354): the cgp term of uint32 positions or
    of a sampled corner has no d/dx and no d/dparams (positions without a
    gradient; a sampled corner constant in x), and ``cgx`` comes with fp32
    positions only; any other term is G2's, the sampled table gradient's
    cgx term the deterministic one (as ``_stochastic_combine_bwd``'s weight
    gradient)."""
    F, interp, plain, acc16, plan = meta
    cgp_alone = cgp is not None and (x.dtype != torch.float32 or u is not None)
    d_dy_cgp = _cgp_term(x, cgp, levels, level_round, u, F, dy.shape[1], interp, plain) if cgp_alone else None
    if cgp_alone:
        cgp = None
    if cgp is None and cgx is None:
        return None, None, d_dy_cgp
    bwdbwd = grid_backward_backward_plain if plain else grid_backward_backward
    extra = () if plain else (acc16,)
    d_params, d_x, d_dy = bwdbwd(x, dy, params, levels, F, interp, level_round, cgp, cgx, *extra)
    return d_params, d_x, d_dy if d_dy_cgp is None else d_dy + d_dy_cgp


def _autograd_of(fn, inputs, wanted, grads):
    """The gradients of ``fn``'s outputs, weighted by ``grads`` (None:
    zero), with respect to ``inputs`` where ``wanted`` says (None
    elsewhere): autograd of the plain version ``fn`` recomputed from the
    saved ``inputs``. Under grad mode (``create_graph``) an input that is
    part of the graph enters as it is, so that the gradients are themselves
    differentiable, to any order; else each input enters detached."""
    create = torch.is_grad_enabled()
    leaves = []
    for t, w in zip(inputs, wanted):
        if t is None or not (w and t.is_floating_point()):
            leaves.append(t if t is None or not t.requires_grad else t.detach())
        elif create and t.requires_grad:
            leaves.append(t)
        else:
            leaves.append(t.detach().requires_grad_(True))
    with torch.enable_grad():
        outs = fn(*leaves)
    pairs = [(o, g) for o, g in zip(outs, grads) if o is not None and g is not None and o.requires_grad]
    targets = [t for t, w in zip(leaves, wanted) if w and t is not None and t.requires_grad]
    got = iter(torch.autograd.grad([o for o, _ in pairs], targets, [g.to(o.dtype) for o, g in pairs],
                                   create_graph=create, allow_unused=True) if pairs and targets else [])
    return [next(got, None) if w and t is not None and t.requires_grad else None for t, w in zip(leaves, wanted)]


class GridEncodeFunction(torch.autograd.Function):
    """The all-levels lookup, differentiable with respect to the flat grid
    parameters and the positions: the forward is ``grid_encode``; the
    backward ``grid_backward`` for the parameters and ``grid_backward_input``
    for the positions, each only where ``ctx.needs_input_grad`` asks for it;
    with ``plain`` their plain versions on any device. A backward that must
    itself be differentiable (``create_graph=True``, e.g. an eikonal loss)
    runs as ``GridEncodeBackwardFunction``, whose own backward is the double
    backward kernel: the exact second order that ``jax.grad`` of
    ``jax.grad`` gives in the JAX package; the third order is the G3 kernel
    and every further order autograd of its plain version.

    ``GridEncodeFunction.apply(x, params, levels, level_round, u, meta)``
    with ``meta`` = (n_features_per_level, padded_width, interpolation,
    out_dtype, plain, accumulates_bf16, plan), ``plan`` the table gradient's
    ``backward_plan`` (None: made at the backward) and ``u`` None or
    stochastic interpolation's (B, L) uniforms, which only the table
    gradient reads. Positions of fixed_point_pos (uint32) have no gradient.
    """

    @staticmethod
    def forward(ctx, x, params, levels, level_round, u, meta):
        F, padded_width, interp, out_dtype, plain, acc16, plan = meta
        ctx.meta = (F, interp, plain, acc16, plan)
        ctx.save_for_backward(x, params, levels, level_round, u)
        fwd = grid_encode_plain if plain else grid_encode
        return fwd(x, params, levels, F, padded_width, interp, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, params, levels, level_round, u = ctx.saved_tensors
        F, interp, plain, acc16, plan = ctx.meta
        need_x, need_params = ctx.needs_input_grad[0], ctx.needs_input_grad[1]
        dy = dy.contiguous()
        if torch.is_grad_enabled():
            dparams, dx = GridEncodeBackwardFunction.apply(
                x, params, dy, levels, level_round if need_params else None, u, ctx.meta, need_x
            )
            return dx, dparams, None, None, None, None
        dparams = dx = None
        if need_params:
            if plain:
                dparams = grid_backward_plain(x, dy, levels, F, interp, level_round, u)
            else:
                dparams = grid_backward(x, dy, levels, F, interp, level_round, plan, u)
        if need_x:
            bwd_x = grid_backward_input_plain if plain else grid_backward_input
            dx = bwd_x(x, dy, params, levels, F, interp)
        return dx, dparams, None, None, None, None


class GridEncodeBackwardFunction(torch.autograd.Function):
    """The lookup's first backward as a differentiable function of (x,
    params, dL_dy): its forward returns (dparams, dx), each None where it is
    not wanted (``level_round`` None: no dparams; ``need_x`` False: no dx);
    its backward is the double backward (``_double_backward``: G2 and, for
    a cotangent of the table gradient of uint32 positions or of a sampled
    corner, the lookup of that cotangent) or, where that backward must
    itself be differentiable (a third order), ``GridEncodeBackwardBackwardFunction``.

    ``GridEncodeBackwardFunction.apply(x, params, dL_dy, levels,
    level_round, u, meta, need_x)`` with the ``meta`` that
    ``GridEncodeFunction`` keeps.
    """

    @staticmethod
    def forward(ctx, x, params, dy, levels, level_round, u, meta, need_x):
        F, interp, plain, acc16, plan = meta
        ctx.meta = meta
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, params, dy, levels, level_round, u)
        dparams = dx = None
        if level_round is not None:
            if plain:
                dparams = grid_backward_plain(x, dy, levels, F, interp, level_round, u)
            else:
                dparams = grid_backward(x, dy, levels, F, interp, level_round, plan, u)
        if need_x:
            bwd_x = grid_backward_input_plain if plain else grid_backward_input
            dx = bwd_x(x, dy, params, levels, F, interp)
        return dparams, dx

    @staticmethod
    def backward(ctx, cgp, cgx):
        x, params, dy, levels, level_round, u = ctx.saved_tensors
        if cgp is None and cgx is None:
            return (None,) * 8
        cgp = None if cgp is None else cgp.contiguous()
        cgx = None if cgx is None else cgx.contiguous()
        if torch.is_grad_enabled():
            d_params, d_x, d_dy = GridEncodeBackwardBackwardFunction.apply(
                x, params, dy, levels, level_round, u, cgp, cgx, ctx.meta)
        else:
            d_params, d_x, d_dy = _double_backward(x, params, dy, levels, level_round, u, cgp, cgx, ctx.meta)
        need = ctx.needs_input_grad
        return (
            d_x if need[0] else None,
            d_params if need[1] else None,
            None if d_dy is None or not need[2] else d_dy.to(dy.dtype),
            None, None, None, None, None,
        )


class GridEncodeBackwardBackwardFunction(torch.autograd.Function):
    """The lookup's double backward as a differentiable function of (x,
    params, dL_dy, cgp, cgx): its forward is ``_double_backward`` (the G2
    kernel on the card, or its plain version with ``plain``); its backward,
    the third order, is ``_third_order`` (the G3 kernel, and the table
    gradient's kernels for a cotangent of the table gradient of uint32
    positions or of a sampled corner) or, where that backward must itself
    be differentiable (a fourth order), ``GridEncodeThirdOrderFunction``.

    ``GridEncodeBackwardBackwardFunction.apply(x, params, dL_dy, levels,
    level_round, u, cgp, cgx, meta)`` with ``GridEncodeFunction``'s ``meta``.
    """

    @staticmethod
    def forward(ctx, x, params, dy, levels, level_round, u, cgp, cgx, meta):
        ctx.meta = meta
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, params, dy, cgp, cgx, levels, level_round, u)
        return _double_backward(x, params, dy, levels, level_round, u, cgp, cgx, meta)

    @staticmethod
    def backward(ctx, g_params, g_x, g_dy):
        x, params, dy, cgp, cgx, levels, level_round, u = ctx.saved_tensors
        if g_params is None and g_x is None and g_dy is None:
            return (None,) * 9
        n = ctx.needs_input_grad
        need = (n[1], n[0], n[2], n[6], n[7])
        g_params, g_x, g_dy = (None if t is None else t.to(torch.float32).contiguous() for t in (g_params, g_x, g_dy))
        if torch.is_grad_enabled():
            out = GridEncodeThirdOrderFunction.apply(x, params, dy, levels, level_round, u, cgp, cgx, g_params, g_x,
                                                     g_dy, ctx.meta, need)
        else:
            out = _third_order(x, params, dy, levels, level_round, u, cgp, cgx, g_params, g_x, g_dy, ctx.meta, need)
        d_params, d_x, d_dy, d_cgp, d_cgx = out
        return (d_x, d_params, None if d_dy is None else d_dy.to(dy.dtype), None, None, None, d_cgp, d_cgx, None)


def _third_order(x, params, dy, levels, level_round, u, cgp, cgx, g_params, g_x, g_dy, meta, need):
    """The lookup's third derivatives: the gradients of <g_params, P> +
    <g_x, X> + <g_dy, Y>, (P, X, Y) = ``_double_backward``'s, as (d/dparams,
    d/dx, d/d(dL_dy), d/dcgp, d/dcgx), each None where it is zero or where
    ``need`` (in that order) says it is not wanted; from the kernels, or
    with ``plain`` in ``meta`` their plain versions. G2's terms take G3
    (``grid_backward3``); the cgp term of uint32 positions or of a sampled
    corner (``_cgp_term``: the lookup of cgp, or the gather of its sampled
    corners) is linear in cgp alone, so its one derivative is its
    transpose applied to g_dy, the table gradient of g_dy in the level's
    class (a dropped level's zero), with ``u`` the sampled one."""
    F, interp, plain, acc16, plan = meta
    d_cgp_alone = None
    if cgp is not None and (x.dtype != torch.float32 or u is not None):
        if need[3] and g_dy is not None:
            if plain:
                d_cgp_alone = grid_backward_plain(x, g_dy, levels, F, interp, level_round, u)
            else:
                d_cgp_alone = grid_backward(x, g_dy, levels, F, interp, level_round, plan, u)
        cgp = None
    if cgp is None and cgx is None:
        return None, None, None, d_cgp_alone, None
    if plain:
        out = grid_third_order_plain(x, dy, params, levels, F, interp, level_round, cgp, cgx, g_params, g_x, g_dy,
                                     need=need)
    else:
        out = grid_backward3(x, dy, params, levels, F, interp, level_round, cgp, cgx, g_params, g_x, g_dy, need,
                             acc16)
    d_params, d_x, d_dy, d_cgp, d_cgx = out
    return d_params, d_x, d_dy, d_cgp if d_cgp_alone is None else d_cgp_alone, d_cgx


class GridEncodeThirdOrderFunction(torch.autograd.Function):
    """The lookup's third order as a differentiable function of (x, params,
    dL_dy, cgp, cgx, g_params, g_x, g_dy): its forward is ``_third_order``
    (G3 on the card), its backward, the fourth order and every order after
    it, autograd of its plain version recomputed from the saved inputs
    (``grid_third_order_plain``, whose scatters are ``_ClassScatter``).

    ``GridEncodeThirdOrderFunction.apply(x, params, dL_dy, levels,
    level_round, u, cgp, cgx, g_params, g_x, g_dy, meta, need)``"""

    @staticmethod
    def forward(ctx, x, params, dy, levels, level_round, u, cgp, cgx, g_params, g_x, g_dy, meta, need):
        ctx.meta, ctx.need = meta, need
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, params, dy, cgp, cgx, g_params, g_x, g_dy, levels, level_round, u)
        return _third_order(x, params, dy, levels, level_round, u, cgp, cgx, g_params, g_x, g_dy, meta, need)

    @staticmethod
    def backward(ctx, *grads):
        x, params, dy, cgp, cgx, g_params, g_x, g_dy, levels, level_round, u = ctx.saved_tensors
        F, interp, plain, acc16, plan = ctx.meta
        n = ctx.needs_input_grad
        plain_meta = (F, interp, True, acc16, plan)

        def fn(xx, pp, yy, cp, cx, gp, gx, gy):
            return _third_order(xx, pp, yy, levels, level_round, u, cp, cx, gp, gx, gy, plain_meta, ctx.need)

        wanted = (n[0], n[1], n[2], n[6], n[7], n[8], n[9], n[10])
        d = _autograd_of(fn, (x, params, dy, cgp, cgx, g_params, g_x, g_dy), wanted, grads)
        return (d[0], d[1], d[2], None, None, None, d[3], d[4], d[5], d[6], d[7], None, None)
