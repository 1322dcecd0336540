"""Multiresolution grid lookup and its table gradient: the CUDA kernels'
wrappers, their plain versions and the autograd Function that binds them.

The lookup kernel (``csrc/grid_fwd.cu``) covers every level in one launch,
one thread per (sample, level). Its plain version ``grid_encode_plain`` is a
vectorised torch lookup level by level. The backward kernel
(``csrc/grid_bwd.cu:tcnn_grid_backward``) recomputes each (sample, level)'s
corners the same way and adds the rounded contributions atomically into the
table gradient; its plain version is ``grid_backward_plain``. All of them
read the same description of the grid: the (n_levels, 24) int32 level table
built by ``level_table``; the backward also reads the per-level gradient
rounding classes (``ops.scatter_rows`` codes).

Index arithmetic is uint32 with wrap-around, as in the JAX package
(``tcnn_tpu/encodings/grid.py:_grid_hash`` and the affine corner fold).
torch has no uint32 add/shift/remainder on the CPU, so the plain version
holds uint32 values in int64 and masks to 32 bits after every add; its
products are split so they never overflow int64 (``_mul32``).

``grid_encode`` and ``grid_backward`` dispatch on the device of ``x``: a CPU
tensor takes the plain version, a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

# Launches of the CUDA kernels (each incremented once per launch of its
# wrapper's kernel, nowhere else): the lookup and the table gradient.
LAUNCHES = 0
BWD_LAUNCHES = 0

# Level index modes (csrc/grid_fwd.cu switches on the same values).
MODE_FOLD = 0  # affine: (sum_d uint32(pos_grid_d + bit_d) * stride_d) mod size
MODE_QUAD = 1  # affine: (base mod size + corner delta mod size) mod size
MODE_XOR = 2  # Prime / CoherentPrime / ReversedPrime hash
MODE_BASECONVERT = 3

INTERP_NEAREST = 0
INTERP_LINEAR = 1
INTERP_SMOOTHSTEP = 2

ROUND_NONE = 0
ROUND_FP16 = 1
ROUND_BF16 = 2
_ROUND_DTYPES = {ROUND_FP16: torch.float16, ROUND_BF16: torch.bfloat16}

MAX_DIMS = 10
MAX_FEATURES = 8
_LEVEL_COLS = 4 + 2 * MAX_DIMS
_M32 = 0xFFFFFFFF
_BASE_CONVERT_FACTOR = 2531011


def level_table(
    offsets: Sequence[int],
    sizes: Sequence[int],
    modes: Sequence[int],
    scales: Sequence[float],
    strides: Sequence[Sequence[int]],
) -> np.ndarray:
    """The (n_levels, 24) int32 level table: per level the row offset, the
    row count, the index mode, the fp32 scale (bit pattern), the per-dim
    factors masked to 32 bits and the per-dim factors mod the level size.
    ``strides[l]`` are the exact (unmasked) per-dim factors of level l."""
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
    return t.view(np.int32)


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2^32 for int64 ``a`` in [0, 2^32) and ``b`` in [0, 2^32),
    without overflowing int64: b is split into 16-bit halves."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _level_rows(
    x: torch.Tensor, row: np.ndarray, interpolation: int, bits_np: np.ndarray
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One level's corners for every sample: (table row (B, C) int64,
    weight (B, C) fp32), from the level's row of the level table."""
    batch, d = x.shape
    dev = x.device
    offset, size, mode = int(row[0]), int(row[1]), int(row[2])
    scale = float(np.int64(row[3]).astype(np.uint32).view(np.float32))
    s32 = [int(v) for v in row[4 : 4 + d]]
    smod = [int(v) for v in row[4 + MAX_DIMS : 4 + MAX_DIMS + d]]
    bits = torch.from_numpy(bits_np).to(dev)  # (C, d)
    # x * scale is exact in double and rounds once to fp32: the same
    # value as the fp32 product; the +0.5 is a separate fp32 add.
    pos = x * scale + 0.5
    pos_floor = torch.floor(pos)
    pos_grid = pos_floor.to(torch.int32).to(torch.int64)  # (B, d)
    t = pos - pos_floor
    if interpolation == INTERP_SMOOTHSTEP:
        t = t * t * (3.0 - 2.0 * t)
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
    return idx + offset, weights


def _corner_bits(d: int, interpolation: int) -> np.ndarray:
    n_corners = 1 if interpolation == INTERP_NEAREST else 2**d
    return np.asarray([[(c >> k) & 1 for k in range(d)] for c in range(n_corners)], np.int64)


def grid_encode_plain(
    x: torch.Tensor,
    params: torch.Tensor,
    levels: torch.Tensor,
    n_features_per_level: int,
    padded_width: int,
    interpolation: int,
    table_round: int,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """Plain torch lookup. ``x`` (B, d) fp32, ``params`` the flat fp32 grid
    parameters, ``levels`` the level table (any device). Returns (B,
    padded_width) in ``out_dtype``."""
    batch, d = x.shape
    F = int(n_features_per_level)
    table = params.view(-1, F)
    lt = levels.cpu().numpy().view(np.uint32).astype(np.int64)
    bits_np = _corner_bits(d, interpolation)
    outs = []
    for row in lt:
        idx, weights = _level_rows(x, row, interpolation, bits_np)
        feats = table[idx]  # (B, C, F)
        if table_round != ROUND_NONE:
            feats = feats.to(_ROUND_DTYPES[table_round]).to(torch.float32)
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
) -> torch.Tensor:
    """Plain table gradient: (n_rows * F,) fp32 for the flat grid
    parameters, where n_rows is the table size the level table describes.
    Per level, the contributions w_c * dL_dy[:, lvl*F:(lvl+1)*F] (fp32) are
    rounded by the level's class in ``level_round`` ((L, 2): contribution
    rounding, accumulation; ``ops.scatter_rows`` codes) and added with
    ``scatter_rows_plain``. A ``table_dtype`` rounding on read does not enter
    the backward (straight-through, as the JAX package's linear pair)."""
    from .scatter_rows import ACC_BF16, ACC_DROP, scatter_rows_plain

    batch, d = x.shape
    F = int(n_features_per_level)
    lt = levels.cpu().numpy().view(np.uint32).astype(np.int64)
    classes = level_round.cpu().numpy().reshape(-1, 2)
    bits_np = _corner_bits(d, interpolation)
    grad = torch.zeros((_table_rows(lt), F), dtype=torch.float32, device=x.device)
    g = dL_dy.to(torch.float32)
    for lvl, row in enumerate(lt):
        contrib_round, acc = (int(v) for v in classes[lvl])
        if acc == ACC_DROP:
            continue
        offset, size = int(row[0]), int(row[1])
        idx, weights = _level_rows(x, row, interpolation, bits_np)
        contrib = weights[..., None] * g[:, None, lvl * F : (lvl + 1) * F]  # (B, C, F)
        acc_dtype = torch.bfloat16 if acc == ACC_BF16 else torch.float32
        grad[offset : offset + size] += scatter_rows_plain(
            (idx - offset).reshape(-1), contrib.reshape(-1, F), size, contrib_round, acc_dtype
        )
    return grad.reshape(-1)


def _lib():
    from ._build import load_library

    lib = load_library("grid_fwd")
    if not getattr(lib, "_tcnn_bound", False):
        fn = lib.tcnn_grid_forward
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib._tcnn_bound = True
    return lib


def _bwd_lib():
    from ._build import load_library

    lib = load_library("grid_bwd")
    if not getattr(lib, "_tcnn_grid_bwd_bound", False):
        fn = lib.tcnn_grid_backward
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib._tcnn_grid_bwd_bound = True
    return lib


def _check_kernel_inputs(what: str, x: torch.Tensor, levels: torch.Tensor, n_features_per_level: int):
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{what}: x must be a contiguous 2-D float32 tensor")
    if levels.dtype != torch.int32 or levels.shape[1:] != (_LEVEL_COLS,) or levels.device != x.device:
        raise ValueError(f"{what}: levels must be the (L, 24) int32 level table on the device of x")
    if not 1 <= x.shape[1] <= MAX_DIMS or not 1 <= int(n_features_per_level) <= MAX_FEATURES:
        raise ValueError(f"{what}: unsupported shape (dims {x.shape[1]}, features per level {n_features_per_level})")


def grid_encode(
    x: torch.Tensor,
    params: torch.Tensor,
    levels: torch.Tensor,
    n_features_per_level: int,
    padded_width: int,
    interpolation: int,
    table_round: int = ROUND_NONE,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """All-levels grid lookup. On a CUDA ``x`` the kernel runs; ``levels``
    must then be the level table on that device."""
    if x.device.type == "cpu":
        return grid_encode_plain(
            x, params, levels, n_features_per_level, padded_width, interpolation, table_round, out_dtype
        )
    if x.device.type != "cuda":
        raise ValueError(f"grid_encode: unsupported device {x.device}")
    _check_kernel_inputs("grid_encode", x, levels, n_features_per_level)
    if params.dim() != 1 or params.dtype != torch.float32 or not params.is_contiguous() or params.device != x.device:
        raise ValueError("grid_encode: params must be a contiguous 1-D float32 tensor on the device of x")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"grid_encode: the kernel writes bfloat16 or float32, not {out_dtype}")
    F = int(n_features_per_level)
    batch, d = x.shape
    n_levels = levels.shape[0]
    if padded_width < n_levels * F:
        raise ValueError(f"grid_encode: output width {padded_width} < {n_levels} levels x {F} features")
    out = torch.empty((batch, padded_width), dtype=out_dtype, device=x.device)
    if batch == 0:
        return out
    global LAUNCHES
    err = _lib().tcnn_grid_forward(
        x.data_ptr(), params.data_ptr(), levels.data_ptr(), out.data_ptr(),
        batch, d, n_levels, F, padded_width, int(interpolation), int(table_round),
        int(out_dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"grid_encode: CUDA launch failed (cudaError {err})")
    LAUNCHES += 1
    return out


def grid_backward(
    x: torch.Tensor,
    dL_dy: torch.Tensor,
    levels: torch.Tensor,
    n_features_per_level: int,
    interpolation: int,
    level_round: torch.Tensor,
    n_values: Optional[int] = None,
    accumulates_bf16: Optional[bool] = None,
) -> torch.Tensor:
    """Table gradient of the all-levels lookup: (n_rows * F,) fp32 for the
    flat grid parameters, for the output gradient ``dL_dy`` (B, width >= L*F)
    in bf16 or fp32. On a CUDA ``x``, ``levels`` and ``level_round`` ((L, 2)
    int32 classes) must lie on that device. ``n_values`` (the length of the
    result) and ``accumulates_bf16`` (whether a level's class sums in bf16)
    describe those two tables; a caller that knows them passes them, which
    saves reading the tables back from the device."""
    if x.device.type == "cpu":
        return grid_backward_plain(x, dL_dy, levels, n_features_per_level, interpolation, level_round)
    if x.device.type != "cuda":
        raise ValueError(f"grid_backward: unsupported device {x.device}")
    _check_kernel_inputs("grid_backward", x, levels, n_features_per_level)
    from .scatter_rows import ACC_BF16

    F = int(n_features_per_level)
    batch, d = x.shape
    n_levels = levels.shape[0]
    if (
        dL_dy.dim() != 2 or dL_dy.shape[0] != batch or dL_dy.shape[1] < n_levels * F
        or dL_dy.dtype not in (torch.bfloat16, torch.float32) or dL_dy.device != x.device
        or not dL_dy.is_contiguous()
    ):
        raise ValueError(f"grid_backward: dL_dy must be a contiguous ({batch}, >= {n_levels * F}) bfloat16 or float32 tensor on the device of x")
    if level_round.shape != (n_levels, 2) or level_round.dtype != torch.int32 or level_round.device != x.device:
        raise ValueError("grid_backward: level_round must be the (L, 2) int32 class table on the device of x")
    if n_values is None:
        n_values = _table_rows(levels.cpu().numpy().view(np.uint32).astype(np.int64)) * F
    if accumulates_bf16 is None:
        accumulates_bf16 = bool((level_round[:, 1] == ACC_BF16).any())
    grad = torch.empty(n_values, dtype=torch.float32, device=x.device)
    grad16 = torch.empty(n_values, dtype=torch.bfloat16, device=x.device) if accumulates_bf16 else None
    global BWD_LAUNCHES
    err = _bwd_lib().tcnn_grid_backward(
        x.data_ptr(), dL_dy.data_ptr(), levels.data_ptr(), level_round.data_ptr(), grad.data_ptr(),
        None if grad16 is None else grad16.data_ptr(),
        batch, d, n_levels, F, dL_dy.shape[1], int(interpolation), int(dL_dy.dtype == torch.bfloat16),
        n_values, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"grid_backward: CUDA launch failed (cudaError {err})")
    BWD_LAUNCHES += 1
    return grad


class GridEncodeFunction(torch.autograd.Function):
    """The all-levels lookup, differentiable with respect to the flat grid
    parameters only: the forward is ``grid_encode``, the backward
    ``grid_backward``, or with ``plain`` their plain versions on any device.
    ``x`` gets no gradient (the encoding refuses inputs that need one).

    ``GridEncodeFunction.apply(x, params, levels, level_round, meta)`` with
    ``meta`` = (n_features_per_level, padded_width, interpolation,
    table_round, out_dtype, plain, accumulates_bf16).
    """

    @staticmethod
    def forward(ctx, x, params, levels, level_round, meta):
        F, padded_width, interp, table_round, out_dtype, plain, acc16 = meta
        ctx.meta = (F, interp, plain, params.numel(), acc16)
        ctx.save_for_backward(x, levels, level_round)
        fwd = grid_encode_plain if plain else grid_encode
        return fwd(x, params, levels, F, padded_width, interp, table_round, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        if torch.is_grad_enabled():
            raise NotImplementedError(
                "GridEncodeFunction: the grid encoding has no double backward yet "
                "(ROADMAP.md, Queue 1 item 4: module API and second order)"
            )
        x, levels, level_round = ctx.saved_tensors
        F, interp, plain, n_values, acc16 = ctx.meta
        dy = dy.contiguous()
        if plain:
            dparams = grid_backward_plain(x, dy, levels, F, interp, level_round)
        else:
            dparams = grid_backward(x, dy, levels, F, interp, level_round, n_values, acc16)
        return None, dparams, None, None, None
