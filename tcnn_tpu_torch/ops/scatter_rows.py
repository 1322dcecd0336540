"""Row scatter-add with per-contribution rounding: the CUDA kernel's wrapper
and its plain version.

Replaces the Pallas scatters of ``tcnn_tpu/ops/scatter_rows.py``:
``scatter_rows_factored_pallas`` (pair, single or stochastic bf16 rounding,
fp32 sums), ``scatter_rows_onehot`` (bf16 operands, fp32 sums) and
``scatter_rows_serial`` (fp32). All of them compute ``out[idx[n], :] +=
round(rows[n, :])``; what tells them apart is the rounding class: how each
contribution is rounded (``CONTRIB_*``: none, round-to-nearest bf16, or
value-hashed stochastic bf16) and where the sum accumulates (``ACC_*``:
fp32, or bf16 with a rounding at every add). The kernel
(``csrc/grid_bwd.cu:tcnn_scatter_rows``) adds every contribution
atomically; the grid encoding's table gradient (``ops.grid_encode``) is
built on the same device functions.

The JAX pair class (a compensated bf16 pair, fp32 to about 3e-6 relative)
is the fp32 class here. fp32 atomics make the last bits of each sum depend
on the order of the adds; the stochastic rounding depends only on the
contribution's own bits, so it is deterministic once the fp32 contribution
is.

``scatter_rows`` dispatches on the device of ``rows``: a CPU tensor takes
``scatter_rows_plain``, a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from .grid_encode import _M32, _mul32

# Launches of the CUDA kernel (incremented once per launch, nowhere else).
LAUNCHES = 0

# Contribution rounding (csrc/grid_bwd.cu switches on the same values).
CONTRIB_NONE = 0
CONTRIB_RN = 1  # round to nearest bf16
CONTRIB_SR = 2  # value-hashed stochastic bf16
# Accumulation.
ACC_F32 = 0
ACC_BF16 = 1
ACC_DROP = 2  # no sum: the result is zero

_ACC_CODES = {torch.float32: ACC_F32, torch.bfloat16: ACC_BF16}


def sr_round_bits(bits: torch.Tensor) -> torch.Tensor:
    """``tcnn_tpu/ops/scatter_rows.py:_sr_round_bits`` on uint32 values held
    in int64 (torch has no uint32 multiply on the CPU): a murmur-style hash
    of the fp32 bit pattern gives a 16-bit dither, added below the bf16 cut
    with 32-bit wrap-around, then the low 16 bits are cleared."""
    h = _mul32(bits, 0x9E3779B9)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x85EBCA6B)
    return ((bits + (h >> 16)) & _M32) & 0xFFFF0000


def _u32_of(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32).to(torch.int64) & _M32


def _f32_of(bits: torch.Tensor) -> torch.Tensor:
    return torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32).view(torch.float32)


def round_contributions(v: torch.Tensor, contrib_round: int) -> torch.Tensor:
    """fp32 ``v`` rounded by a contribution class; the result is fp32 (for
    the bf16 classes, bf16-valued)."""
    v = v.to(torch.float32)
    if contrib_round == CONTRIB_RN:
        return v.to(torch.bfloat16).to(torch.float32)
    if contrib_round == CONTRIB_SR:
        return _f32_of(sr_round_bits(_u32_of(v)))
    if contrib_round != CONTRIB_NONE:
        raise ValueError(f"unknown contribution rounding {contrib_round}")
    return v


def scatter_rows_plain(
    idx: torch.Tensor,
    rows: torch.Tensor,
    size: int,
    contrib_round: int = CONTRIB_NONE,
    acc_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """(size, R) fp32: the rounded rows added at their index with
    ``index_add_`` in ``acc_dtype`` (fp32 or bf16), in sequence."""
    r_width = rows.shape[1]
    contrib = round_contributions(rows, contrib_round)
    out = torch.zeros((int(size), r_width), dtype=acc_dtype, device=rows.device)
    out.index_add_(0, idx.to(torch.int64), contrib.to(acc_dtype))
    return out.to(torch.float32)


_SCATTER_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int64] + [ctypes.c_int] * 2 + [
    ctypes.c_void_p
]


def scatter_rows(
    idx: torch.Tensor,
    rows: torch.Tensor,
    size: int,
    contrib_round: int = CONTRIB_NONE,
    acc_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """``out[idx[n], :] += round(rows[n, :])`` into a (size, R) fp32 result.
    ``idx`` (N,) int32 in [0, size) (the kernel skips rows outside; the plain
    version raises on them), ``rows`` (N, R) fp32."""
    if rows.device.type == "cpu":
        return scatter_rows_plain(idx, rows, size, contrib_round, acc_dtype)
    if rows.device.type != "cuda":
        raise ValueError(f"scatter_rows: unsupported device {rows.device}")
    if rows.dim() != 2 or rows.dtype != torch.float32 or not rows.is_contiguous():
        raise ValueError("scatter_rows: rows must be a contiguous 2-D float32 tensor")
    if idx.shape != rows.shape[:1] or idx.dtype != torch.int32 or idx.device != rows.device or not idx.is_contiguous():
        raise ValueError("scatter_rows: idx must be a contiguous (N,) int32 tensor on the device of rows")
    if contrib_round not in (CONTRIB_NONE, CONTRIB_RN, CONTRIB_SR) or acc_dtype not in _ACC_CODES:
        raise ValueError(f"scatter_rows: unsupported class ({contrib_round}, {acc_dtype})")
    size = int(size)
    out = torch.empty((size, rows.shape[1]), dtype=torch.float32, device=rows.device)
    acc = _ACC_CODES[acc_dtype]
    out16 = torch.empty((size, rows.shape[1]), dtype=torch.bfloat16, device=rows.device) if acc == ACC_BF16 else None
    global LAUNCHES
    from ._build import kernel

    err = kernel("grid_bwd", "tcnn_scatter_rows", _SCATTER_ARGS)(
        idx.data_ptr(), rows.data_ptr(), out.data_ptr(), None if out16 is None else out16.data_ptr(),
        rows.shape[0], rows.shape[1], size, contrib_round, acc,
        torch.cuda.current_stream(rows.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"scatter_rows: CUDA launch failed (cudaError {err})")
    LAUNCHES += 1
    return out


def scatter_rows_onehot(idx: torch.Tensor, rows: torch.Tensor, size: int) -> torch.Tensor:
    """The class of ``scatter_rows_onehot`` (JAX :68): bf16 operands, fp32
    sums."""
    return scatter_rows(idx, rows, size, CONTRIB_RN, torch.float32)


def scatter_rows_serial(idx: torch.Tensor, rows: torch.Tensor, size: int) -> torch.Tensor:
    """The class of ``scatter_rows_serial`` (JAX :133): fp32 throughout."""
    return scatter_rows(idx, rows, size, CONTRIB_NONE, torch.float32)


_FACTORED_ROUNDING = {"pair": CONTRIB_NONE, "single": CONTRIB_RN, "sr": CONTRIB_SR}


def scatter_rows_factored(idx: torch.Tensor, rows: torch.Tensor, size: int, rounding: str = "pair") -> torch.Tensor:
    """The classes of ``scatter_rows_factored_pallas`` (JAX :259): "pair"
    (fp32), "single" (bf16 contributions) or "sr" (stochastic bf16
    contributions), fp32 sums."""
    if rounding not in _FACTORED_ROUNDING:
        raise ValueError(f"rounding must be pair/single/sr, got {rounding!r}")
    return scatter_rows(idx, rows, size, _FACTORED_ROUNDING[rounding], torch.float32)
