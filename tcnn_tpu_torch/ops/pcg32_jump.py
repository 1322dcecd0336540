"""PCG32 jump-ahead on tensors (the grid's ``"Rng"`` hash; port of
``tcnn_tpu.ops.pcg32_jump``).

The reference's Rng grid hash (common_device.h:814-827) seeds a pcg32 with
1337, jumps it ahead by a per-vertex 64-bit step assembled from the grid
coordinates, and emits one uint32. torch on the CPU has no uint32 add,
shift or remainder and no uint64 at all, so the 64-bit LCG algebra runs on
(hi, lo) pairs of uint32 values held in int64 tensors, every product split
into 16-bit halves so that nothing overflows int64, every result masked to
32 bits (right shifts of int64 are arithmetic; the values here are never
negative). The jump's 64 per-bit (multiplier, increment) pairs are Python
integers; ``PCG32_JUMP_TABLE`` lists them for the CUDA kernels'
``__constant__`` copy (csrc/grid_common.cuh, checked against this list on
the CPU).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..rng import PCG32, PCG32_MULT

_M32 = 0xFFFFFFFF
_M16 = 0xFFFF
_MASK64 = (1 << 64) - 1
RNG_HASH_SEED = 1337


def jump_table(inc: int) -> List[Tuple[int, int]]:
    """The 64 (multiplier, increment) pairs of a jump by 2^bit steps of the
    LCG s' = PCG32_MULT s + inc (mod 2^64), bit 0 first."""
    out = []
    cur_mult, cur_plus = int(PCG32_MULT), int(inc)
    for _ in range(64):
        out.append((cur_mult, cur_plus))
        cur_plus = ((cur_mult + 1) * cur_plus) & _MASK64
        cur_mult = (cur_mult * cur_mult) & _MASK64
    return out


_BASE = PCG32(RNG_HASH_SEED)
PCG32_STATE0 = int(_BASE.state)
PCG32_INC = int(_BASE.inc)
PCG32_JUMP_TABLE = jump_table(PCG32_INC)


def _mul32x32_64(a: torch.Tensor, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of the 64-bit product of uint32 values ``a`` (int64 tensor)
    and ``b`` (a Python int or an int64 tensor)."""
    a0, a1 = a & _M16, a >> 16
    b0, b1 = b & _M16, b >> 16
    p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = (p00 >> 16) + (p01 & _M16) + (p10 & _M16)
    lo = (p00 & _M16) | ((mid & _M16) << 16)
    hi = (p11 + (p01 >> 16) + (p10 >> 16) + (mid >> 16)) & _M32
    return hi, lo


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2^32 of uint32 values."""
    return (a * (b & _M16) + (((a * (b >> 16)) & _M16) << 16)) & _M32


def _mul64_const(h: torch.Tensor, l: torch.Tensor, c: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h, l) * c mod 2^64 for a Python int ``c``."""
    cl, ch = c & _M32, (c >> 32) & _M32
    hi, lo = _mul32x32_64(l, cl)
    return (hi + _mul32(l, ch) + _mul32(h, cl)) & _M32, lo


def _add64(h, l, ch, cl) -> Tuple[torch.Tensor, torch.Tensor]:
    lo = l + cl
    return (h + ch + (lo >> 32)) & _M32, lo & _M32


def pcg32_jump_output(delta_hi: torch.Tensor, delta_lo: torch.Tensor) -> torch.Tensor:
    """For each element, ``pcg32(1337).advance(delta).next_uint()``:
    ``delta_hi``/``delta_lo`` are the halves of the 64-bit step as uint32
    values in int64 tensors of one shape; returns the uint32 outputs as
    int64."""
    acc_mult_h = torch.zeros_like(delta_hi)
    acc_mult_l = torch.ones_like(delta_lo)
    acc_plus_h = torch.zeros_like(delta_hi)
    acc_plus_l = torch.zeros_like(delta_lo)
    for bit, (mult, plus) in enumerate(PCG32_JUMP_TABLE):
        half = delta_lo if bit < 32 else delta_hi
        take = ((half >> (bit % 32)) & 1) != 0
        nm_h, nm_l = _mul64_const(acc_mult_h, acc_mult_l, mult)
        np_h, np_l = _mul64_const(acc_plus_h, acc_plus_l, mult)
        np_h, np_l = _add64(np_h, np_l, (plus >> 32) & _M32, plus & _M32)
        acc_mult_h = torch.where(take, nm_h, acc_mult_h)
        acc_mult_l = torch.where(take, nm_l, acc_mult_l)
        acc_plus_h = torch.where(take, np_h, acc_plus_h)
        acc_plus_l = torch.where(take, np_l, acc_plus_l)
    # state = acc_mult * state0 + acc_plus (mod 2^64)
    s_h, s_l = _mul64_const(acc_mult_h, acc_mult_l, PCG32_STATE0)
    s_h, s_l = _add64(s_h, s_l, acc_plus_h, acc_plus_l)
    # The output permutation of the jumped state, which next_uint() reads as
    # its old state: xorshifted = ((s >> 18) ^ s) >> 27, rot = s >> 59.
    x_h = (s_h >> 18) ^ s_h
    x_l = (((s_l >> 18) | (s_h << 14)) & _M32) ^ s_l
    xorshifted = ((x_l >> 27) | (x_h << 5)) & _M32
    rot = s_h >> 27
    return ((xorshifted >> rot) | (xorshifted << ((32 - rot) & 31))) & _M32


def rng_step(corner: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The jump of the Rng hash for grid vertices ``corner`` (..., d) of
    uint32 values in int64: the XOR of coordinate i shifted to bit i *
    (64 // d) of a 64-bit value, as (hi, lo) halves."""
    d = corner.shape[-1]
    n_bits = 64 // d
    lo = torch.zeros(corner.shape[:-1], dtype=torch.int64, device=corner.device)
    hi = torch.zeros_like(lo)
    for i in range(d):
        v, shift = corner[..., i], i * n_bits
        if shift < 32:
            lo = lo ^ ((v << shift) & _M32)
            if shift:
                hi = hi ^ (v >> (32 - shift))
        else:
            hi = hi ^ ((v << (shift - 32)) & _M32)
    return hi, lo


def rng_hash(corner: torch.Tensor) -> torch.Tensor:
    """The Rng hash of grid vertices ``corner`` (..., d), uint32 values in
    int64 (reference: common_device.h:814-827)."""
    return pcg32_jump_output(*rng_step(corner))
