"""Host launch plans shared by the row kernels: the card's limits, the
vector width and grid rules, and the plan object whose int32 array a C
entry point reads.

Used by the row scatter (``ops.scatter_rows.scatter_rows_plan``) and the
memory probes (``ops.probe_rows.gather_plan`` / ``scatter_plan``); no
kernel of its own.
"""

from __future__ import annotations

import ctypes

import torch

N_SMS = 132  # SMs of an H100 SXM: the plans' default card
THREADS = 256  # threads a block of the grid-stride row kernels
PRIVATE_THREADS = 1024  # threads a block of a private scatter (at most two blocks an SM)
SM_THREADS = 2048  # resident threads an SM holds
SM_BLOCKS = 32  # resident blocks an SM holds
SM_SHARED_BYTES = 228 * 1024  # shared memory of one SM (a block may take SHARED_BYTES of it)
# Dynamic shared memory a block may use on sm_90 (232,448 bytes).
SHARED_BYTES = 227 * 1024
FLUSH_SHARE = 8  # a private scatter's flush atomics are at most 1 / FLUSH_SHARE of its adds


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def vec_width(n: int, align: int) -> int:
    """The widest of 4, 2, 1 floats that divides ``n`` and whose bytes
    divide the pointers' alignment ``align``."""
    return next(v for v in (4, 2, 1) if n % v == 0 and align % (4 * v) == 0)


def pow2_shift(n: int) -> int:
    """log2(n) for a power of two, else -1."""
    return n.bit_length() - 1 if n > 0 and n & (n - 1) == 0 else -1


def resident_blocks(threads: int, smem_bytes: int = 0) -> int:
    """Blocks of ``threads`` threads and ``smem_bytes`` of shared memory that
    one SM holds at once."""
    per_sm = min(SM_BLOCKS, SM_THREADS // threads)
    if smem_bytes:
        per_sm = min(per_sm, SM_SHARED_BYTES // (smem_bytes + 1024))  # 1 KB reserved a block
    return max(1, per_sm)


def stride_grid(items: int, threads: int, n_sms: int, smem_bytes: int = 0) -> int:
    """Blocks for a grid-stride loop over ``items``: one item a thread, at
    most what the card holds at once (0 for no item)."""
    return min(ceil_div(items, threads), n_sms * resident_blocks(threads, smem_bytes)) if items > 0 else 0


def alignment(t: torch.Tensor) -> int:
    """The alignment of ``t``'s data pointer in bytes, up to 16."""
    ptr = t.data_ptr()
    return 16 if ptr == 0 else min(16, ptr & -ptr)


_SMS = {}


def sm_count(index: int) -> int:
    """The SM count of device ``index``, read once (7.9 us a call)."""
    n = _SMS.get(index)
    if n is None:
        n = _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return n


class Plan:
    """A launch plan: its fields by name and, as ``args`` (at address
    ``args_ptr``), the int32 array the C entry point reads, built once with
    the plan."""

    FIELDS: tuple = ()

    def __init__(self, **fields):
        for name in self.FIELDS:
            setattr(self, name, int(fields[name]))
        self.args = (ctypes.c_int32 * len(self.FIELDS))(*(getattr(self, n) for n in self.FIELDS))
        self.args_ptr = ctypes.addressof(self.args)

    def __repr__(self):
        return f"{type(self).__name__}({', '.join(f'{n}={getattr(self, n)}' for n in self.FIELDS)})"
