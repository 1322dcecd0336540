"""Random row gather and scatter-add probes: the CUDA kernels' wrappers and
their plain versions.

Replaces the Pallas probes of the JAX package's benchmarks, which measured
how fast a TPU gathers random table rows and scatter-adds rows into a table
(VMEM residency, scalar prefetch, DMA, sublane alignment, lane-gather
select trees): ``benchmarks/probe_mosaic_gather.py`` (P1-P4),
``probe_mosaic_gather2.py`` (P5), ``probe_r5_pallas_gather2.py`` (P6-P11),
``probe_r5_pallas_gather3.py`` (P12-P18). ``probe_fk_bisect.py`` (P19) is a
bf16-rounded row scatter, the RN class of ``ops.scatter_rows``. On this card
the same question is asked of where the table is read from and how many
rows are in flight (``csrc/probe_rows.cu``):

- ``probe_gather``: in the modes ``MODE_*`` and from the sources
  ``SOURCE_*``: L2 (``__ldg``; a warp owns 32 x ``unroll`` rows, 4 a
  thread by default, lane l rows l + 32 u, every row one vector load before
  any store; LANE: 4 lanes of a row a thread), SHARED
  (each block first stages the whole table in shared memory, only where it
  fits: the wrapper raises otherwise) or ASYNC (``cp.async`` of
  ``in_flight`` rows into a shared ring per block, then their stores).
- ``probe_scatter``: ``OP_ADD`` with one vector atomic (float2 / float4)
  per row chunk straight into the result (``ACC_GLOBAL``), or, for
  ``ACC_SHARED`` where there are enough rows a slot, into per-block
  shared-memory copies of the whole (S, R) table flushed once per non-zero
  float4; ``OP_STORE_LAST`` writes, per slot, the row of the largest index
  that reaches it (one ``atomicMax`` pass, then the write): a serial
  loop's last write.
- ``probe_gather_dot``: ``table[idx] @ w`` with ``w`` (F, 128), the gather
  and the product in one kernel, fp32 multiply-adds in registers.

The host functions ``gather_plan`` and ``scatter_plan`` decide each
launch (vector width from F or R and the pointers' alignment, rows a
thread, grid, private blocks, shared bytes); the C entry points read the
plan's int32 array. The kernels index rows in 32 bits (B, N x R and S
below 2^31).

Rows that a TPU probe leaves unwritten (P13 writes row 0 of each 8-row
block, P14 only the slots its indices reach) are zero here; the checks
compare only the rows the probe defines. Each wrapper runs its plain
version for a CPU tensor, and launches its kernel or raises for a CUDA one.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import kernel, stream
from ._plans import (FLUSH_SHARE, N_SMS, PRIVATE_THREADS, SHARED_BYTES, THREADS, Plan, alignment, ceil_div,
                     pow2_shift, resident_blocks, sm_count, stride_grid, vec_width)

# Launches of the CUDA kernels (incremented once per launch, nowhere else).
GATHER_LAUNCHES = 0
SCATTER_LAUNCHES = 0
DOT_LAUNCHES = 0

# Gather modes (csrc/probe_rows.cu switches on the same values).
MODE_ROW = 0  # out[b] = table[idx[b]]; an index outside [0, S) reads zeros
MODE_LANE = 1  # out[b, l] = table[idx[b, l], l]
MODE_WINDOW = 2  # out[8i + u] = table[a_i + u], a_i = idx[8i] (aligned: idx[8i] & ~7)
MODE_TILE_SUM = 3  # out[8g] = sum over tile g of table[idx[b]] in order; other rows 0
MODE_COPY = 4  # out[b] = table[b % TILE]
MODE_NAMES = {MODE_ROW: "row", MODE_LANE: "lane", MODE_WINDOW: "window", MODE_TILE_SUM: "tile_sum",
              MODE_COPY: "copy"}

SOURCE_L2 = 0
SOURCE_SHARED = 1
SOURCE_ASYNC = 2
SOURCE_NAMES = {SOURCE_L2: "l2", SOURCE_SHARED: "shared", SOURCE_ASYNC: "async"}

# Flags of probe_gather.
FLAG_ROUND_BF16 = 1  # round each value to bf16 (RN) and back
FLAG_FEATURE_MAJOR = 2  # output (B / TILE, F, TILE) instead of (B, F)
FLAG_TRANSPOSED = 4  # the table is given as (F, S)
FLAG_ALIGNED = 8  # MODE_WINDOW starts at idx[8i] & ~7

OP_ADD = 0
OP_STORE_LAST = 1
ACC_GLOBAL = 0
ACC_SHARED = 1

TILE = 2048  # rows per tile of MODE_TILE_SUM / MODE_COPY / feature-major output (the probes' TILE)
DOT_COLS = 128


def fits_shared(n_floats: int) -> bool:
    """Whether ``n_floats`` fp32 values fit in one block's shared memory."""
    return 4 * int(n_floats) <= SHARED_BYTES


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------
def _rows_or_zero(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``table[rows]`` with zeros for rows outside [0, S) (``fill_value``)."""
    valid = (rows >= 0) & (rows < table.shape[0])
    out = table[torch.where(valid, rows, torch.zeros_like(rows)).long()]
    return torch.where(valid.reshape(valid.shape + (1,) * (out.dim() - valid.dim())), out, torch.zeros_like(out))


def probe_gather_plain(
    table: torch.Tensor,
    idx: torch.Tensor,
    mode: int = MODE_ROW,
    table2: torch.Tensor = None,
    flags: int = 0,
) -> torch.Tensor:
    """The plain version of ``probe_gather`` (any source computes the same)."""
    if flags & FLAG_TRANSPOSED:
        table = table.t()
    S, F = table.shape
    if mode == MODE_ROW:
        out = _rows_or_zero(table, idx)
        if table2 is not None:
            odd = (torch.arange(idx.shape[0], device=idx.device) % 2 == 1)[:, None]
            out = torch.where(odd, _rows_or_zero(table2, idx), out)
    elif mode == MODE_LANE:
        valid = (idx >= 0) & (idx < S)
        out = torch.gather(table, 0, torch.where(valid, idx, torch.zeros_like(idx)).long())
        out = torch.where(valid, out, torch.zeros_like(out))
    elif mode == MODE_WINDOW:
        start = idx[::8]
        if flags & FLAG_ALIGNED:
            start = start & ~7
        rows = (start[:, None] + torch.arange(8, device=idx.device, dtype=idx.dtype)).reshape(-1)
        out = _rows_or_zero(table, rows)
    elif mode == MODE_TILE_SUM:
        rows = _rows_or_zero(table, idx).reshape(-1, TILE, F)
        acc = torch.zeros_like(rows[:, 0])
        for i in range(TILE):  # in order, as the probe's loop
            acc = acc + rows[:, i]
        out = torch.zeros((rows.shape[0], 8, F), dtype=table.dtype, device=table.device)
        out[:, 0] = acc
        out = out.reshape(-1, F)
    elif mode == MODE_COPY:
        out = table[torch.arange(idx.shape[0], device=idx.device) % TILE]
    else:
        raise ValueError(f"probe_gather: unknown mode {mode}")
    if flags & FLAG_ROUND_BF16:
        out = out.to(torch.bfloat16).to(torch.float32)
    if flags & FLAG_FEATURE_MAJOR:
        out = out.reshape(-1, TILE, F).transpose(1, 2).contiguous()
    return out


def probe_scatter_plain(idx: torch.Tensor, rows: torch.Tensor, size: int, op: int = OP_ADD) -> torch.Tensor:
    """The plain version of ``probe_scatter``: ``index_add_`` for ADD; for
    STORE_LAST the largest row index of each slot (``scatter_reduce``
    amax), then its row. Indices outside [0, size) are skipped."""
    size = int(size)
    valid = (idx >= 0) & (idx < size)
    j = torch.nonzero(valid).reshape(-1)
    slot = idx[j].long()
    out = torch.zeros((size, rows.shape[1]), dtype=torch.float32, device=rows.device)
    if op == OP_ADD:
        return out.index_add_(0, slot, rows[j])
    if op != OP_STORE_LAST:
        raise ValueError(f"probe_scatter: unknown op {op}")
    winner = torch.full((size,), -1, dtype=torch.int64, device=rows.device)
    winner.scatter_reduce_(0, slot, j, "amax")
    hit = winner >= 0
    out[hit] = rows[winner[hit]]
    return out


def probe_gather_dot_plain(table: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``table[idx] @ w`` (rows outside the table read zeros)."""
    return _rows_or_zero(table, idx) @ w


# ---------------------------------------------------------------------------
# Launch plans: host functions, reached by the CPU tests
# ---------------------------------------------------------------------------
SHARED_THREADS = 1024  # threads a block of the SHARED gather (one block an SM)
ROWS_PER_THREAD = 4  # the L2 gather's rows a thread (a warp's: 32 x 4)
TILE_SHIFT = TILE.bit_length() - 1


class GatherPlan(Plan):
    """How ``tcnn_probe_gather`` runs one call (``csrc/probe_rows.cu``,
    ``GatherArg``): ``vec`` floats a vector access, ``rows`` rows a thread
    (L2 ROW/WINDOW/COPY: a warp takes 32 x rows, lane l rows l + 32 u),
    ``per_row`` threads a row (LANE: quads of 4 lanes) and its log2
    (``per_row_shift``, -1 when no power of two), blocks of ``threads``,
    ``grid`` blocks and ``smem_bytes`` of dynamic shared memory."""

    FIELDS = ("B", "S", "F", "mode", "source", "flags", "tile_shift", "vec", "rows", "per_row", "per_row_shift",
              "threads", "grid", "smem_bytes")


class ScatterPlan(Plan):
    """How ``tcnn_probe_scatter`` runs one call (``ScatterArg``): ``vec``
    floats a row chunk (load and atomic), ``per_row`` = R / vec threads a
    row (``per_row_shift`` its log2 or -1), ``private`` blocks adding into
    their own shared-memory copy of the table (0: straight into the result),
    blocks of ``threads``, ``grid`` blocks and ``smem_bytes``."""

    FIELDS = ("N", "S", "R", "op", "private", "vec", "per_row", "per_row_shift", "threads", "grid", "smem_bytes")


@functools.lru_cache(maxsize=1024)
def gather_plan(B: int, S: int, F: int, mode: int = MODE_ROW, source: int = SOURCE_L2, flags: int = 0,
                table_align: int = 16, idx_align: int = 16, n_sms: int = N_SMS, unroll: int = None,
                in_flight: int = 64) -> GatherPlan:
    """The launch plan of ``probe_gather`` for B rows of an (S, F) table.
    ``table_align`` / ``idx_align``: the alignment in bytes of the table's
    (and table2's) and the indices' data pointers; ``unroll``: the L2
    gather's rows a thread (default ROWS_PER_THREAD; a warp takes 32 x
    that many).

    - Vector width: the widest of 4, 2, 1 floats that divides F and the
      table's alignment (SHARED, ASYNC, L2 rows); 1 for a transposed table;
      LANE: 4 (an int4 of indices, a float4 store) where F is a multiple of
      4 and the indices are 16-byte aligned, else 1.
    - Grid: the grid-stride kernels (L2, LANE, SHARED, ASYNC) take at most
      the blocks the card holds at once; TILE_SUM a block a tile.
    - Shared memory: the whole table (SHARED), in_flight rows (ASYNC), a
      tile's rows (TILE_SUM)."""
    B, S, F = int(B), int(S), int(F)
    vec, rows, per_row, threads, smem = vec_width(F, table_align), 1, 1, THREADS, 0
    if source == SOURCE_SHARED:
        threads, smem = SHARED_THREADS, 4 * S * F
        grid = min(n_sms, ceil_div(B, threads))
    elif source == SOURCE_ASYNC:
        threads, smem = int(in_flight), 4 * int(in_flight) * F
        grid = stride_grid(B, threads, n_sms, smem)
    elif mode == MODE_TILE_SUM:
        vec, smem, grid = 1, 4 * TILE * F, B // TILE
    elif mode == MODE_LANE:
        per_row = ceil_div(F, 4)
        vec = 4 if F % 4 == 0 and idx_align % 16 == 0 else 1
        grid = stride_grid(B * per_row, threads, n_sms)
    else:  # ROW, WINDOW, COPY from L2
        if flags & FLAG_TRANSPOSED:
            vec = 1
        rows = ROWS_PER_THREAD if unroll is None else int(unroll)
        grid = stride_grid(32 * ceil_div(B, 32 * rows), threads, n_sms)
    return GatherPlan(B=B, S=S, F=F, mode=mode, source=source, flags=flags, tile_shift=TILE_SHIFT, vec=vec, rows=rows,
                      per_row=per_row, per_row_shift=pow2_shift(per_row), threads=threads, grid=grid if B > 0 else 0,
                      smem_bytes=smem)


@functools.lru_cache(maxsize=1024)
def scatter_plan(N: int, S: int, R: int, acc: int = ACC_GLOBAL, n_sms: int = N_SMS, align: int = 16,
                 op: int = OP_ADD) -> ScatterPlan:
    """The launch plan of ``probe_scatter`` for N rows of R into S slots;
    ``align``: the alignment in bytes of the rows' data pointer.

    - Vector width: the widest of 4, 2, 1 floats dividing R and ``align``;
      R / vec threads a row.
    - ACC_SHARED privatises P = min(N // (FLUSH_SHARE * S), the blocks the
      card holds) blocks, each with a copy of the whole table: their flush,
      at most P * S * R entries, is at most 1 / FLUSH_SHARE of the N * R
      adds. Fewer than one block an SM would leave SMs idle while the adds
      are all the work, so then nothing is privatised and the adds go
      straight into the result, as for ACC_GLOBAL.
    - Grid: at most the blocks the card holds at once (grid-stride)."""
    N, S, R = int(N), int(S), int(R)
    vec = vec_width(R, align)
    per_row, threads, private, smem = R // vec, THREADS, 0, 0
    if op == OP_ADD and acc == ACC_SHARED and S > 0:
        p = min(N // (FLUSH_SHARE * S), n_sms * resident_blocks(PRIVATE_THREADS, 4 * S * R))
        if p >= n_sms:
            private, smem, threads = p, 4 * S * R, PRIVATE_THREADS
    grid = private if private else stride_grid(N * per_row, threads, n_sms)
    return ScatterPlan(N=N, S=S, R=R, op=op, private=private, vec=vec, per_row=per_row,
                       per_row_shift=pow2_shift(per_row), threads=threads, grid=grid, smem_bytes=smem)


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------
_GATHER_ARGS = [ctypes.c_void_p] * 6
_SCATTER_ARGS = [ctypes.c_void_p] * 6
_DOT_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2 + [ctypes.c_int] + [ctypes.c_void_p]


def _check(what: str, t: torch.Tensor, dtype, dims: int, index: int):
    if t.dtype != dtype or t.dim() != dims or not t.is_contiguous() or t.get_device() != index:
        raise ValueError(f"{what}: must be a contiguous {dims}-D {dtype} tensor on cuda:{index}")


def _launch(what: str, err: int):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError {err})")


def probe_gather(
    table: torch.Tensor,
    idx: torch.Tensor,
    mode: int = MODE_ROW,
    source: int = SOURCE_L2,
    unroll: int = None,
    table2: torch.Tensor = None,
    flags: int = 0,
    in_flight: int = 64,
) -> torch.Tensor:
    """Row gathers of a (S, F) fp32 table (``(F, S)`` with
    ``FLAG_TRANSPOSED``) at int32 indices: ``idx`` (B,), or (B, F) for
    ``MODE_LANE``. Returns (B, F) fp32 ((B / TILE, F, TILE) with
    ``FLAG_FEATURE_MAJOR``). ``table2`` serves the odd rows (MODE_ROW, L2).
    ``unroll``: rows a thread of the L2 gather (1 for P6, 8 for P7; default
    the plan's ROWS_PER_THREAD, 4). SHARED stages the table in each block
    (raises where it does not fit); ASYNC copies ``in_flight`` rows a block with ``cp.async``
    (MODE_ROW)."""
    dev = table.device
    if dev.type == "cpu":
        return probe_gather_plain(table, idx, mode, table2, flags)
    if dev.type != "cuda":
        raise ValueError(f"probe_gather: unsupported device {dev}")
    index = dev.index
    _check("probe_gather: table", table, torch.float32, 2, index)
    _check("probe_gather: idx", idx, torch.int32, 2 if mode == MODE_LANE else 1, index)
    S, F = (table.shape[1], table.shape[0]) if flags & FLAG_TRANSPOSED else table.shape
    B = idx.shape[0]
    if mode not in MODE_NAMES or source not in SOURCE_NAMES or unroll not in (None, 1, 8):
        raise ValueError(f"probe_gather: unsupported mode {mode}, source {source} or unroll {unroll}")
    if B >= 2**31 or S >= 2**31 or B * ceil_div(F, 4) >= 2**31:
        raise ValueError("probe_gather: the kernels index rows (and LANE quads) in 32 bits")
    if mode == MODE_LANE and idx.shape[1] != F:
        raise ValueError("probe_gather: MODE_LANE needs (B, F) indices")
    if mode == MODE_WINDOW and B % 8:
        raise ValueError("probe_gather: MODE_WINDOW needs a multiple of 8 rows")
    if mode in (MODE_TILE_SUM, MODE_COPY) or flags & FLAG_FEATURE_MAJOR:
        if B % TILE:
            raise ValueError(f"probe_gather: {B} rows are no multiple of the tile {TILE}")
        if mode == MODE_TILE_SUM and not fits_shared(TILE * F):
            raise ValueError(f"probe_gather: a tile of {TILE} x {F} rows does not fit in shared memory")
        if mode == MODE_COPY and S < TILE:
            raise ValueError(f"probe_gather: MODE_COPY reads rows 0..{TILE - 1} of a {S}-row table")
    special = table2 is not None or flags & (FLAG_TRANSPOSED | FLAG_ALIGNED)
    if source != SOURCE_L2 and (mode != MODE_ROW or special or unroll is not None):
        raise ValueError("probe_gather: the SHARED and ASYNC sources take MODE_ROW of one row-major table")
    if source == SOURCE_SHARED and not fits_shared(S * F):
        raise ValueError(f"probe_gather: a {S} x {F} fp32 table does not fit in {SHARED_BYTES} bytes of shared memory")
    if source == SOURCE_ASYNC and not (1 <= in_flight <= 1024 and fits_shared(in_flight * F)):
        raise ValueError(f"probe_gather: in_flight {in_flight} rows of {F} do not fit a block")
    align = alignment(table)
    if table2 is not None:
        if mode != MODE_ROW:
            raise ValueError("probe_gather: table2 is for MODE_ROW")
        _check("probe_gather: table2", table2, torch.float32, 2, index)
        if table2.shape != table.shape:
            raise ValueError("probe_gather: table2 must have the table's shape")
        align = min(align, alignment(table2))
    plan = gather_plan(B, S, F, mode, source, int(flags), align, alignment(idx), sm_count(index), unroll,
                       int(in_flight) if source == SOURCE_ASYNC else 64)
    if flags & FLAG_FEATURE_MAJOR:
        out = torch.empty((B // TILE, F, TILE), dtype=torch.float32, device=dev)
    elif mode == MODE_TILE_SUM:
        out = torch.zeros((B // TILE * 8, F), dtype=torch.float32, device=dev)
    else:
        out = torch.empty((B, F), dtype=torch.float32, device=dev)
    global GATHER_LAUNCHES
    err = kernel("probe_rows", "tcnn_probe_gather", _GATHER_ARGS)(
        table.data_ptr(), None if table2 is None else table2.data_ptr(), idx.data_ptr(), out.data_ptr(),
        plan.args_ptr, stream(index),
    )
    _launch("probe_gather", err)
    GATHER_LAUNCHES += 1
    return out


def probe_scatter(
    idx: torch.Tensor, rows: torch.Tensor, size: int, op: int = OP_ADD, acc: int = ACC_GLOBAL
) -> torch.Tensor:
    """Into a zeroed (size, R) fp32 table: ``OP_ADD`` adds each row at its
    index (``ACC_GLOBAL``: vector fp32 atomics into the result;
    ``ACC_SHARED``: per-block accumulators of the whole table where
    ``scatter_plan`` finds enough rows a slot, raises where the table does
    not fit); ``OP_STORE_LAST`` stores, per slot, the row of the largest
    ``j`` with ``idx[j]`` at it. ``idx`` (N,) int32 (outside [0, size):
    skipped), ``rows`` (N, R) fp32."""
    dev = rows.device
    if dev.type == "cpu":
        return probe_scatter_plain(idx, rows, size, op)
    if dev.type != "cuda":
        raise ValueError(f"probe_scatter: unsupported device {dev}")
    index = dev.index
    _check("probe_scatter: rows", rows, torch.float32, 2, index)
    _check("probe_scatter: idx", idx, torch.int32, 1, index)
    size, (N, R) = int(size), rows.shape
    if idx.shape[0] != N or N * max(R, 1) >= 2**31 or size >= 2**31:
        raise ValueError("probe_scatter: idx must have one entry per row, and N x R and size below 2^31")
    if op not in (OP_ADD, OP_STORE_LAST) or acc not in (ACC_GLOBAL, ACC_SHARED):
        raise ValueError(f"probe_scatter: unsupported op {op} or accumulator {acc}")
    if acc == ACC_SHARED and (op != OP_ADD or not fits_shared(size * R)):
        raise ValueError(f"probe_scatter: a shared accumulator needs OP_ADD and a table that fits ({size} x {R})")
    plan = scatter_plan(N, size, R, acc, sm_count(index), alignment(rows), op)
    out = torch.empty((size, R), dtype=torch.float32, device=dev)
    winner = torch.empty((size,), dtype=torch.int32, device=dev) if op == OP_STORE_LAST else None
    global SCATTER_LAUNCHES
    err = kernel("probe_rows", "tcnn_probe_scatter", _SCATTER_ARGS)(
        idx.data_ptr(), rows.data_ptr(), out.data_ptr(), None if winner is None else winner.data_ptr(),
        plan.args_ptr, stream(index),
    )
    _launch("probe_scatter", err)
    SCATTER_LAUNCHES += 1
    return out


def probe_gather_dot(table: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``table[idx] @ w``: table (S, F) fp32, idx (B,) int32, w (F, 128)
    fp32; (B, 128) fp32, each output an in-order fp32 multiply-add chain
    over F."""
    dev = table.device
    if dev.type == "cpu":
        return probe_gather_dot_plain(table, idx, w)
    if dev.type != "cuda":
        raise ValueError(f"probe_gather_dot: unsupported device {dev}")
    index = dev.index
    _check("probe_gather_dot: table", table, torch.float32, 2, index)
    _check("probe_gather_dot: idx", idx, torch.int32, 1, index)
    _check("probe_gather_dot: w", w, torch.float32, 2, index)
    S, F = table.shape
    if w.shape != (F, DOT_COLS):
        raise ValueError(f"probe_gather_dot: w must be ({F}, {DOT_COLS})")
    out = torch.empty((idx.shape[0], DOT_COLS), dtype=torch.float32, device=dev)
    global DOT_LAUNCHES
    err = kernel("probe_rows", "tcnn_probe_gather_dot", _DOT_ARGS)(
        table.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(), idx.shape[0], S, F, stream(index),
    )
    _launch("probe_gather_dot", err)
    DOT_LAUNCHES += 1
    return out
