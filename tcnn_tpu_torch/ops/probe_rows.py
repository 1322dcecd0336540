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

- ``probe_gather``: one thread per row (``unroll`` rows a thread), in the
  modes ``MODE_*`` and from the sources ``SOURCE_*``: L2 (``__ldg``),
  SHARED (each block first stages the whole table in shared memory, only
  where it fits: the wrapper raises otherwise) or ASYNC (``cp.async`` of
  ``in_flight`` rows into a shared ring per block, then their stores).
- ``probe_scatter``: ``OP_ADD`` into a SHARED accumulator (the whole (S, R)
  table per block, one flush atomic per touched entry) or a GLOBAL one (an
  fp32 ``atomicAdd`` per element); ``OP_STORE_LAST`` writes, per slot, the
  row of the largest index that reaches it (one ``atomicMax`` pass, then
  the write): a serial loop's last write.
- ``probe_gather_dot``: ``table[idx] @ w`` with ``w`` (F, 128), the gather
  and the product in one kernel, fp32 multiply-adds in registers.

Rows that a TPU probe leaves unwritten (P13 writes row 0 of each 8-row
block, P14 only the slots its indices reach) are zero here; the checks
compare only the rows the probe defines. Each wrapper runs its plain
version for a CPU tensor, and launches its kernel or raises for a CUDA one.
"""

from __future__ import annotations

import ctypes

import torch

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

# Dynamic shared memory a block may use on sm_90 (232,448 bytes).
SHARED_BYTES = 227 * 1024
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
# Kernels
# ---------------------------------------------------------------------------
_GATHER_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_SCATTER_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_DOT_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2 + [ctypes.c_int] + [ctypes.c_void_p]


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _n_sms(t: torch.Tensor) -> int:
    return torch.cuda.get_device_properties(t.device).multi_processor_count


def _check(what: str, t: torch.Tensor, dtype, dims: int, device):
    if t.dtype != dtype or t.dim() != dims or not t.is_contiguous() or t.device != device:
        raise ValueError(f"{what}: must be a contiguous {dims}-D {dtype} tensor on {device}")


def _launch(what: str, err: int):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError {err})")


def probe_gather(
    table: torch.Tensor,
    idx: torch.Tensor,
    mode: int = MODE_ROW,
    source: int = SOURCE_L2,
    unroll: int = 1,
    table2: torch.Tensor = None,
    flags: int = 0,
    in_flight: int = 64,
) -> torch.Tensor:
    """Row gathers of a (S, F) fp32 table (``(F, S)`` with
    ``FLAG_TRANSPOSED``) at int32 indices: ``idx`` (B,), or (B, F) for
    ``MODE_LANE``. Returns (B, F) fp32 ((B / TILE, F, TILE) with
    ``FLAG_FEATURE_MAJOR``). ``table2`` serves the odd rows (MODE_ROW, L2).
    SHARED stages the table in each block (raises where it does not fit);
    ASYNC copies ``in_flight`` rows a block with ``cp.async`` (MODE_ROW)."""
    if table.device.type == "cpu":
        return probe_gather_plain(table, idx, mode, table2, flags)
    if table.device.type != "cuda":
        raise ValueError(f"probe_gather: unsupported device {table.device}")
    dev = table.device
    _check("probe_gather: table", table, torch.float32, 2, dev)
    _check("probe_gather: idx", idx, torch.int32, 2 if mode == MODE_LANE else 1, dev)
    S, F = (table.shape[1], table.shape[0]) if flags & FLAG_TRANSPOSED else table.shape
    B = idx.shape[0]
    if mode not in MODE_NAMES or source not in SOURCE_NAMES or unroll not in (1, 8):
        raise ValueError(f"probe_gather: unsupported mode {mode}, source {source} or unroll {unroll}")
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
    if source != SOURCE_L2 and (mode != MODE_ROW or special or unroll != 1):
        raise ValueError("probe_gather: the SHARED and ASYNC sources take MODE_ROW of one row-major table, unroll 1")
    if source == SOURCE_SHARED and not fits_shared(S * F):
        raise ValueError(f"probe_gather: a {S} x {F} fp32 table does not fit in {SHARED_BYTES} bytes of shared memory")
    if source == SOURCE_ASYNC and not (1 <= in_flight <= 1024 and fits_shared(in_flight * F)):
        raise ValueError(f"probe_gather: in_flight {in_flight} rows of {F} do not fit a block")
    if table2 is not None:
        if mode != MODE_ROW:
            raise ValueError("probe_gather: table2 is for MODE_ROW")
        _check("probe_gather: table2", table2, torch.float32, 2, dev)
        if table2.shape != table.shape:
            raise ValueError("probe_gather: table2 must have the table's shape")
    if flags & FLAG_FEATURE_MAJOR:
        out = torch.empty((B // TILE, F, TILE), dtype=torch.float32, device=dev)
    elif mode == MODE_TILE_SUM:
        out = torch.zeros((B // TILE * 8, F), dtype=torch.float32, device=dev)
    else:
        out = torch.empty((B, F), dtype=torch.float32, device=dev)
    global GATHER_LAUNCHES
    from ._build import kernel

    err = kernel("probe_rows", "tcnn_probe_gather", _GATHER_ARGS)(
        table.data_ptr(), None if table2 is None else table2.data_ptr(), idx.data_ptr(), out.data_ptr(),
        B, S, F, mode, source, unroll, int(flags), TILE, int(in_flight), _n_sms(table), _stream(table),
    )
    _launch("probe_gather", err)
    GATHER_LAUNCHES += 1
    return out


def probe_scatter(
    idx: torch.Tensor, rows: torch.Tensor, size: int, op: int = OP_ADD, acc: int = ACC_GLOBAL
) -> torch.Tensor:
    """Into a zeroed (size, R) fp32 table: ``OP_ADD`` adds each row at its
    index (``ACC_GLOBAL``: fp32 atomics into the result; ``ACC_SHARED``: a
    per-block accumulator of the whole table, raises where it does not fit);
    ``OP_STORE_LAST`` stores, per slot, the row of the largest ``j`` with
    ``idx[j]`` at it. ``idx`` (N,) int32 (outside [0, size): skipped),
    ``rows`` (N, R) fp32."""
    if rows.device.type == "cpu":
        return probe_scatter_plain(idx, rows, size, op)
    if rows.device.type != "cuda":
        raise ValueError(f"probe_scatter: unsupported device {rows.device}")
    dev = rows.device
    _check("probe_scatter: rows", rows, torch.float32, 2, dev)
    _check("probe_scatter: idx", idx, torch.int32, 1, dev)
    size, (N, R) = int(size), rows.shape
    if idx.shape[0] != N or N >= 2**31:
        raise ValueError("probe_scatter: idx must have one entry per row (fewer than 2^31)")
    if op not in (OP_ADD, OP_STORE_LAST) or acc not in (ACC_GLOBAL, ACC_SHARED):
        raise ValueError(f"probe_scatter: unsupported op {op} or accumulator {acc}")
    if acc == ACC_SHARED and (op != OP_ADD or not fits_shared(size * R)):
        raise ValueError(f"probe_scatter: a shared accumulator needs OP_ADD and a table that fits ({size} x {R})")
    out = torch.zeros((size, R), dtype=torch.float32, device=dev)
    winner = torch.full((size,), -1, dtype=torch.int32, device=dev) if op == OP_STORE_LAST else None
    global SCATTER_LAUNCHES
    from ._build import kernel

    err = kernel("probe_rows", "tcnn_probe_scatter", _SCATTER_ARGS)(
        idx.data_ptr(), rows.data_ptr(), out.data_ptr(), None if winner is None else winner.data_ptr(),
        N, size, R, op, acc, _n_sms(rows), _stream(rows),
    )
    _launch("probe_scatter", err)
    SCATTER_LAUNCHES += 1
    return out


def probe_gather_dot(table: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``table[idx] @ w``: table (S, F) fp32, idx (B,) int32, w (F, 128)
    fp32; (B, 128) fp32, each output an in-order fp32 multiply-add chain
    over F."""
    if table.device.type == "cpu":
        return probe_gather_dot_plain(table, idx, w)
    if table.device.type != "cuda":
        raise ValueError(f"probe_gather_dot: unsupported device {table.device}")
    dev = table.device
    _check("probe_gather_dot: table", table, torch.float32, 2, dev)
    _check("probe_gather_dot: idx", idx, torch.int32, 1, dev)
    _check("probe_gather_dot: w", w, torch.float32, 2, dev)
    S, F = table.shape
    if w.shape != (F, DOT_COLS):
        raise ValueError(f"probe_gather_dot: w must be ({F}, {DOT_COLS})")
    out = torch.empty((idx.shape[0], DOT_COLS), dtype=torch.float32, device=dev)
    global DOT_LAUNCHES
    from ._build import kernel

    err = kernel("probe_rows", "tcnn_probe_gather_dot", _DOT_ARGS)(
        table.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(), idx.shape[0], S, F, _stream(table),
    )
    _launch("probe_gather_dot", err)
    DOT_LAUNCHES += 1
    return out
