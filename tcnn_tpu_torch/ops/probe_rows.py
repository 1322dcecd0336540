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
  any store; LANE: 4 lanes of a row a thread; ROW of a transposed table
  into feature-major tiles: each block stages whole feature planes of the
  table in shared memory, then gathers a run of samples from them, where a
  plane fits; WINDOW and COPY of a row-major table into (B, F) rows: the
  output as one flat run of vectors, consecutive lanes on consecutive
  vectors, a window's lanes sharing its one start, COPY's threads each
  holding one vector of the first tile and storing it to every tile they
  own), SHARED
  (persistent blocks each hold a copy of the whole table, staged by
  ``cp.async`` while every thread loads its first indices; only where the
  table fits: the wrapper raises otherwise) or ASYNC (a warp copies a group
  of ``in_flight`` rows by ``cp.async`` into its own slice of shared
  memory, waits for it and stores it).
- ``probe_scatter``: ``OP_ADD`` with one vector atomic (float2 / float4)
  per row chunk straight into the result (``ACC_GLOBAL``), or, for
  ``ACC_SHARED`` where there are enough rows a slot, into per-block
  shared-memory copies of the whole (S, R) table flushed once per non-zero
  float4; ``OP_STORE_LAST`` writes, per slot, the row of the largest index
  that reaches it (one ``atomicMax`` pass into the winners the wrapper
  keeps, then a pass over the slots that writes every output row once, the
  winner's or zeros): a serial loop's last write.
- ``probe_gather_dot``: ``table[idx] @ w`` with ``w`` (F, 128), the gather
  and the product in one kernel, fp32 multiply-adds in registers: a warp
  takes 32 samples at a time, a lane 4 columns and their values of ``w``,
  each sample's row broadcast to the warp, a sample's output row written
  as one 512-byte store of the warp.

The host functions ``gather_plan``, ``scatter_plan`` and ``dot_plan``
decide each launch (vector width from F or R and the pointers' alignment,
rows a thread, grid, private blocks, shared bytes); the C entry points read
the plan's int32 array. The kernels index rows in 32 bits (B, N x R and S
below 2^31).

Rows that a TPU probe leaves unwritten (P13 writes row 0 of each 8-row
block, P14 only the slots its indices reach) are zero here; the checks
compare only the rows the probe defines. Each wrapper runs its plain
version for a CPU tensor, and launches its kernel or raises for a CUDA one.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from ._build import kernel, stream
from ._plans import (FLUSH_SHARE, N_SMS, PRIVATE_THREADS, SHARED_BYTES, SM_THREADS, THREADS, Plan, alignment, ceil_div,
                     pow2_shift, resident_blocks, sm_count, stride_grid, vec_width)

# Launches of the CUDA kernels (incremented once per launch, nowhere else);
# the gather's also by route (``gather_route``).
GATHER_LAUNCHES = 0
GATHER_ROUTE_LAUNCHES = {}
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

# The kernels a gather plan can launch, by the plan's ``route``
# (csrc/probe_rows.cu: Route); ``gather_plan`` alone decides it, and the
# names are ``GATHER_ROUTE_LAUNCHES``' keys.
GATHER_ROUTES = ("l2", "lane", "tile_sum", "planes", "shared", "async", "window", "copy")
ROUTE_L2, ROUTE_LANE, ROUTE_TILE_SUM, ROUTE_PLANES, ROUTE_SHARED, ROUTE_ASYNC, ROUTE_WINDOW, ROUTE_COPY = range(8)

OP_ADD = 0
OP_STORE_LAST = 1
ACC_GLOBAL = 0
ACC_SHARED = 1

TILE = 2048  # rows per tile of MODE_TILE_SUM / MODE_COPY / feature-major output (the probes' TILE)
DOT_COLS = 128
# MODE_TILE_SUM's block (csrc/probe_rows.cu: kSumChunks, kSumThreads,
# kSumLd): a summing warp beside TILE_SUM_CHUNKS chunks of TILE /
# TILE_SUM_CHUNKS gathering threads; the tile's rows feature-major in shared
# memory, TILE + TILE_SUM_PAD floats a feature; one 8-byte mbarrier a chunk.
TILE_SUM_CHUNKS = 8
TILE_SUM_THREADS = 32 + TILE // TILE_SUM_CHUNKS
TILE_SUM_PAD = 4
DOT_THREADS = 256  # threads a block of the gather-dot (8 warps)
DOT_BLOCKS_PER_SM = 2  # its __launch_bounds__ minimum


def fits_shared(n_floats: int) -> bool:
    """Whether ``n_floats`` fp32 values fit in one block's shared memory."""
    return 4 * int(n_floats) <= SHARED_BYTES


def tile_sum_fits(F: int) -> bool:
    """Whether MODE_TILE_SUM's block (the padded tile and a chunk's
    mbarrier each, 2 floats) fits a block's shared memory: F <= 28."""
    return fits_shared(int(F) * (TILE + TILE_SUM_PAD) + 2 * TILE_SUM_CHUNKS)


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
        table2 = None if table2 is None else table2.t()
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
SHARED_THREADS = 1024  # threads a block of the SHARED gather (csrc/probe_rows.cu: kSharedThreads)
SHARED_ROWS = (1, 2, 4, 8)  # the SHARED gather's rows a thread, compile-time
ASYNC_WARPS = 8  # warps a block of the ASYNC gather at most (kAsyncWarps)
PLANE_THREADS = 1024  # threads a block of the plane-staged gather (csrc/probe_rows.cu: kPlaneThreads)
ROWS_PER_THREAD = 4  # the L2 gather's rows a thread (a warp's: 32 x 4)
WINDOW_VECTORS = 2  # vectors a lane of the WINDOW kernel has in flight (csrc/probe_rows.cu: kWindowVectors)
TILE_SHIFT = TILE.bit_length() - 1


class GatherPlan(Plan):
    """How ``tcnn_probe_gather`` runs one call (``csrc/probe_rows.cu``,
    ``GatherArg``): ``vec`` floats a vector access, ``rows`` rows a thread
    (L2 ROW/WINDOW/COPY: a warp takes 32 x rows, lane l rows l + 32 u),
    ``per_row`` threads a row (LANE: quads of 4 lanes) and its log2
    (``per_row_shift``, -1 when no power of two), blocks of ``threads``,
    ``grid`` blocks, ``smem_bytes`` of dynamic shared memory,
    ``chunks`` a tile is gathered in (TILE_SUM; 0 otherwise), and for the
    plane-staged route ``planes`` feature planes a block stages, ``runs``
    sample runs of ``run`` samples (0 on the other routes). SHARED:
    ``rows`` rows a thread, ``per_row`` = F / vec vectors a row (and its
    log2); ASYNC: ``in_flight`` rows a copy group, ``per_row`` as SHARED
    (0 on the other routes). WINDOW: ``rows`` = WINDOW_VECTORS vectors a
    lane in flight, ``per_row`` = 8 F / vec vectors a window; COPY:
    ``per_row`` = TILE F / vec vectors a tile, ``runs`` groups of threads
    that each hold the tile's vectors, ``rows`` tiles a thread stores at
    most. ``route``: the kernel the plan launches, an index into
    GATHER_ROUTES."""

    FIELDS = ("B", "S", "F", "mode", "source", "flags", "tile_shift", "vec", "rows", "per_row", "per_row_shift",
              "threads", "grid", "smem_bytes", "chunks", "planes", "runs", "run", "in_flight", "route")


class ScatterPlan(Plan):
    """How ``tcnn_probe_scatter`` runs one call (``ScatterArg``): ``vec``
    floats a row chunk (load and atomic), ``per_row`` = R / vec threads a
    row (``per_row_shift`` its log2 or -1), ``private`` blocks adding into
    their own shared-memory copy of the table (0: straight into the result),
    blocks of ``threads``, ``grid`` blocks and ``smem_bytes``. STORE_LAST:
    ``grid`` blocks of the pass over the slots (a warp 32 slots at a time),
    ``claim_grid`` blocks of the claim (a thread an index, grid-stride)."""

    FIELDS = ("N", "S", "R", "op", "private", "vec", "per_row", "per_row_shift", "threads", "grid", "smem_bytes",
              "claim_grid")


def plane_bytes(B: int, S: int, F: int, planes: int, runs: int) -> int:
    """The bytes the plane-staged gather moves: each block's planes staged
    (F / planes groups of ``runs`` blocks, planes x S floats each), each
    group's indices read and the output written once."""
    return 4 * ((F // planes) * (runs * planes * S + B) + B * F)


def plane_layout(B: int, S: int, F: int, n_sms: int = N_SMS):
    """(planes, runs) of the plane-staged gather, or None where no feature
    plane of S floats fits a block's shared memory: of the numbers of
    planes that divide F and fit, each with one wave of blocks (F / planes
    groups of runs = n_sms // groups, at least 1, at most a run a 32
    samples), the one that moves the fewest bytes (``plane_bytes``; the
    most planes on a tie)."""
    fit = [p for p in range(F, 0, -1) if F % p == 0 and fits_shared(p * S)]
    if not fit:
        return None
    layouts = [(p, max(1, min(ceil_div(B, 32), n_sms // (F // p)))) for p in fit]
    return min(layouts, key=lambda layout: plane_bytes(B, S, F, *layout))


def shared_rows(B: int, n_sms: int = N_SMS) -> int:
    """The SHARED gather's rows a thread: the fewest of SHARED_ROWS with
    which a block of SHARED_THREADS an SM covers B in one round (at most 8;
    beyond, the warps loop over their groups)."""
    return next((r for r in SHARED_ROWS if n_sms * SHARED_THREADS * r >= B), SHARED_ROWS[-1])


def async_warps(F: int, in_flight: int) -> int:
    """The ASYNC gather's warps a block: ASYNC_WARPS, fewer where their
    groups of ``in_flight`` rows of F floats (4 in_flight F bytes a warp:
    512 at P8, 2,048 at P9) do not fit a block's shared memory. Each warp
    keeps one group in flight: ``probe_times`` measured rings of 2, 4 and 8
    groups a warp (NVIDIA H100 80GB HBM3, 700 W) and none paid, where the
    ring takes warps away (P8 0.0035 ms with one group, 0.0036 / 0.0036 /
    0.0064 with 2 / 4 / 8; P9 0.0033, 0.0032 / 0.0044 / 0.0084) or where it
    does not (2^24 rows of F = 2, 31 groups a warp: 0.144 ms with one,
    0.153 / 0.154 with 2 / 4). ValueError where one group does not fit."""
    warps = min(ASYNC_WARPS, SHARED_BYTES // (4 * int(in_flight) * int(F)))
    if warps == 0:
        raise ValueError(f"probe_gather: a group of {in_flight} x {F} rows does not fit a block")
    return warps


@functools.lru_cache(maxsize=1024)
def gather_plan(B: int, S: int, F: int, mode: int = MODE_ROW, source: int = SOURCE_L2, flags: int = 0,
                table_align: int = 16, idx_align: int = 16, n_sms: int = N_SMS, unroll: int = None,
                in_flight: int = 64, two_tables: bool = False, planes: int = None, runs: int = None) -> GatherPlan:
    """The launch plan of ``probe_gather`` for B rows of an (S, F) table.
    ``table_align`` / ``idx_align``: the alignment in bytes of the table's
    (and table2's) and the indices' data pointers; ``unroll``: the L2
    gather's rows a thread (default ROWS_PER_THREAD; a warp takes 32 x
    that many); ``two_tables``: a second table serves the odd rows; ``planes`` /
    ``runs``: the plane-staged route's layout in place of
    ``plane_layout``'s (for measuring it).

    - Route: ROW of a transposed table into feature-major tiles from L2 (no
      second table, no ``unroll``) stages whole feature planes in each
      block's shared memory where one fits (``plane_layout``); WINDOW and
      COPY of a row-major table into (B, F) rows (no ``unroll``, B F below
      2^31: the kernels index the output's values in 32 bits) take their
      own kernels ("window", "copy"); every other call takes its source's
      or mode's kernel (WINDOW and COPY the L2 gather's).
    - Vector width: the widest of 4, 2, 1 floats that divides F and the
      table's alignment (SHARED, ASYNC, L2 rows, WINDOW: a vector lies in
      one row); COPY's that divides the table's alignment (the tile is one
      flat run of TILE F floats); 1 for a transposed table
      read row by row; the plane-staged route stages the planes as the
      widest vector that divides S and the table's alignment;
      LANE: 4 (an int4 of indices, a float4 store) where F is a multiple of
      4 and the indices are 16-byte aligned, else 1.
    - Grid: the grid-stride kernels (L2, LANE, ASYNC, WINDOW) take at most
      the blocks the card holds at once (WINDOW: a warp a chunk of 32
      ``rows`` vectors); TILE_SUM a block a tile (B // TILE of them), its
      summing warp beside TILE_SUM_CHUNKS chunks of gathering threads;
      COPY ``runs`` groups of the tile's vectors (fewer threads a group
      where a tile has more vectors than the card holds threads): about one
      block of THREADS an SM (at P12's shape 8 tiles a thread, measured
      faster than 1, 2 or 4), at least one group and no more than the
      tiles.
    - SHARED: blocks of SHARED_THREADS, ``shared_rows`` rows a thread, as
      many as the card holds at once at the table's shared bytes, no more
      than the rows need. Shared memory: the table.
    - ASYNC: ``async_warps``' W warps a block, W groups of shared memory;
      blocks to the card's one wave, no more than a group a warp needs.
    - Shared memory otherwise: a tile's rows feature-major, each feature
      padded by TILE_SUM_PAD floats (TILE_SUM), a block's planes
      (plane-staged).
    - Plane-staged grid: F / planes groups x runs work items, a run of
      ``run`` samples (a multiple of 32) each, at most the blocks the card
      holds at once (grid-stride over the items)."""
    B, S, F = int(B), int(S), int(F)
    vec, rows, per_row, threads, smem, chunks = vec_width(F, table_align), 1, 1, THREADS, 0, 0
    n_planes = n_runs = run = group = 0
    own = (mode in (MODE_WINDOW, MODE_COPY) and source == SOURCE_L2 and not two_tables and unroll is None
           and not flags & (FLAG_TRANSPOSED | FLAG_FEATURE_MAJOR) and B * F < 2**31)
    staged = (mode == MODE_ROW and source == SOURCE_L2 and not two_tables and unroll is None
              and flags & FLAG_TRANSPOSED and flags & FLAG_FEATURE_MAJOR)
    layout = None
    if staged:
        layout = (int(planes), int(runs)) if planes is not None else plane_layout(B, S, F, n_sms)
    if layout is not None:
        n_planes = layout[0]
        run = 32 * ceil_div(ceil_div(B, 32), max(1, layout[1]))
        n_runs = ceil_div(B, run) if B > 0 else 0
        threads, smem, vec = PLANE_THREADS, 4 * n_planes * S, vec_width(S, table_align)
        grid = min((F // n_planes) * n_runs, n_sms * resident_blocks(threads, smem))
        route = ROUTE_PLANES
    elif source == SOURCE_SHARED:
        threads, smem, rows, per_row = SHARED_THREADS, 4 * S * F, shared_rows(B, n_sms), F // vec
        grid = min(n_sms * resident_blocks(threads, smem), ceil_div(ceil_div(B, 32 * rows), threads // 32))
        route = ROUTE_SHARED
    elif source == SOURCE_ASYNC:
        group, per_row = int(in_flight), F // vec
        warps = async_warps(F, group)
        threads, smem = 32 * warps, warps * 4 * group * F
        grid = min(ceil_div(ceil_div(B, group), warps), n_sms * resident_blocks(threads, smem))
        route = ROUTE_ASYNC
    elif own and mode == MODE_WINDOW:
        rows, per_row = WINDOW_VECTORS, 8 * F // vec
        grid = stride_grid(32 * ceil_div(B * F // vec, 32 * rows), threads, n_sms)
        route = ROUTE_WINDOW
    elif own:  # COPY
        vec = vec_width(TILE * F, table_align)
        per_row, n_tiles = TILE * F // vec, B // TILE
        capacity = n_sms * SM_THREADS
        if per_row >= capacity:
            n_runs, width = 1, capacity
        else:
            n_runs, width = max(1, min(n_tiles, n_sms * threads // per_row)), per_row
        rows = ceil_div(n_tiles, n_runs)
        grid = n_runs * width // threads if n_tiles else 0
        route = ROUTE_COPY
    elif mode == MODE_TILE_SUM:
        if flags & FLAG_TRANSPOSED:
            vec = 1
        threads, smem, grid, chunks = TILE_SUM_THREADS, 4 * F * (TILE + TILE_SUM_PAD), B // TILE, TILE_SUM_CHUNKS
        route = ROUTE_TILE_SUM
    elif mode == MODE_LANE:
        per_row = ceil_div(F, 4)
        vec = 4 if F % 4 == 0 and idx_align % 16 == 0 else 1
        grid = stride_grid(B * per_row, threads, n_sms)
        route = ROUTE_LANE
    else:  # ROW, WINDOW, COPY from L2
        if flags & FLAG_TRANSPOSED:
            vec = 1
        rows = ROWS_PER_THREAD if unroll is None else int(unroll)
        grid = stride_grid(32 * ceil_div(B, 32 * rows), threads, n_sms)
        route = ROUTE_L2
    return GatherPlan(B=B, S=S, F=F, mode=mode, source=source, flags=flags, tile_shift=TILE_SHIFT, vec=vec, rows=rows,
                      per_row=per_row, per_row_shift=pow2_shift(per_row), threads=threads, grid=grid if B > 0 else 0,
                      smem_bytes=smem, chunks=chunks, planes=n_planes, runs=n_runs, run=run, in_flight=group,
                      route=route)


def gather_route(plan: GatherPlan) -> str:
    """The name of the route a gather plan launches, one of GATHER_ROUTES
    (``GATHER_ROUTE_LAUNCHES``' keys)."""
    return GATHER_ROUTES[plan.route]


@functools.lru_cache(maxsize=1024)
def scatter_plan(N: int, S: int, R: int, acc: int = ACC_GLOBAL, n_sms: int = N_SMS, align: int = 16,
                 op: int = OP_ADD) -> ScatterPlan:
    """The launch plan of ``probe_scatter`` for N rows of R into S slots;
    ``align``: the alignment in bytes of the rows' data pointer.

    - Vector width: the widest of 4, 2, 1 floats dividing R and ``align``;
      R / vec threads a row (ADD), vectors a slot's row (STORE_LAST).
    - ACC_SHARED privatises P = min(N // (FLUSH_SHARE * S), the blocks the
      card holds) blocks, each with a copy of the whole table: their flush,
      at most P * S * R entries, is at most 1 / FLUSH_SHARE of the N * R
      adds. Fewer than one block an SM would leave SMs idle while the adds
      are all the work, so then nothing is privatised and the adds go
      straight into the result, as for ACC_GLOBAL.
    - Grid: at most the blocks the card holds at once (grid-stride). ADD:
      one item (a row's vector) a thread; STORE_LAST: the claim one index
      a thread, the pass over the slots a warp 32 slots (every output row,
      N = 0 too)."""
    N, S, R = int(N), int(S), int(R)
    vec = vec_width(R, align)
    per_row, threads, private, smem, claim = R // vec, THREADS, 0, 0, 0
    if op == OP_ADD and acc == ACC_SHARED and S > 0:
        p = min(N // (FLUSH_SHARE * S), n_sms * resident_blocks(PRIVATE_THREADS, 4 * S * R))
        if p >= n_sms:
            private, smem, threads = p, 4 * S * R, PRIVATE_THREADS
    if op == OP_STORE_LAST:
        grid = stride_grid(32 * ceil_div(S, 32), threads, n_sms) if R > 0 else 0
        claim = stride_grid(N, threads, n_sms)
    else:
        grid = private if private else stride_grid(N * per_row, threads, n_sms)
    return ScatterPlan(N=N, S=S, R=R, op=op, private=private, vec=vec, per_row=per_row,
                       per_row_shift=pow2_shift(per_row), threads=threads, grid=grid, smem_bytes=smem,
                       claim_grid=claim)


class DotPlan(Plan):
    """How ``tcnn_probe_gather_dot`` runs one call (``DotArg``): ``vec``
    floats a row load, ``in_flight`` samples whose rows a warp loads before
    their products, blocks of ``threads`` (a warp takes 32 samples at a
    time, grid-stride) and ``grid`` blocks."""

    FIELDS = ("B", "S", "F", "vec", "in_flight", "threads", "grid")


def dot_in_flight(F: int) -> int:
    """Samples a warp has in flight (``kDotInFlight``): 64 row values at a
    compile-time F (1, 2, 4, 8), at most the 32 of a group; 4 otherwise."""
    return min(32, 64 // F) if F in (1, 2, 4, 8) else 4


@functools.lru_cache(maxsize=256)
def dot_plan(B: int, S: int, F: int, table_align: int = 16, n_sms: int = N_SMS) -> DotPlan:
    """The launch plan of ``probe_gather_dot`` for B samples of an (S, F)
    table: rows as the widest vector that F and the table's alignment allow;
    a warp a group of 32 samples, at most DOT_BLOCKS_PER_SM blocks an SM
    (the kernel's launch bounds) and no more blocks than groups need."""
    B, S, F = int(B), int(S), int(F)
    groups = ceil_div(B, 32)
    grid = min(ceil_div(groups, DOT_THREADS // 32), n_sms * DOT_BLOCKS_PER_SM) if B > 0 else 0
    return DotPlan(B=B, S=S, F=F, vec=vec_width(F, table_align), in_flight=dot_in_flight(F), threads=DOT_THREADS,
                   grid=grid)


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------
_GATHER_ARGS = [ctypes.c_void_p] * 6
_SCATTER_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_uint32]
_DOT_ARGS = [ctypes.c_void_p] * 6


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
    the plan's ROWS_PER_THREAD, 4; a WINDOW or COPY call with it takes the
    L2 gather, not its own kernel). SHARED stages the table in each block
    (raises where it does not fit); ASYNC copies groups of ``in_flight``
    rows with ``cp.async``, one in flight a warp (MODE_ROW)."""
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
        if mode == MODE_TILE_SUM and not tile_sum_fits(F):
            raise ValueError(f"probe_gather: a tile of {TILE} x {F} rows does not fit in shared memory")
        if mode == MODE_TILE_SUM and flags & FLAG_FEATURE_MAJOR:
            raise ValueError("probe_gather: MODE_TILE_SUM writes (B / TILE * 8, F) rows, not feature-major tiles")
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
                       int(in_flight) if source == SOURCE_ASYNC else 64, table2 is not None)
    if flags & FLAG_FEATURE_MAJOR:
        out = torch.empty((B // TILE, F, TILE), dtype=torch.float32, device=dev)
    elif mode == MODE_TILE_SUM:
        out = torch.empty((B // TILE * 8, F), dtype=torch.float32, device=dev)  # the kernel writes rows 1-7 too
    else:
        out = torch.empty((B, F), dtype=torch.float32, device=dev)
    global GATHER_LAUNCHES
    err = kernel("probe_rows", "tcnn_probe_gather", _GATHER_ARGS)(
        table.data_ptr(), None if table2 is None else table2.data_ptr(), idx.data_ptr(), out.data_ptr(),
        plan.args_ptr, stream(index),
    )
    _launch("probe_gather", err)
    GATHER_LAUNCHES += 1
    route = gather_route(plan)
    GATHER_ROUTE_LAUNCHES[route] = GATHER_ROUTE_LAUNCHES.get(route, 0) + 1
    return out


# STORE_LAST's winner arrays, by (device index, raw stream handle), each
# with the epoch of its last call: a slot's winner is (epoch << 32) | j, and
# each call takes the next epoch, so an entry of an earlier call reads as
# none and no call fills or resets the array (zeros when made, and again
# after 2^32 - 1 calls). One a stream: calls on one stream run in order and
# share it, two streams never do. A call being captured into a CUDA graph
# gets its own array, zeroed in the graph, at epoch 1. The lock keeps two
# threads from interleaving their epochs and launches on one stream.
_WINNERS = {}
_WINNERS_LOCK = threading.Lock()
_LAST_EPOCH = 2**32 - 1


def _winners(index: int, size: int, st: int):
    """(a winner array of at least ``size`` int64 entries, the epoch of this
    call): no entry of that epoch or a later one when the current stream
    reaches the next launch."""
    dev = torch.device("cuda", index)
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros((size,), dtype=torch.int64, device=dev), 1
    entry = _WINNERS.get((index, st))
    if entry is None or entry[0].numel() < size or entry[1] >= _LAST_EPOCH:
        entry = _WINNERS[(index, st)] = [torch.zeros((size,), dtype=torch.int64, device=dev), 0]
    entry[1] += 1
    return entry[0], entry[1]


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
    global SCATTER_LAUNCHES
    fn, st = kernel("probe_rows", "tcnn_probe_scatter", _SCATTER_ARGS), stream(index)
    if op == OP_STORE_LAST:
        with _WINNERS_LOCK:
            winner, epoch = _winners(index, size, st)
            err = fn(idx.data_ptr(), rows.data_ptr(), out.data_ptr(), winner.data_ptr(), plan.args_ptr, st, epoch)
    else:
        err = fn(idx.data_ptr(), rows.data_ptr(), out.data_ptr(), None, plan.args_ptr, st, 0)
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
    (S, F), B = table.shape, idx.shape[0]
    if w.shape != (F, DOT_COLS):
        raise ValueError(f"probe_gather_dot: w must be ({F}, {DOT_COLS})")
    if B >= 2**31 or S >= 2**31:
        raise ValueError("probe_gather_dot: the kernel indexes samples and rows in 32 bits")
    plan = dot_plan(B, S, F, alignment(table), sm_count(index))
    out = torch.empty((B, DOT_COLS), dtype=torch.float32, device=dev)
    global DOT_LAUNCHES
    err = kernel("probe_rows", "tcnn_probe_gather_dot", _DOT_ARGS)(
        table.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(), plan.args_ptr, stream(index),
    )
    _launch("probe_gather_dot", err)
    DOT_LAUNCHES += 1
    return out
