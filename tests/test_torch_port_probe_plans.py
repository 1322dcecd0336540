"""The launch plans of the row gather and scatter probes
(``tcnn_tpu_torch.ops.probe_rows.gather_plan`` / ``scatter_plan``): host
functions, held here to the invariants the kernels in
``csrc/probe_rows.cu`` rely on.

- a vector width only where F (or R) and the pointers' alignment allow it;
- a grid the card holds at once for every grid-stride kernel;
- dynamic shared memory within a block's 232,448 bytes;
- a private scatter's flush atomics at most an eighth of its adds, or no
  privatisation;
- every output element (gathers) and every row element (scatters) covered
  exactly once by the kernels' loops as the plan lays them out, for B, N in
  {0, 1, 7, 2^18 + 3}. The loops are mirrored here in numpy: a warp owns
  32 x ``rows`` rows, lane l rows l + 32 u (L2 gathers, grid-stride over
  warps; SHARED the same, its lanes storing vectors l + 32 k of each u's
  32 rows), a thread 4 lanes of a row (LANE), grid-stride over ``grid *
  threads`` threads; ASYNC: warp w of the grid takes groups of
  ``in_flight`` rows w, w + n_warps, ..., lane l vectors l + 32 k of each;
  WINDOW: warp c of the grid takes chunks c, c + n_warps, ... of 32 x
  ``rows`` vectors of the flat output, lane l vectors l + 32 k of each,
  vector q reading row idx[8 (q // NV)] + (q % NV) // (F / vec) (NV = 8 F /
  vec); COPY: ``runs`` groups of W = grid x threads / runs threads, thread
  t storing vectors t % W, t % W + W, ... of the first tile to tiles
  t // W, t // W + runs, ...;
  a scatter thread takes items
  ``t0 + k * stride`` (k < ILP, 4 or 2 in private blocks) with ``t0``
  stepping by ILP strides, item ``t`` being row ``t // per_row`` and its
  chunk of ``vec`` values.
"""

import numpy as np
import pytest

from tcnn_tpu_torch.ops import _plans as plans
from tcnn_tpu_torch.ops import probe_rows as pr

SIZES = (0, 1, 7, 2**18 + 3)
BLOCK_SHARED_LIMIT = 232448
# Items a scatter thread has in flight (csrc/probe_rows.cu: kIlp): 4, or 2
# in private blocks.
SCATTER_ILP = {False: 4, True: 2}


def _thread_items(n_items, plan, ilp=1):
    """The items the plan's grid-stride loop visits, thread by thread."""
    stride = plan.grid * plan.threads
    if n_items == 0:
        return np.zeros(0, np.int64)
    assert stride > 0
    steps = -(-n_items // (ilp * stride))
    t0 = np.arange(stride, dtype=np.int64)[None, :] + (np.arange(steps, dtype=np.int64) * ilp * stride)[:, None]
    items = (t0[:, :, None] + np.arange(ilp, dtype=np.int64)[None, None, :] * stride).reshape(-1)
    return items[items < n_items]


def _gather_cover(plan, B, F):
    """How often each output element (b, f) is written, by the loops of the
    kernel the plan's route names."""
    route = pr.gather_route(plan)
    if route == "lane":
        items = _thread_items(B * plan.per_row, plan)
        b, q = items // plan.per_row, items % plan.per_row
        lanes = q[:, None] * 4 + np.arange(4)[None, :]
        keep = lanes < F
        el = (b[:, None] * F + lanes)[keep]
    elif route == "window":
        el = _window_writes(plan, B, F)
    elif route == "copy":
        el = _copy_writes(plan, B, F)
    elif route == "l2":
        # A warp takes group g of 32 x rows rows (grid-stride over warps);
        # lane l rows g * 32 * rows + l + 32 u, u < rows.
        R, n_warps = plan.rows, plan.grid * plan.threads // 32
        assert plan.threads % 32 == 0 and n_warps > 0
        groups = np.arange(-(-B // (32 * R)), dtype=np.int64)  # warp g % n_warps takes group g
        rows = (groups[:, None, None] * 32 * R + np.arange(32)[None, :, None]
                + 32 * np.arange(R)[None, None, :]).reshape(-1)
        rows = rows[rows < B]
        assert F % plan.vec == 0
        el = (rows[:, None] * F + np.arange(F)[None, :]).reshape(-1)
    elif route == "shared":
        el = _shared_writes(plan, B, F)
    else:
        assert route == "async"
        el = _async_writes(plan, B, F)
    return np.bincount(el, minlength=B * F)


def _window_writes(plan, B, F):
    """The output elements the WINDOW kernel (csrc/probe_rows.cu:
    gather_windows) writes, one entry a write: warp c % n_warps takes chunk
    c of 32 K vectors (K = rows = WINDOW_VECTORS), lane l vectors c 32 K + l + 32 k below
    B F / vec; each vector's read (window, row of the window, column) is
    the plain version's for the elements it writes."""
    K, vec, nv = plan.rows, plan.vec, plan.per_row
    assert K == pr.WINDOW_VECTORS and plan.threads == 256 and F % vec == 0 and nv == 8 * F // vec
    n_vec, n_warps = B * F // vec, plan.grid * plan.threads // 32
    assert n_warps > 0 and B % 8 == 0
    chunks = -(-n_vec // (32 * K))
    q = (np.arange(chunks)[:, None] * 32 * K + np.arange(32 * K)[None, :]).reshape(-1)
    q = q[q < n_vec]
    el = q[:, None] * vec + np.arange(vec)[None, :]
    window, e = q // nv, q % nv
    row, col = e // (F // vec), (e % (F // vec)) * vec
    b, f = el // F, el % F
    assert (b // 8 == window[:, None]).all() and (b % 8 == row[:, None]).all()
    assert (f == col[:, None] + np.arange(vec)[None, :]).all()
    return el.reshape(-1)


def _copy_writes(plan, B, F):
    """The output elements the COPY kernel (csrc/probe_rows.cu: copy_tiles)
    writes, one entry a write: ``runs`` groups of W = grid x threads / runs
    threads; thread t stores vectors s = t % W, s + W, ... (below NT = TILE
    F / vec) of the first tile to tiles t // W, t // W + runs, ...; each
    stored vector is the table's flat vector s, the plain version's
    element e mod TILE F."""
    vec, nt, groups = plan.vec, plan.per_row, plan.runs
    assert (pr.TILE * F) % vec == 0 and nt == pr.TILE * F // vec and plan.threads == 256
    G = plan.grid * plan.threads
    assert groups >= 1 and G % groups == 0 and B % pr.TILE == 0
    width, n_tiles = G // groups, B // pr.TILE
    t = np.arange(G)
    s = (t % width)[None, :] + width * np.arange(-(-nt // width))[:, None]
    r = (t // width)[None, :] + groups * np.arange(-(-n_tiles // groups))[:, None]
    writes = []
    for tiles in r:  # thread t's j-th tile, for every t
        for vectors in s:  # thread t's i-th vector
            keep = (tiles < n_tiles) & (vectors < nt)
            writes.append(tiles[keep] * nt + vectors[keep])
    q = np.concatenate(writes) if writes else np.zeros(0, np.int64)
    assert plan.rows == -(-n_tiles // groups)
    el = q[:, None] * vec + np.arange(vec)[None, :]
    src = (q % nt)[:, None] * vec + np.arange(vec)[None, :]
    assert (src == el % (pr.TILE * F)).all()
    return el.reshape(-1)


def _vector_elements(base, q, plan, F):
    """The output elements of vector q of the run of whole rows that starts
    at element ``base`` (arrays of one shape): vector q is row q //
    per_row, chunk q % per_row, ``vec`` floats."""
    assert plan.per_row * plan.vec == F
    row, chunk = q // plan.per_row, q % plan.per_row
    return (base + row * F + chunk * plan.vec)[..., None] + np.arange(plan.vec)


def _shared_writes(plan, B, F):
    """The output elements the SHARED gather (csrc/probe_rows.cu:
    gather_rows_shared) writes, one entry a write: warp g % n_warps takes
    group g of 32 x rows rows; for each
    u < rows whose 32 rows start below B, lane l stores vectors l + 32 k
    (k < per_row) of those rows, the vector's row index shuffled from lane
    q // per_row (a lane of the warp), those of rows below B."""
    assert plan.threads == pr.SHARED_THREADS and plan.rows in pr.SHARED_ROWS
    assert plan.grid * plan.threads // 32 > 0
    R, T = plan.rows, plan.per_row
    lanes_k = (np.arange(32)[None, :] + 32 * np.arange(T)[:, None]).reshape(-1)  # q of lane l, k
    assert (lanes_k // T < 32).all()  # the shuffle's source lane
    b0 = ((np.arange(-(-B // (32 * R))) * 32 * R)[:, None] + 32 * np.arange(R)[None, :]).reshape(-1, 1)
    q = np.broadcast_to(lanes_k, (b0.shape[0], lanes_k.size))
    keep = (b0 < B) & (q < np.minimum(32, B - b0) * T)
    return _vector_elements(np.broadcast_to(b0 * F, q.shape)[keep], q[keep], plan, F).reshape(-1)


def _async_writes(plan, B, F):
    """The output elements the ASYNC gather (csrc/probe_rows.cu:
    gather_rows_async) writes, one entry a write: warp w of the grid takes
    groups w + i n_warps (rows G (w + i n_warps) .. + G - 1, G = in_flight);
    lane l copies and then stores vectors l + 32 k of a group, those of rows
    below B."""
    G, T = plan.in_flight, plan.per_row
    assert plan.threads % 32 == 0 and plan.threads <= 32 * pr.ASYNC_WARPS and plan.grid * plan.threads >= 32
    groups = -(-B // G)
    q = np.arange(G * T)
    g = np.arange(groups)[:, None]
    keep = np.broadcast_to(q < np.minimum(G, B - g * G) * T, (groups, q.size))
    base = np.broadcast_to(g * G * F, keep.shape)[keep]
    return _vector_elements(base, np.broadcast_to(q, keep.shape)[keep], plan, F).reshape(-1)


def _scatter_cover(plan, N, R):
    """How often each element (n, r) of the rows is added (or stored)."""
    items = _thread_items(N * plan.per_row, plan, SCATTER_ILP[plan.private > 0])
    n, c = items // plan.per_row, (items % plan.per_row) * plan.vec
    el = (n[:, None] * R + c[:, None] + np.arange(plan.vec)[None, :]).reshape(-1)
    return np.bincount(el, minlength=N * R)


GATHER_KINDS = [
    ("l2", pr.MODE_ROW, pr.SOURCE_L2, {}),
    ("l2x8", pr.MODE_ROW, pr.SOURCE_L2, {"unroll": 8}),
    ("l2x1", pr.MODE_ROW, pr.SOURCE_L2, {"unroll": 1}),
    ("window", pr.MODE_WINDOW, pr.SOURCE_L2, {}),
    ("window_aligned", pr.MODE_WINDOW, pr.SOURCE_L2, {"flags": pr.FLAG_ALIGNED}),
    ("copy", pr.MODE_COPY, pr.SOURCE_L2, {}),
    ("lane", pr.MODE_LANE, pr.SOURCE_L2, {}),
    ("shared", pr.MODE_ROW, pr.SOURCE_SHARED, {}),
    ("async1", pr.MODE_ROW, pr.SOURCE_ASYNC, {"in_flight": 1}),
    ("async16", pr.MODE_ROW, pr.SOURCE_ASYNC, {"in_flight": 16}),
    ("async17", pr.MODE_ROW, pr.SOURCE_ASYNC, {"in_flight": 17}),
    ("async32", pr.MODE_ROW, pr.SOURCE_ASYNC, {"in_flight": 32}),
    ("async64", pr.MODE_ROW, pr.SOURCE_ASYNC, {"in_flight": 64}),
    ("async200", pr.MODE_ROW, pr.SOURCE_ASYNC, {"in_flight": 200}),
]


def _kind_plan(kind, B, S, F, align=16, n_sms=132):
    """The plan of one of GATHER_KINDS (its flags from its keywords) for B
    rows of an (S, F) table, pointers ``align``-byte aligned."""
    _, mode, source, kw = next(k for k in GATHER_KINDS if k[0] == kind)
    kw = dict(kw)
    flags = kw.pop("flags", 0)
    return pr.gather_plan(B, S, F, mode, source, flags, align, align, n_sms, **kw)


def _kind_rows(kind, B):
    """B rounded up to the rows a call of the kind's mode takes: whole
    windows of 8 (WINDOW), whole tiles (COPY)."""
    mode = next(k for k in GATHER_KINDS if k[0] == kind)[1]
    unit = {pr.MODE_WINDOW: 8, pr.MODE_COPY: pr.TILE}.get(mode, 1)
    return -(-B // unit) * unit


@pytest.mark.parametrize("align", [4, 8, 16])
@pytest.mark.parametrize("F", [1, 2, 3, 4, 6, 8, 128])
@pytest.mark.parametrize("kind", [k[0] for k in GATHER_KINDS])
def test_gather_plan_vector_width_follows_f_and_alignment(kind, F, align):
    _, mode, source, kw = next(k for k in GATHER_KINDS if k[0] == kind)
    S = 64
    plan = _kind_plan(kind, 4096, S, F, align)
    if mode == pr.MODE_LANE:
        assert plan.vec == (4 if F % 4 == 0 and align == 16 else 1)
        assert plan.per_row == -(-F // 4)
    elif mode == pr.MODE_COPY:  # the tile is one flat run of TILE F floats
        assert plan.vec == max(v for v in (1, 2, 4) if align % (4 * v) == 0)
        assert plan.per_row * plan.vec == pr.TILE * F
    else:
        assert F % plan.vec == 0 and align % (4 * plan.vec) == 0
        wider = [v for v in (2, 4) if v > plan.vec and F % v == 0 and align % (4 * v) == 0]
        assert not wider, "the plan must take the widest vector allowed"
    if mode == pr.MODE_WINDOW:
        assert plan.per_row * plan.vec == 8 * F
    if mode == pr.MODE_ROW and source == pr.SOURCE_L2:
        transposed = pr.gather_plan(4096, S, F, mode, source, pr.FLAG_TRANSPOSED, align, align, **kw)
        assert transposed.vec == 1


@pytest.mark.parametrize("n_sms", [8, 114, 132])
@pytest.mark.parametrize("kind", [k[0] for k in GATHER_KINDS])
def test_gather_plan_grid_and_shared_memory_fit_the_card(kind, n_sms):
    _, mode, source, kw = next(k for k in GATHER_KINDS if k[0] == kind)
    for B in (1, 7, 2**18 + 3, 2**24, 2**31 - 1):
        for F in (1, 2, 8, 56):
            S = 1024 if source == pr.SOURCE_SHARED else 2**23
            if source == pr.SOURCE_SHARED and not pr.fits_shared(S * F):
                continue  # the wrapper refuses it
            plan = _kind_plan(kind, _kind_rows(kind, B), S, F, 16, n_sms)
            assert 1 <= plan.grid <= n_sms * plans.SM_BLOCKS
            assert plan.grid * plan.threads <= n_sms * plans.SM_THREADS
            assert plan.smem_bytes <= BLOCK_SHARED_LIMIT
            assert plan.threads <= 1024
            if plan.smem_bytes:
                assert -(-plan.grid // n_sms) * (plan.smem_bytes + 1024) <= plans.SM_SHARED_BYTES


def test_tile_sum_plan_takes_a_block_a_tile():
    """A block a tile; its shared copy (F features of TILE + TILE_SUM_PAD
    floats) and a chunk's mbarrier each fit a block up to F = 28."""
    for F in (1, 8, 28):
        plan = pr.gather_plan(4 * pr.TILE, 4096, F, pr.MODE_TILE_SUM)
        assert plan.grid == 4 and plan.smem_bytes == 4 * (pr.TILE + pr.TILE_SUM_PAD) * F
        assert plan.smem_bytes + 8 * plan.chunks <= BLOCK_SHARED_LIMIT
        assert pr.tile_sum_fits(F)
    assert not pr.tile_sum_fits(29)


PLAN_SIZES = (0, 1, 31, 33, 2**17 + 5)


@pytest.mark.parametrize("B", PLAN_SIZES)
def test_tile_sum_plan_chunks_cover_the_tile(B):
    """TILE_SUM (csrc/probe_rows.cu, gather_tile_sum_chunked): B // TILE
    blocks of a summing warp and TILE / chunks gathering threads; thread t
    of the gatherers takes row c * (TILE / chunks) + t of chunk c, so the
    chunks cover the tile once; the summing warp has a lane a feature, the
    gatherers a thread for each zero of rows 1-7; each feature's column
    starts 16-byte aligned and 8 features' float4 reads fall on distinct
    banks; shared memory within a block's limit; rows read as the widest
    vector F and the alignment allow (one float at a time transposed)."""
    for F in range(1, 9):
        for align in (4, 8, 16):
            plan = pr.gather_plan(B, 2**15, F, pr.MODE_TILE_SUM, table_align=align)
            per_chunk = pr.TILE // plan.chunks
            assert plan.grid == (B // pr.TILE if B else 0)
            assert plan.chunks == pr.TILE_SUM_CHUNKS and plan.chunks * per_chunk == pr.TILE
            assert plan.threads == pr.TILE_SUM_THREADS == 32 + per_chunk <= 1024
            rows = (np.arange(plan.chunks)[:, None] * per_chunk + np.arange(per_chunk)[None, :]).reshape(-1)
            assert (np.bincount(rows, minlength=pr.TILE) == 1).all()
            assert F <= 32 and 7 * F <= per_chunk
            ld = pr.TILE + pr.TILE_SUM_PAD
            assert (4 * ld) % 16 == 0 and len({(f * ld) % 32 // 4 for f in range(8)}) == 8
            assert plan.smem_bytes == 4 * F * ld and plan.smem_bytes + 8 * plan.chunks <= BLOCK_SHARED_LIMIT
            assert F % plan.vec == 0 and align % (4 * plan.vec) == 0
            assert not [v for v in (2, 4) if v > plan.vec and F % v == 0 and align % (4 * v) == 0]
            transposed = pr.gather_plan(B, 2**15, F, pr.MODE_TILE_SUM, pr.SOURCE_L2, pr.FLAG_TRANSPOSED, align)
            assert transposed.vec == 1


def _dot_cover(plan, B):
    """How often each output element (b, c) of the gather-dot is written:
    warp w of the grid takes groups w, w + n_warps, ... of 32 samples; it
    steps through a group's n samples ``in_flight`` at a time, sample j0 + u
    read from lane j0 + u of the group's index load; lane l writes columns
    4l .. 4l + 3 of each sample below n."""
    n_warps = plan.grid * plan.threads // 32
    assert plan.threads % 32 == 0 and n_warps > 0
    U = plan.in_flight
    assert 32 % U == 0
    samples = []
    for w in range(min(n_warps, -(-B // 32))):
        for g in range(w, -(-B // 32), n_warps):
            n = min(32, B - 32 * g)
            for j0 in range(0, n, U):
                assert j0 + U <= 32  # the lanes the batch's shuffles read
                samples.extend(32 * g + j for j in range(j0, j0 + U) if j < n)
    samples = np.asarray(samples, np.int64)
    cols = (4 * np.arange(32)[:, None] + np.arange(4)[None, :]).reshape(-1)
    assert (np.bincount(cols, minlength=pr.DOT_COLS) == 1).all()
    return np.bincount(samples, minlength=B)


@pytest.mark.parametrize("B", PLAN_SIZES)
def test_dot_plan_grid_in_flight_and_cover(B):
    """The gather-dot's plan (csrc/probe_rows.cu, gather_dot_warps): at
    most DOT_BLOCKS_PER_SM blocks an SM and no more than the groups need;
    64 row values in flight a warp at F = 1, 2, 4, 8 (at least 4 samples),
    4 samples at another F; rows as the widest vector F and the table's
    alignment allow; every sample written once."""
    for F in range(1, 9):
        for align in (4, 16):
            plan = pr.dot_plan(B, 2**15, F, align, 132)
            assert plan.threads == pr.DOT_THREADS == 256
            if B == 0:
                assert plan.grid == 0
                continue
            assert 1 <= plan.grid <= 132 * pr.DOT_BLOCKS_PER_SM
            assert plan.grid <= -(-B // plan.threads) + 1
            assert plan.grid * plan.threads <= 132 * plans.SM_THREADS
            assert plan.in_flight >= 4 and 32 % plan.in_flight == 0
            if F in (1, 2, 4, 8):
                assert plan.in_flight == min(32, 64 // F)
            assert F % plan.vec == 0 and align % (4 * plan.vec) == 0
            if align == 16:
                assert (_dot_cover(plan, B) == 1).all()
    big = pr.dot_plan(2**17, 2**15, 8, 16, 132)
    assert big.grid == 132 * pr.DOT_BLOCKS_PER_SM and big.vec == 4 and big.in_flight == 8
    assert list(big.args) == [getattr(big, f) for f in pr.DotPlan.FIELDS]


@pytest.mark.parametrize("B", SIZES)
@pytest.mark.parametrize("kind", [k[0] for k in GATHER_KINDS])
def test_gather_plan_covers_every_output_element_once(kind, B):
    """Every output element written once by the loops of the kind's kernel
    (module docstring), B rounded up to the rows the mode takes: 0, 8 and
    2^18 + 8 for WINDOW, 0, TILE and 129 TILE for COPY."""
    B = _kind_rows(kind, B)
    for F in (1, 2, 3, 8):
        plan = _kind_plan(kind, B, 512, F)
        if B == 0:
            assert plan.grid == 0
            continue
        cover = _gather_cover(plan, B, F)
        assert cover.shape == (B * F,) and (cover == 1).all()


def test_window_and_copy_plans_at_the_probe_shapes():
    """P10 / P15 (2^17 rows of an (2^15, 8) table): float4 vectors, 16 a
    window, WINDOW_VECTORS (K) a lane, the grid-stride grid of 2^18 / 32 K
    warps; P12: float4 vectors, 4,096 a tile, 8 groups of them (8 tiles a
    thread) in 128 blocks, about one an SM."""
    for flags in (0, pr.FLAG_ALIGNED):
        p = pr.gather_plan(2**17, 2**15, 8, pr.MODE_WINDOW, pr.SOURCE_L2, flags, 16, 16, 132)
        K = pr.WINDOW_VECTORS
        assert (p.vec, p.per_row, p.per_row_shift, p.rows, p.threads) == (4, 16, 4, K, 256)
        assert p.grid == min(2**18 // (32 * K) // 8, 132 * 8) and pr.gather_route(p) == "window"
    c = pr.gather_plan(2**17, 2**15, 8, pr.MODE_COPY, pr.SOURCE_L2, 0, 16, 16, 132)
    assert (c.vec, c.per_row, c.runs, c.rows, c.grid) == (4, 4096, 8, 8, 128) and pr.gather_route(c) == "copy"


@pytest.mark.parametrize("mode", [pr.MODE_WINDOW, pr.MODE_COPY])
def test_transposed_or_feature_major_windows_and_copies_route_to_l2(mode):
    """Only row-major, untransposed WINDOW and COPY calls without
    ``unroll`` take their own kernels; transposed or feature-major ones,
    and those with ``unroll``, stay on the L2 gather (route "l2", the plan
    a grid-stride L2 plan: 1 float a transposed read, 32 x rows rows a
    warp)."""
    own = "window" if mode == pr.MODE_WINDOW else "copy"
    extra = pr.FLAG_ALIGNED if mode == pr.MODE_WINDOW else 0
    for B in (2 * pr.TILE, 2**17):
        for F in (1, 3, 8):
            for flags in (0, pr.FLAG_ROUND_BF16):
                plan = pr.gather_plan(B, 4096, F, mode, pr.SOURCE_L2, flags | extra)
                assert pr.gather_route(plan) == own
                assert plan.route == (pr.ROUTE_WINDOW if mode == pr.MODE_WINDOW else pr.ROUTE_COPY)
            for flags, kw in ((pr.FLAG_TRANSPOSED, {}), (pr.FLAG_FEATURE_MAJOR, {}),
                              (pr.FLAG_TRANSPOSED | pr.FLAG_FEATURE_MAJOR, {}), (0, {"unroll": 8})):
                plan = pr.gather_plan(B, 4096, F, mode, pr.SOURCE_L2, flags | extra, **kw)
                assert pr.gather_route(plan) == "l2" and plan.route == pr.ROUTE_L2
                assert plan.rows == kw.get("unroll", pr.ROWS_PER_THREAD) and plan.planes == 0
                assert plan.vec == (1 if flags & pr.FLAG_TRANSPOSED else plans.vec_width(F, 16))
                assert plan.grid == plans.stride_grid(32 * -(-B // (32 * plan.rows)), 256, pr.N_SMS)


@pytest.mark.parametrize("mode", [pr.MODE_WINDOW, pr.MODE_COPY])
def test_windows_and_copies_of_2_31_values_or_more_route_to_l2(mode):
    """The WINDOW and COPY kernels index the output's values in 32 bits, so
    a call of B F >= 2^31 values takes the L2 gather (which indexes rows),
    and one just below stays on its own kernel; the plan alone decides it
    (no allocation here: F = 8, B near 2^28)."""
    step = 8 if mode == pr.MODE_WINDOW else pr.TILE
    own = "window" if mode == pr.MODE_WINDOW else "copy"
    for B, F, route in ((2**28 - step, 8, own), (2**28, 8, "l2"), (2**28 + step, 8, "l2"), (2**29 - step, 8, "l2"),
                        (2**31 - step, 1, own)):
        plan = pr.gather_plan(B, 2**15, F, mode, pr.SOURCE_L2, 0, 16, 16, 132)
        assert pr.gather_route(plan) == route, (B, F)
        if route == "l2":
            assert plan.rows == pr.ROWS_PER_THREAD and plan.grid == plans.stride_grid(32 * -(-B // 128), 256, 132)


def test_every_plan_names_its_route_once():
    """``route`` is the only field the kernel's dispatcher reads to pick a
    kernel: each kind's plan names the kernel its loops model
    (``_gather_cover``), and the indices and names of GATHER_ROUTES agree."""
    assert len(set(pr.GATHER_ROUTES)) == len(pr.GATHER_ROUTES) == 8
    for name in pr.GATHER_ROUTES:
        assert pr.GATHER_ROUTES[getattr(pr, "ROUTE_" + name.upper())] == name
    want = {"l2": "l2", "l2x8": "l2", "l2x1": "l2", "window": "window", "window_aligned": "window", "copy": "copy",
            "lane": "lane", "shared": "shared"}
    for kind, *_ in GATHER_KINDS:
        plan = _kind_plan(kind, _kind_rows(kind, 4096), 512, 8)
        assert pr.gather_route(plan) == want.get(kind, "async"), kind
    assert pr.gather_route(pr.gather_plan(4 * pr.TILE, 4096, 8, pr.MODE_TILE_SUM)) == "tile_sum"
    assert pr.gather_route(pr.gather_plan(2**17, 2**10, 8, pr.MODE_ROW, pr.SOURCE_L2, PLANE_FLAGS)) == "planes"


SHARED_TABLES = [(4096, 8), (1024, 8), (4096, 2), (7263, 8), (7264, 8), (4097, 3), (256, 128)]


@pytest.mark.parametrize("S, F", SHARED_TABLES)
def test_shared_plan_rows_grid_and_shared_bytes(S, F):
    """SHARED (csrc/probe_rows.cu: gather_rows_shared), aligned or not, at
    tables up to the 232,448-byte limit (7,264 x 8) and of 4 S F bytes no
    multiple of 16 (4,097 x 3): the fewest rows a thread (1, 2, 4, 8) with
    which a block an SM covers B; blocks of 1,024 threads, as many as the
    card holds at once at the table's shared bytes and no more than the
    rows need; shared bytes the table, within a block's limit; F / vec
    vectors a row."""
    for align in (4, 16):
        for B in (0, 1, 3, 2**16 + 3, 2**18, 2**24):
            for n_sms in (8, 132):
                plan = pr.gather_plan(B, S, F, pr.MODE_ROW, pr.SOURCE_SHARED, 0, align, 16, n_sms)
                assert plan.rows == min([r for r in (1, 2, 4, 8) if n_sms * 1024 * r >= B] + [8])
                assert plan.threads == pr.SHARED_THREADS == 1024
                assert plan.smem_bytes == 4 * S * F <= BLOCK_SHARED_LIMIT
                assert plan.per_row * plan.vec == F and align % (4 * plan.vec) == 0
                need = -(-(-(-B // (32 * plan.rows))) // 32)  # blocks of 32 warps the rows need
                resident = n_sms * plans.resident_blocks(1024, plan.smem_bytes)
                assert plan.grid == (min(resident, need) if B else 0) and pr.gather_route(plan) == "shared"


def test_shared_plan_at_the_probe_shapes():
    """P2 (2^18 rows of an (4,096, 8) table, 128 KB) and P18 (2^17 rows of
    (1,024, 8), 32 KB): 2 and 1 rows a thread, 128 blocks of 1,024 threads
    (the rows' need, under the card's 132 blocks of 128 KB and 264 of 32
    KB), float4 copies and stores."""
    p2 = pr.gather_plan(2**18, 4096, 8, pr.MODE_ROW, pr.SOURCE_SHARED, 0, 16, 16, 132)
    assert (p2.rows, p2.grid, p2.vec, p2.per_row, p2.smem_bytes) == (2, 128, 4, 2, 131072)
    p18 = pr.gather_plan(2**17, 1024, 8, pr.MODE_ROW, pr.SOURCE_SHARED, pr.FLAG_ROUND_BF16, 16, 16, 132)
    assert (p18.rows, p18.grid, p18.vec, p18.smem_bytes) == (1, 128, 4, 32768)


@pytest.mark.parametrize("G", [1, 16, 17, 64, 1024])
def test_async_plan_blocks_and_shared_bytes(G):
    """ASYNC (csrc/probe_rows.cu: gather_rows_async): a copy group of G
    rows a warp; blocks of W <= 8 whole warps, W groups of shared memory
    within a block's limit (ValueError where one group does not fit); at
    most the blocks the card holds and no more than a group a warp needs."""
    for F in (1, 3, 8, 56, 128):
        gb = 4 * G * F
        if gb > BLOCK_SHARED_LIMIT:
            with pytest.raises(ValueError, match="does not fit"):
                pr.gather_plan(4096, 2**15, F, pr.MODE_ROW, pr.SOURCE_ASYNC, 0, 16, 16, 132, in_flight=G)
            continue
        for B in (0, 1, G - 1, G + 1, 2**17, 2**24):
            plan = pr.gather_plan(B, 2**15, F, pr.MODE_ROW, pr.SOURCE_ASYNC, 0, 16, 16, 132, in_flight=G)
            W = plan.threads // 32
            assert plan.threads % 32 == 0 and W == min(pr.ASYNC_WARPS, BLOCK_SHARED_LIMIT // gb) == pr.async_warps(F, G)
            assert plan.smem_bytes == W * gb <= BLOCK_SHARED_LIMIT and plan.in_flight == G
            assert plan.per_row * plan.vec == F and pr.gather_route(plan) == "async"
            groups = -(-B // G)
            want = min(-(-groups // W), 132 * plans.resident_blocks(plan.threads, plan.smem_bytes))
            assert plan.grid == (want if B else 0)


def test_async_plan_at_the_probe_shapes():
    """P8 (2^17 rows in groups of 16, 512 bytes) and P9 (groups of 64, 2
    KB), F = 8: blocks of 8 warps, a warp a group, 1,024 and 256 blocks;
    2^24 rows of F = 2 in groups of 64: the card's wave of 1,056 blocks
    (31 groups a warp)."""
    p8 = pr.gather_plan(2**17, 2**15, 8, pr.MODE_ROW, pr.SOURCE_ASYNC, 0, 16, 16, 132, in_flight=16)
    assert (p8.threads, p8.grid, p8.smem_bytes) == (256, 1024, 4096)
    p9 = pr.gather_plan(2**17, 2**15, 8, pr.MODE_ROW, pr.SOURCE_ASYNC, 0, 16, 16, 132, in_flight=64)
    assert (p9.threads, p9.grid, p9.smem_bytes) == (256, 256, 16384)
    big = pr.gather_plan(2**24, 2**15, 2, pr.MODE_ROW, pr.SOURCE_ASYNC, 0, 16, 16, 132, in_flight=64)
    assert (big.threads, big.grid) == (256, 1056)


@pytest.mark.parametrize("op", [pr.OP_ADD, pr.OP_STORE_LAST])
@pytest.mark.parametrize("align", [4, 8, 16])
@pytest.mark.parametrize("R", [1, 2, 3, 4, 8, 128])
def test_scatter_plan_vector_width_follows_r_and_alignment(R, align, op):
    plan = pr.scatter_plan(4096, 64, R, pr.ACC_GLOBAL, 132, align, op)
    assert R % plan.vec == 0 and align % (4 * plan.vec) == 0
    assert not [v for v in (2, 4) if v > plan.vec and R % v == 0 and align % (4 * v) == 0]
    assert plan.per_row == R // plan.vec
    assert plan.per_row_shift == (plan.per_row.bit_length() - 1 if plan.per_row & (plan.per_row - 1) == 0 else -1)


@pytest.mark.parametrize("n_sms", [8, 132])
@pytest.mark.parametrize("acc", [pr.ACC_GLOBAL, pr.ACC_SHARED])
def test_scatter_plan_bounds_the_private_flush(acc, n_sms):
    """Privatise P blocks only with P * S * R flush entries at most an
    eighth of the N * R adds and at least a block an SM; the copy fits a
    block; the grid fits the card."""
    seen_private = False
    for N in (0, 1, 7, 2**17, 2**18 + 3, 2**24):
        for S in (1, 64, 4096, 2**13):
            for R in (1, 2, 8):
                if not pr.fits_shared(S * R):
                    continue
                plan = pr.scatter_plan(N, S, R, acc, n_sms)
                assert plan.grid * plan.threads <= n_sms * plans.SM_THREADS
                if plan.private:
                    seen_private = True
                    assert acc == pr.ACC_SHARED
                    assert plan.private * S * R * pr.FLUSH_SHARE <= N * R
                    assert n_sms <= plan.private == plan.grid
                    assert plan.smem_bytes == 4 * S * R <= BLOCK_SHARED_LIMIT
                    per_sm = -(-plan.grid // n_sms)
                    assert per_sm * (plan.smem_bytes + 1024) <= plans.SM_SHARED_BYTES
                else:
                    assert plan.smem_bytes == 0
                    if acc == pr.ACC_SHARED:
                        assert N // (pr.FLUSH_SHARE * S) < n_sms
    assert seen_private == (acc == pr.ACC_SHARED)


def test_scatter_plan_at_the_probe_shapes():
    """P3 (2^18 rows of 8 into 4,096 slots: 64 a slot) privatises nothing;
    the sweep's 2^24 rows of 2 into 4,096 slots privatise two blocks of
    1,024 threads an SM (of the 512 that the flush bound would allow)."""
    assert pr.scatter_plan(2**18, 4096, 8, pr.ACC_SHARED).private == 0
    plan = pr.scatter_plan(2**24, 4096, 2, pr.ACC_SHARED)
    assert plan.private == 2 * pr.N_SMS and plan.threads == pr.PRIVATE_THREADS == 1024
    assert plan.vec == 2 and plan.per_row == 1


def _store_last_cover(plan, N, S, R):
    """STORE_LAST (csrc/probe_rows.cu: store_last_claim, store_last_slots):
    how often the claim reads each index (a thread one, grid-stride over
    ``claim_grid`` blocks) and how often the slot pass writes each output
    element (warp w of the grid takes groups w, w + n_warps, ... of 32
    slots; its lanes write the group's n slots' rows as n * per_row
    vectors of ``vec`` floats, vector q at floats q * vec of the group's
    span, SLOT_ILP of them a lane at a time)."""
    claimed = np.bincount(_thread_items(N, type("P", (), {"grid": plan.claim_grid, "threads": plan.threads})()),
                          minlength=N) if N else np.zeros(0, np.int64)
    n_warps = plan.grid * plan.threads // 32
    assert plan.threads % 32 == 0 and n_warps > 0
    written = []
    for g in range(-(-S // 32)):  # warp g % n_warps takes group g
        n = min(32, S - 32 * g)
        n_vec = n * plan.per_row
        for q0 in range(0, n_vec, 32 * SLOT_ILP):
            q = q0 + 32 * np.arange(SLOT_ILP)[:, None] + np.arange(32)[None, :]
            q = q[q < n_vec]
            assert ((q // plan.per_row) < 32).all()  # the lane a vector's winner is shuffled from
            written.append(32 * g * R + (q[:, None] * plan.vec + np.arange(plan.vec)[None, :]).reshape(-1))
    written = np.concatenate(written) if written else np.zeros(0, np.int64)
    return claimed, np.bincount(written, minlength=S * R)


SLOT_ILP = 4  # vectors a lane of store_last_slots has in flight (kSlotIlp)


@pytest.mark.parametrize("N", SIZES)
@pytest.mark.parametrize("acc", [pr.ACC_GLOBAL, pr.ACC_SHARED])
def test_scatter_plan_covers_every_row_element_once(N, acc):
    """ADD adds each element of the rows once; STORE_LAST's claim reads
    each index once and its slot pass writes each output element once,
    N = 0 too (the output is all zeros then), R vectors of the widest
    width R and the alignment allow."""
    for R, align in ((1, 16), (2, 16), (3, 16), (8, 16), (8, 4)):
        for op in (pr.OP_ADD, pr.OP_STORE_LAST):
            plan = pr.scatter_plan(N, 16, R, acc if op == pr.OP_ADD else pr.ACC_GLOBAL, 132, align, op)
            if op == pr.OP_STORE_LAST:
                for S in (1, 16, 33, 4096 + 7):
                    plan = pr.scatter_plan(N, S, R, pr.ACC_GLOBAL, 132, align, op)
                    assert 1 <= plan.grid and plan.grid * plan.threads <= 132 * plans.SM_THREADS
                    assert plan.claim_grid * plan.threads <= 132 * plans.SM_THREADS
                    claimed, written = _store_last_cover(plan, N, S, R)
                    assert (claimed == 1).all() and written.shape == (S * R,) and (written == 1).all()
                    assert (plan.claim_grid == 0) == (N == 0)
                continue
            if N == 0:
                assert plan.grid == 0
                continue
            cover = _scatter_cover(plan, N, R)
            assert cover.shape == (N * R,) and (cover == 1).all()


PLANE_FLAGS = pr.FLAG_TRANSPOSED | pr.FLAG_FEATURE_MAJOR
PLANE_GROUPS = 4  # groups of 32 samples a warp of gather_planes has in flight (kPlaneGroups)


def _plane_cover(plan):
    """How often the plane-staged gather (csrc/probe_rows.cu:
    gather_planes) writes each output element of its (B / TILE, F, TILE)
    output: block k takes work items k, k + grid, ...; item w stages plane
    group w // runs (features planes * (w // runs) ..) and gathers run
    w % runs (samples run * (w % runs) ..); warp k of the block takes the
    run's groups of 32 samples k + n_warps * (u + PLANE_GROUPS * i)."""
    B, F, P = plan.B, plan.F, plan.planes
    n_warps = plan.threads // 32
    items = np.arange((F // P) * plan.runs)
    assert (np.bincount(items % plan.grid, minlength=plan.grid) > 0).all()  # no idle block
    out = []
    for w in items:
        f0, b_begin = (w // plan.runs) * P, (w % plan.runs) * plan.run
        b_end = min(B, b_begin + plan.run)
        n_groups = -(-(b_end - b_begin) // 32)
        groups = []
        for warp in range(n_warps):
            for g0 in range(warp, n_groups, n_warps * PLANE_GROUPS):
                groups += [g0 + n_warps * u for u in range(PLANE_GROUPS) if g0 + n_warps * u < n_groups]
        b = (b_begin + 32 * np.asarray(groups, np.int64)[:, None] + np.arange(32)[None, :]).reshape(-1)
        b = b[b < b_end]
        f = f0 + np.arange(P)
        out.append(((((b[:, None] >> pr.TILE_SHIFT) * F + f[None, :]) << pr.TILE_SHIFT)
                    + (b[:, None] & (pr.TILE - 1))).reshape(-1))
    return np.bincount(np.concatenate(out), minlength=B * F)


@pytest.mark.parametrize("S", [1, 1000, 2**10, 2**15, 58112, 58113])
def test_plane_plan_fits_the_card_and_covers_every_output_element_once(S):
    """The plane-staged gather (ROW of a transposed table into feature-major
    tiles): taken where one plane of S floats fits a block (S <= 58,112)
    and nowhere else (other flags, a second table, ``unroll``); planes
    divides F and fits a block's 232,448 bytes; the layout is the one of
    fewest bytes (``plane_bytes``) among one wave a plane count; grid within
    what the card holds; runs of a multiple of 32 samples; every output
    element written once, for the rule's layout and forced ones."""
    for B in (0, pr.TILE, 3 * pr.TILE, 2**17):
        for F in (1, 2, 3, 4, 8, 12):
            plan = pr.gather_plan(B, S, F, pr.MODE_ROW, pr.SOURCE_L2, PLANE_FLAGS, 16, 16, 132)
            fits = 4 * S <= BLOCK_SHARED_LIMIT
            assert (plan.planes > 0) == fits
            for other in (pr.gather_plan(B, S, F, pr.MODE_ROW, pr.SOURCE_L2, pr.FLAG_TRANSPOSED),
                          pr.gather_plan(B, S, F, pr.MODE_ROW, pr.SOURCE_L2, pr.FLAG_FEATURE_MAJOR),
                          pr.gather_plan(B, S, F, pr.MODE_ROW, pr.SOURCE_L2, PLANE_FLAGS, two_tables=True),
                          pr.gather_plan(B, S, F, pr.MODE_ROW, pr.SOURCE_L2, PLANE_FLAGS, unroll=8)):
                assert other.planes == other.runs == other.run == 0
            if not fits:
                continue
            P = plan.planes
            assert F % P == 0 and plan.smem_bytes == 4 * P * S <= BLOCK_SHARED_LIMIT
            assert plan.threads == pr.PLANE_THREADS and S % plan.vec == 0
            waves = [(p, max(1, min(-(-B // 32), 132 // (F // p))))
                     for p in range(1, F + 1) if F % p == 0 and 4 * p * S <= BLOCK_SHARED_LIMIT]
            layout = pr.plane_layout(B, S, F, 132)
            assert P == layout[0] and layout in waves
            assert pr.plane_bytes(B, S, F, *layout) == min(pr.plane_bytes(B, S, F, *w) for w in waves)
            if B == 0:
                assert plan.grid == 0
                continue
            assert plan.run % 32 == 0 and plan.runs == -(-B // plan.run)
            layouts = [(None, None)] + ([(p, r) for p in range(1, F + 1) if F % p == 0 and 4 * p * S <= BLOCK_SHARED_LIMIT
                                         for r in (1, 3, 300)] if B <= 3 * pr.TILE else [])
            for planes, runs in layouts:
                lp = pr.gather_plan(B, S, F, pr.MODE_ROW, pr.SOURCE_L2, PLANE_FLAGS, 16, 16, 132, planes=planes,
                                    runs=runs) if planes else plan
                assert 1 <= lp.grid <= 132 * plans.resident_blocks(lp.threads, lp.smem_bytes)
                assert -(-lp.grid // 132) * (lp.smem_bytes + 1024) <= plans.SM_SHARED_BYTES or lp.grid <= 132
                if B <= 3 * pr.TILE or (S == 2**10 and F == 8):
                    assert (_plane_cover(lp) == 1).all(), (planes, runs)


def test_plans_are_cached_and_carry_their_array():
    """The wrappers look their plan up once per shape; the C entry point
    reads its fields in order from ``args``."""
    a = pr.gather_plan(2**24, 2**19, 2)
    assert pr.gather_plan(2**24, 2**19, 2) is a
    assert list(a.args) == [getattr(a, f) for f in pr.GatherPlan.FIELDS]
    s = pr.scatter_plan(2**24, 2**19, 2)
    assert list(s.args) == [getattr(s, f) for f in pr.ScatterPlan.FIELDS]
    assert a.args_ptr and s.args_ptr
