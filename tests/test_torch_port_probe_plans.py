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
  warps), a thread 4 lanes of a row (LANE) or one row (SHARED, ASYNC),
  grid-stride over ``grid * threads`` threads; a scatter thread takes items
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
    """How often each output element (b, f) is written."""
    if plan.mode == pr.MODE_LANE:
        items = _thread_items(B * plan.per_row, plan)
        b, q = items // plan.per_row, items % plan.per_row
        lanes = q[:, None] * 4 + np.arange(4)[None, :]
        keep = lanes < F
        el = (b[:, None] * F + lanes)[keep]
    elif plan.source == pr.SOURCE_L2:
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
    else:  # SHARED, ASYNC: one row a thread
        rows = _thread_items(B, plan)
        el = (rows[:, None] * F + np.arange(F)[None, :]).reshape(-1)
    return np.bincount(el, minlength=B * F)


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
    ("lane", pr.MODE_LANE, pr.SOURCE_L2, {}),
    ("shared", pr.MODE_ROW, pr.SOURCE_SHARED, {}),
    ("async16", pr.MODE_ROW, pr.SOURCE_ASYNC, {"in_flight": 16}),
    ("async64", pr.MODE_ROW, pr.SOURCE_ASYNC, {"in_flight": 64}),
]


@pytest.mark.parametrize("align", [4, 8, 16])
@pytest.mark.parametrize("F", [1, 2, 3, 4, 6, 8, 128])
@pytest.mark.parametrize("kind", [k[0] for k in GATHER_KINDS])
def test_gather_plan_vector_width_follows_f_and_alignment(kind, F, align):
    _, mode, source, kw = next(k for k in GATHER_KINDS if k[0] == kind)
    S = 64
    plan = pr.gather_plan(4096, S, F, mode, source, 0, align, align, **kw)
    if mode == pr.MODE_LANE:
        assert plan.vec == (4 if F % 4 == 0 and align == 16 else 1)
        assert plan.per_row == -(-F // 4)
    else:
        assert F % plan.vec == 0 and align % (4 * plan.vec) == 0
        wider = [v for v in (2, 4) if v > plan.vec and F % v == 0 and align % (4 * v) == 0]
        assert not wider, "the plan must take the widest vector allowed"
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
            plan = pr.gather_plan(B, S, F, mode, source, 0, 16, 16, n_sms, **kw)
            assert 1 <= plan.grid <= n_sms * plans.SM_BLOCKS
            assert plan.grid * plan.threads <= n_sms * plans.SM_THREADS
            assert plan.smem_bytes <= BLOCK_SHARED_LIMIT
            assert plan.threads <= 1024
            if plan.smem_bytes:
                assert -(-plan.grid // n_sms) * (plan.smem_bytes + 1024) <= plans.SM_SHARED_BYTES


def test_tile_sum_plan_takes_a_block_a_tile():
    for F in (1, 8, 28):
        plan = pr.gather_plan(4 * pr.TILE, 4096, F, pr.MODE_TILE_SUM)
        assert plan.grid == 4 and plan.smem_bytes == 4 * pr.TILE * F <= BLOCK_SHARED_LIMIT


@pytest.mark.parametrize("B", SIZES)
@pytest.mark.parametrize("kind", [k[0] for k in GATHER_KINDS])
def test_gather_plan_covers_every_output_element_once(kind, B):
    _, mode, source, kw = next(k for k in GATHER_KINDS if k[0] == kind)
    for F in (1, 2, 3, 8):
        plan = pr.gather_plan(B, 512, F, mode, source, 0, 16, 16, 132, **kw)
        if B == 0:
            assert plan.grid == 0
            continue
        cover = _gather_cover(plan, B, F)
        assert cover.shape == (B * F,) and (cover == 1).all()


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


@pytest.mark.parametrize("N", SIZES)
@pytest.mark.parametrize("acc", [pr.ACC_GLOBAL, pr.ACC_SHARED])
def test_scatter_plan_covers_every_row_element_once(N, acc):
    for R, align in ((1, 16), (2, 16), (3, 16), (8, 16), (8, 4)):
        for op in (pr.OP_ADD, pr.OP_STORE_LAST):
            plan = pr.scatter_plan(N, 16, R, acc if op == pr.OP_ADD else pr.ACC_GLOBAL, 132, align, op)
            if N == 0:
                assert plan.grid == 0
                continue
            cover = _scatter_cover(plan, N, R)
            assert cover.shape == (N * R,) and (cover == 1).all()


def test_plans_are_cached_and_carry_their_array():
    """The wrappers look their plan up once per shape; the C entry point
    reads its fields in order from ``args``."""
    a = pr.gather_plan(2**24, 2**19, 2)
    assert pr.gather_plan(2**24, 2**19, 2) is a
    assert list(a.args) == [getattr(a, f) for f in pr.GatherPlan.FIELDS]
    s = pr.scatter_plan(2**24, 2**19, 2)
    assert list(s.args) == [getattr(s, f) for f in pr.ScatterPlan.FIELDS]
    assert a.args_ptr and s.args_ptr
