"""The row scatter's launch plan (``ops.scatter_rows.scatter_rows_plan``),
a host function, on the CPU.

``tcnn_scatter_rows`` (csrc/grid_bwd.cu) reads the plan's int32 array: the
vector width from R and the rows' alignment, the threads a row, whether
blocks add into private shared-memory copies of the table (fp32 sums only,
where the flushes stay at most an eighth of the adds and every SM gets a
block), the grid and the shared bytes. The kernel itself runs only on the
card (tests/test_torch_port_cuda.py).
"""

import pytest

from tcnn_tpu_torch.ops import _plans as plans
from tcnn_tpu_torch.ops import scatter_rows as sr

ACCS = {"fp32": sr.ACC_F32, "bf16": sr.ACC_BF16, "drop": sr.ACC_DROP}


def test_64_slots_privatised_and_2_14_slots_not():
    private = sr.scatter_rows_plan(2**18, 64, 4)
    assert private.private >= plans.N_SMS and private.threads == plans.PRIVATE_THREADS
    assert private.grid == private.private and private.smem_bytes == 64 * 4 * 4
    spread = sr.scatter_rows_plan(2**18, 2**14, 4)
    assert spread.private == 0 and spread.smem_bytes == 0 and spread.threads == plans.THREADS


@pytest.mark.parametrize("align", [4, 8, 16])
@pytest.mark.parametrize("R", [1, 2, 3, 4, 6, 8, 12, 128])
def test_vector_width_by_row_width_and_alignment(R, align):
    plan = sr.scatter_rows_plan(2**16, 4096, R, align=align)
    want = next(v for v in (4, 2, 1) if R % v == 0 and align % (4 * v) == 0)
    assert plan.vec == want and plan.per_row * plan.vec == R
    assert plan.per_row_shift == (plan.per_row.bit_length() - 1 if plan.per_row & (plan.per_row - 1) == 0 else -1)


@pytest.mark.parametrize("S", [1, 64, 4096, 2**14])
def test_bf16_sums_and_dropped_levels_take_no_private_block(S):
    bf16 = sr.scatter_rows_plan(2**20, S, 4, sr.ACC_BF16)
    assert bf16.private == 0 and bf16.smem_bytes == 0 and bf16.grid > 0
    drop = sr.scatter_rows_plan(2**20, S, 4, sr.ACC_DROP)
    assert drop.private == 0 and drop.grid == 0


@pytest.mark.parametrize("shape", [(2**18, 4096, 8), (2**18, 32768, 8), (8192, 65536, 8)],
                         ids=["P3 S=4096", "P3 S=32768", "P19"])
def test_probe_shapes_take_the_global_path(shape):
    """P3 (2^18 rows of 8 into 4,096 or 32,768 slots: 8 or 1 rows a slot)
    and P19 (8,192 rows into 65,536): too few rows a slot to privatise."""
    N, S, R = shape
    plan = sr.scatter_rows_plan(N, S, R)
    assert plan.private == 0 and plan.vec == 4 and plan.per_row == 2 and plan.per_row_shift == 1
    assert 0 < plan.grid <= plans.N_SMS * plans.SM_THREADS // plans.THREADS


@pytest.mark.parametrize("acc", sorted(ACCS))
@pytest.mark.parametrize("R", [1, 3, 8])
@pytest.mark.parametrize("S", [1, 64, 2**14, 2**20])
@pytest.mark.parametrize("N", [0, 7, 2**18 + 3])
def test_plan_bounds(N, S, R, acc):
    """On cards of 1, 66 and 132 SMs: the flush of the private blocks is at
    most an eighth of the adds and leaves no SM idle; the copy fits a block;
    the grid covers every item or grid-strides over them within what the
    card holds; the int32 array is the fields in order."""
    for n_sms in (1, 66, 132):
        plan = sr.scatter_rows_plan(N, S, R, ACCS[acc], n_sms)
        if plan.private:
            assert ACCS[acc] == sr.ACC_F32
            assert plan.private >= n_sms and plan.private * S * R * plans.FLUSH_SHARE <= N * R
            assert plan.smem_bytes == 4 * S * R <= plans.SHARED_BYTES and plan.grid == plan.private
            assert plan.threads == plans.PRIVATE_THREADS
            assert plan.private <= n_sms * (plans.SM_SHARED_BYTES // (plan.smem_bytes + 1024))
        else:
            assert plan.smem_bytes == 0 and plan.threads == plans.THREADS
            if ACCS[acc] == sr.ACC_DROP or N == 0:
                assert plan.grid == 0
            else:
                items = N * plan.per_row
                assert plan.grid == min(-(-items // plans.THREADS), n_sms * plans.SM_THREADS // plans.THREADS) > 0
        assert list(plan.args) == [getattr(plan, f) for f in sr.ScatterRowsPlan.FIELDS]
        assert (plan.N, plan.S, plan.R, plan.acc) == (N, S, R, ACCS[acc])


def test_plans_are_cached_per_shape():
    assert sr.scatter_rows_plan(2**18, 64, 4) is sr.scatter_rows_plan(2**18, 64, 4)
    assert sr.scatter_rows_plan(2**18, 64, 4) is not sr.scatter_rows_plan(2**18, 64, 4, sr.ACC_BF16)
