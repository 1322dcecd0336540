"""The row gather and scatter probes (P1-P19): the plain versions of
``tcnn_tpu_torch.ops.probe_rows`` against the numpy references of the JAX
package's probes, on inputs made with numpy from a seed.

References: ``benchmarks/probe_mosaic_gather.py:172`` (the row gather of
P1, P2, P4) and :186-188 (P3's ``np.add.at``);
``probe_mosaic_gather2.py:59`` (P5's ``take_along_axis``);
``probe_r5_pallas_gather2.py:75`` (P6-P9's ``table[idx]``; P10 and P11 had
no check there, and are held to their definitions: the 8-row windows and
``table[idx] @ w``); ``probe_r5_pallas_gather3.py:252`` and :311-315 (P17's
gather of the transposed table and its plane layout), :324 (P18's gather
of the bf16 table); P12-P16 by their kernels' loops; P19 by ``np.add.at``
of the bf16-rounded rows per grid step.

Tolerances: every gather, tile sum, copy and STORE_LAST bit-exact (the
tile sum adds in the probe's order); ADD within 1e-6 of the sum of
|contributions| per entry (``index_add_`` and ``np.add.at`` may add in
another order); the gather-dot within 1e-6 of max |ref| (torch's and
numpy's matmuls sum in their own orders).
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from tcnn_tpu_torch.benchmarks import probe_rows as drv
from tcnn_tpu_torch.ops import probe_rows as pr
from tcnn_tpu_torch.ops import scatter_rows as sr

TILE = pr.TILE


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(S=4096, F=8, B=2 * TILE, seed=0):
    r = np.random.default_rng(seed)
    return r.standard_normal((S, F)).astype(np.float32), r.integers(0, S, (B,)).astype(np.int32)


def _assert_add(got, ref, abs_sum):
    assert got.shape == ref.shape
    assert np.all(np.abs(got - ref) <= 1e-6 * abs_sum)


@pytest.mark.parametrize("S", [512, 4096])
def test_row_gather_matches_probe_reference(S):
    """P1, P2, P4 (probe_mosaic_gather.py:169-172) and P6-P9
    (probe_r5_pallas_gather2.py:75): ``table[idx]``."""
    r = np.random.default_rng(0)
    table0 = r.normal(size=(S, 8)).astype(np.float32)
    idx0 = r.integers(0, S, 1024).astype(np.int32)
    ref_gather = table0[idx0]
    np.testing.assert_array_equal(pr.probe_gather_plain(_t(table0), _t(idx0)).numpy(), ref_gather)
    # The wrapper on a CPU tensor is the plain version, whatever the source.
    for source in pr.SOURCE_NAMES:
        np.testing.assert_array_equal(pr.probe_gather(_t(table0), _t(idx0), source=source).numpy(), ref_gather)


def test_row_gather_fills_rows_outside_the_table_with_zeros():
    """P1's ``jnp.take(..., fill_value=0.0)``."""
    table, _ = _inputs(S=64, F=8)
    idx = np.array([-1, 0, 63, 64, 1000, -2**31, 5], np.int32)
    want = np.where(((idx >= 0) & (idx < 64))[:, None], table[np.clip(idx, 0, 63)], 0.0)
    np.testing.assert_array_equal(pr.probe_gather_plain(_t(table), _t(idx)).numpy(), want)


def test_scatter_add_matches_probe_reference():
    """P3 (probe_mosaic_gather.py:186-188): ``np.add.at``."""
    r = np.random.default_rng(0)
    S0, R0, B0 = 512, 8, 1024
    idx0 = r.integers(0, S0, B0).astype(np.int32)
    rows0 = r.normal(size=(B0, R0)).astype(np.float32)
    ref_sc = np.zeros((S0, R0), np.float32)
    np.add.at(ref_sc, idx0, rows0)
    abs_sum = np.zeros((S0, R0), np.float32)
    np.add.at(abs_sum, idx0, np.abs(rows0))
    for acc in (pr.ACC_GLOBAL, pr.ACC_SHARED):
        _assert_add(pr.probe_scatter(_t(idx0), _t(rows0), S0, pr.OP_ADD, acc).numpy(), ref_sc, abs_sum)
    # The generic row scatter (K6's class) on the same inputs.
    _assert_add(sr.scatter_rows(_t(idx0), _t(rows0), S0).numpy(), ref_sc, abs_sum)


@pytest.mark.parametrize("case", [(8, 128, 8, True), (256, 128, 256, True), (4096, 8, 2048, False)])
def test_take_along_axis_matches_probe_reference(case):
    """P5 (probe_mosaic_gather2.py:26-59): per-lane indices take MODE_LANE,
    broadcast row indices MODE_ROW."""
    S, R, B, per_lane = case
    r = np.random.default_rng(0)
    table = r.normal(size=(S, R)).astype(np.float32)
    if per_lane:
        idx = r.integers(0, S, (B, R)).astype(np.int32)
        got = pr.probe_gather_plain(_t(table), _t(idx), pr.MODE_LANE)
    else:
        idx = np.broadcast_to(r.integers(0, S, (B, 1)), (B, R)).astype(np.int32)
        got = pr.probe_gather_plain(_t(table), _t(idx[:, 0].copy()))
    np.testing.assert_array_equal(got.numpy(), np.take_along_axis(table, idx, axis=0))


@pytest.mark.parametrize("aligned", [False, True])
def test_windows_match_their_definition(aligned):
    """P10 ds8 (probe_r5_pallas_gather2.py:281-313, idx clipped to S - 8
    at :304) and P15 ds8_aligned (probe_r5_pallas_gather3.py:198-216):
    out[8i + u] = table[a + u], a = idx[8i] or (idx[8i] // 8) * 8."""
    table, idx = _inputs()
    S = table.shape[0]
    if not aligned:
        idx = np.minimum(idx, S - 8)
    starts = (idx[::8] // 8) * 8 if aligned else idx[::8]
    ref = table[(starts[:, None] + np.arange(8)).reshape(-1)]
    flags = pr.FLAG_ALIGNED if aligned else 0
    np.testing.assert_array_equal(pr.probe_gather_plain(_t(table), _t(idx), pr.MODE_WINDOW, flags=flags).numpy(), ref)


def test_gather_dot_matches_its_definition():
    """P11 fused_dot (probe_r5_pallas_gather2.py:316-354): table[idx] @ w."""
    table, idx = _inputs()
    w = np.random.default_rng(1).standard_normal((8, 128)).astype(np.float32)
    ref = table[idx] @ w
    got = pr.probe_gather_dot(_t(table), _t(idx), _t(w)).numpy()
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("F", [1, 3, 8])
def test_gather_dot_with_rows_outside_the_table_matches_k_fused(F):
    """P11's kernel body ``k_fused`` (probe_r5_pallas_gather2.py:319-331)
    in numpy: per tile of TILE indices, the rows into a scratch buffer (an
    index outside [0, S) reads zeros, as every gather of the port), then
    ``scratch @ w`` in fp32. The plain version and the wrapper on CPU
    tensors within 1e-6 of max |ref| (the matmuls sum in their own orders);
    an outside row's output exactly zero."""
    S, B = 300, 2 * TILE
    r = np.random.default_rng(F)
    table = r.standard_normal((S, F)).astype(np.float32)
    idx = r.integers(-20, S + 20, B).astype(np.int32)
    idx[:3] = (-2**31, 2**31 - 1, S)
    w = r.standard_normal((F, 128)).astype(np.float32)
    ref = np.empty((B, 128), np.float32)
    for g in range(B // TILE):
        scratch = np.zeros((TILE, F), np.float32)
        for i in range(TILE):
            j = idx[g * TILE + i]
            if 0 <= j < S:
                scratch[i] = table[j]
        ref[g * TILE:(g + 1) * TILE] = np.dot(scratch, w)
    outside = (idx < 0) | (idx >= S)
    assert outside.sum() > 50
    for got in (pr.probe_gather_dot_plain(_t(table), _t(idx), _t(w)), pr.probe_gather_dot(_t(table), _t(idx), _t(w))):
        got = got.numpy()
        assert got.shape == (B, 128) and got.dtype == np.float32
        assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()
        assert (got[outside] == 0.0).all()


def test_probe_times_takes_the_probe_runs_inputs():
    """``benchmarks.probe_times`` times P11, P13, P14, P17 at both S2, P2's
    SHARED case, P8-P10, P12 and P15-P18 on ``probe_rows``' own cases, and
    draws P11's inputs for its yardstick as ``probe_rows`` does: on CPU
    tensors the same outputs bit for bit; each profiler marker names its
    kernels; the digests that ``--save`` / ``--compare`` hold tell outputs
    apart."""
    from tcnn_tpu_torch.benchmarks import probe_times as pt

    dev = torch.device("cpu")
    cases = pt.probe_cases(dev)
    assert sorted(cases) == sorted(pt.PROBES) and {"P11", "P13", "P14", "P17 S2=2^10", "P17 S2=2^15"} <= set(cases)
    assert cases["P11"].shape == {"S": 2**15, "F": 8, "B": 2**17}
    table, idx, w = pt.dot_inputs(dev)
    assert torch.equal(pr.probe_gather_dot(table, idx, w), cases["P11"].run())
    assert torch.equal(cases["P13"].run(), pr.probe_gather_plain(table, idx, pr.MODE_TILE_SUM))
    assert cases["P17 S2=2^10"].shape["S"] == 2**10 and cases["P17 S2=2^15"].shape["S"] == 2**15
    assert cases["P2 S=2^12"].source == "shared" and cases["P14"].source == "store_last"
    assert [pt.PROBES[k][2] for k in ("P11", "P13", "P14")] == ["gather_dot", "gather_tile_sum", "store_last"]
    out = {k: cases[k].run() for k in ("P13", "P14")}
    d = pt.digests(out)
    assert d["P13"] != d["P14"] and d == pt.digests({k: v.clone() for k, v in out.items()})


def test_static_copy_and_tile_sum_match_the_probe_loops():
    """P12 static_copy (out[g*TILE + i] = table[i]) and P13 load_only (per
    tile, the in-order sum of table[idx[i]] into row 0 of an 8-row block;
    rows 1-7, which the TPU kernel leaves undefined, are zero here and not
    compared), probe_r5_pallas_gather3.py:137-175."""
    table, idx = _inputs()
    B = idx.shape[0]
    copy = pr.probe_gather_plain(_t(table), _t(idx), pr.MODE_COPY).numpy()
    np.testing.assert_array_equal(copy, table[np.arange(B) % TILE])
    got = pr.probe_gather_plain(_t(table), _t(idx), pr.MODE_TILE_SUM).numpy()
    assert got.shape == (B // TILE * 8, 8)
    for g in range(B // TILE):
        acc = np.zeros(8, np.float32)
        for i in range(TILE):
            acc = acc + table[idx[g * TILE + i]]
        np.testing.assert_array_equal(got[g * 8], acc)
        np.testing.assert_array_equal(got[g * 8 + 1:g * 8 + 8], 0.0)


def test_store_last_matches_the_serial_stores():
    """P14 store_only (probe_r5_pallas_gather3.py:178-195): per tile,
    out[g*TILE + idx[i] % TILE] = table[i] in order, the last write winning;
    slots no index reaches (undefined on the TPU) are zero and not compared."""
    table, idx = _inputs()
    B = idx.shape[0]
    ref = np.zeros((B, 8), np.float32)
    written = np.zeros(B, bool)
    for g in range(B // TILE):
        for i in range(TILE):
            slot = g * TILE + idx[g * TILE + i] % TILE
            ref[slot] = table[i]
            written[slot] = True
    j = np.arange(B)
    slots = ((j // TILE) * TILE + idx % TILE).astype(np.int32)
    got = pr.probe_scatter(_t(slots), _t(table[j % TILE]), B, pr.OP_STORE_LAST).numpy()
    np.testing.assert_array_equal(got[written], ref[written])
    np.testing.assert_array_equal(got[~written], 0.0)


def test_two_streams_match_the_probe_loop():
    """P16 two_stream (probe_r5_pallas_gather3.py:219-240): even rows from
    table, odd rows from table + 1."""
    table, idx = _inputs()
    table2 = table + np.float32(1.0)
    ref = np.where((np.arange(idx.shape[0]) % 2 == 1)[:, None], table2[idx], table[idx])
    got = pr.probe_gather_plain(_t(table), _t(idx), table2=_t(table2)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("log_s2", [10, 12])
def test_transposed_feature_major_gather_matches_probe_reference(log_s2):
    """P17 dyngather_sel (probe_r5_pallas_gather3.py:243-317): the gather of
    table[:S2] given transposed (F, S2), at idx % S2 (:252), written in the
    probe's plane layout (:311-315)."""
    table, idx = _inputs()
    S2, B = 1 << log_s2, idx.shape[0]
    t_t = np.ascontiguousarray(table[:S2].T)
    idx2 = (idx % S2).astype(np.int32)
    exp2 = table[:S2][idx2]
    n_tiles, R8 = B // TILE, TILE // 128
    exp5 = exp2.reshape(n_tiles, R8, 128, 8).transpose(0, 3, 1, 2).reshape(n_tiles * 8 * R8, 128)
    got = pr.probe_gather_plain(_t(t_t), _t(idx2), flags=pr.FLAG_TRANSPOSED | pr.FLAG_FEATURE_MAJOR)
    assert got.shape == (n_tiles, 8, TILE)
    np.testing.assert_array_equal(got.reshape(n_tiles * 8 * R8, 128).numpy(), exp5)


def test_bf16_table_gather_matches_probe_reference():
    """P18 onehot_mxu (probe_r5_pallas_gather3.py:320-358): a one-hot bf16
    product with the bf16-rounded table[:1024] at idx % 1024 (:324), which
    is exactly the gather of the rounded table."""
    table, idx = _inputs()
    t3 = table[:1024]
    idx3 = (idx % 1024).astype(np.int32)
    ref = t3.astype(ml_dtypes.bfloat16).astype(np.float32)[idx3]
    got = pr.probe_gather_plain(_t(t3), _t(idx3), flags=pr.FLAG_ROUND_BF16).numpy()
    np.testing.assert_array_equal(got, ref)


def test_fk_bisect_scatter_matches_add_at():
    """P19 (archive/probe_fk_bisect.py:24-142): per grid step, bf16-rounded
    rows scatter-added into a (1024 x 32, 8) table, the RN class of the
    generic row scatter."""
    r = np.random.default_rng(0)
    grid, nsub, sub, hi, lo, R = 2, 4, 1024, 1024, 32, 8
    idx3 = r.integers(0, hi * lo, (grid, nsub, sub))
    rows = r.normal(size=(grid * nsub * sub, R)).astype(np.float32)
    rounded = rows.astype(ml_dtypes.bfloat16).astype(np.float32)
    ref = np.zeros((grid, hi * lo, R), np.float32)
    abs_sum = np.zeros_like(ref)
    for b in range(grid):
        np.add.at(ref[b], idx3[b].reshape(-1), rounded[b * nsub * sub:(b + 1) * nsub * sub])
        np.add.at(abs_sum[b], idx3[b].reshape(-1), np.abs(rounded[b * nsub * sub:(b + 1) * nsub * sub]))
    flat = (idx3 + np.arange(grid)[:, None, None] * hi * lo).reshape(-1).astype(np.int32)
    got = sr.scatter_rows(_t(flat), _t(rows), grid * hi * lo, sr.CONTRIB_RN).numpy().reshape(grid, hi * lo, R)
    _assert_add(got, ref, abs_sum)


def test_probe_entry_point_checks_and_reports_every_probe(capsys):
    """The probe entry point on the CPU at a small size: every P1-P19 variant is
    checked against its plain version and reported; one JSON line."""
    import json

    result = drv.main(["--device", "cpu", "--log-b", "12", "--log-s", "12", "--reps", "1",
                       "--only", ",".join(n for n in drv.NAMES if n not in ("take", "brk", "rmw", "onehot",
                                                                            "take_along"))])
    ps = {rec["p"] for rec in result["probes"]}
    assert ps == {f"P{i}" for i in range(6, 20)}
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1])["device"] == "cpu"
    assert all("ns/row" in line for line in out[:-1])
    with pytest.raises(SystemExit):
        drv.main(["--device", "cpu", "--only", "nope"])


def test_probe_entry_point_times_the_static_copys_library_call(capsys):
    """P12's library call (``repeat`` of the first tile) joins the probes:
    its time is in the JSON on the CPU too; device times and the host's
    launch costs are the card's only (None here)."""
    result = drv.main(["--device", "cpu", "--log-b", "12", "--log-s", "12", "--reps", "1",
                       "--only", "static_copy,sp_serial"])
    rec = {r["p"]: r for r in result["probes"]}
    assert rec["P12"]["library"] == "repeat" and rec["P12"]["library_ms"] > 0
    assert rec["P6"]["library"] == "index_select" and rec["P6"]["library_ms"] > 0
    assert all(r["device_ms"] is None and r["library_device_ms"] is None for r in result["probes"])
    assert result["host_us"] is None
    table, idx = _inputs(S=4096, F=8, B=2 * TILE)
    got = torch.from_numpy(table)[:TILE].repeat(2, 1).numpy()
    np.testing.assert_array_equal(got, pr.probe_gather_plain(_t(table), _t(idx), pr.MODE_COPY).numpy())
    capsys.readouterr()


def test_sweep_holds_the_3d_models_own_table():
    """The sweep's model point is the 3D model's table (its rows of F = 2),
    gathered from every source and scatter-added, each case matching its
    plain version (here at 2^10 rows into a 1,000-row table on the CPU)."""
    from tcnn_tpu_torch.benchmarks.grid_bwd_plans import ENCODING_3D
    from tcnn_tpu_torch.encodings import create_encoding

    enc = create_encoding(3, ENCODING_3D, alignment=16)
    assert drv.MODEL_3D_ROWS * 2 == enc.n_params
    cases = drv.sweep_cases(torch.device("cpu"), log_bs=(10,), sizes=(), model_rows=(1000,))
    assert [(c.label, c.source) for c in cases] == [
        ("gather S=1000 F=2 B=2^10", "l2"), ("gather S=1000 F=2 B=2^10", "l2 x8"),
        ("gather S=1000 F=2 B=2^10", "async 64 in flight"), ("gather S=1000 F=2 B=2^10", "shared"),
        ("scatter-add S=1000 F=2 B=2^10", "global"), ("scatter-add S=1000 F=2 B=2^10", "shared")]
    assert all(c.shape["S"] == 1000 and c.shape["B"] == 2**10 for c in cases)
    for c in cases:
        drv.check_case(c)
    log_bs, *_, model_rows = drv.sweep_cases.__defaults__
    assert log_bs[-1] == 24 and model_rows == (drv.MODEL_3D_ROWS,)

