"""The port's benchmark entry points against the repo's own: the headline
bench's parser, mode defaults and configs equal the root ``bench.py``'s
for the same argv; its texture equals bench.py's bit for bit; and tiny CPU
runs of ``benchmarks.bench``, ``bench_mlp`` and ``bench_image`` print their
JSON lines with the JAX scripts' metric names and keys. The 3D protocol's
default resolves to the JAX package's gradient classes.

These are CPU runs of the plain versions at toy sizes: their times say
nothing about the card.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import bench as jbench  # noqa: E402
import tcnn_tpu.encodings as jenc  # noqa: E402
import tcnn_tpu_torch.encodings as tenc  # noqa: E402
from tcnn_tpu_torch.benchmarks import bench as tbench  # noqa: E402
from tcnn_tpu_torch.benchmarks import bench_image, bench_mlp  # noqa: E402
from tcnn_tpu_torch.ops import scatter_rows as sr  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

ARGVS = [
    [],
    ["--protocol", "3d"],
    ["--serving"],
    ["--sampler", "stratified", "--scatter-strategy", "auto", "--ema", "0"],
    ["--sampler", "iid"],
    ["--reference-verbatim"],
    ["--protocol", "3d", "--gather-strategy", "quad_fused"],
    ["--protocol", "3d", "--split-state", "off"],
    ["--sampler", "phase_locked", "--locked-rounding", "sr", "--locked-phases", "4"],
    ["--table-dtype", "bfloat16", "--quad-build", "cf", "--layout", "cf", "--strat-accum", "where",
     "--level-split", "off", "--locked-fwd", "packed", "--stratified-variants", "2"],
    ["--width", "32", "--hidden", "3", "--log2-hashmap", "17", "--per-level-scale", "2.0", "--no-ab"],
    ["--protocol", "3d", "--sampler", "stratified", "--ema", "0.9", "--scatter-strategy", "xla_half"],
    ["--serving", "--serving-dtype", "bfloat16", "--sort-batch", "--steps-per-call", "4"],
]


def _resolve(mod, argv):
    args = mod.build_parser().parse_args(argv)
    explicit, scatter = mod.resolve_mode_defaults(args)
    return args, explicit, scatter


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "default")
def test_defaults_and_configs_equal_the_root_bench(argv):
    ja, j_explicit, j_scatter = _resolve(jbench, argv)
    ta, t_explicit, t_scatter = _resolve(tbench, argv)
    t_vars = vars(ta)
    assert t_vars.pop("device") == "cuda"
    assert t_vars == vars(ja)
    assert (t_explicit, t_scatter) == (j_explicit, j_scatter)
    assert tbench.resolve_split_state(ta) == jbench.resolve_split_state(ja)
    assert tbench.build_config(ta, ta.sampler, ta.ema, t_scatter) == jbench.build_config(ja, ja.sampler, ja.ema,
                                                                                         j_scatter)
    # The phase-locked secondary of the 2d default.
    assert tbench.build_config(ta, "phase_locked", 0.99, ta.scatter_strategy) == jbench.build_config(
        ja, "phase_locked", 0.99, ja.scatter_strategy)


def test_parser_has_every_flag_of_the_root_bench():
    def flags(parser):
        return {s for a in parser._actions for s in a.option_strings} - {"-h", "--help"}

    assert flags(tbench.build_parser()) == flags(jbench.build_parser()) | {"--device"}


def test_bench_image_equals_bench_py_bit_for_bit():
    """bench.py builds its texture inside main() (:704-715); run those
    statements of its source and compare."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    block = next(n for n in ast.walk(main) if isinstance(n, ast.If) and "image_np" in ast.unparse(n.body[-1]))
    ns = {"np": np}
    exec(compile(ast.Module(body=block.body, type_ignores=[]), "bench.py", "exec"), ns)
    want = ns["image_np"]
    got = tbench.bench_image()
    assert got.dtype == want.dtype == np.float32 and got.shape == (512, 512, 3)
    assert got.tobytes() == want.tobytes()
    # Not the sample's image: channel 3 differs (sin(2 pi x y 4) vs sin(2 pi (x - y) 3)).
    from tcnn_tpu_torch.samples.mlp_learning_an_image import synthetic_image

    assert not np.array_equal(got[..., 2], synthetic_image()[..., 2])
    np.testing.assert_array_equal(got[..., :2], synthetic_image()[..., :2])


def _run(module, *argv):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-m", module, *argv], cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return r


BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "sampler", "scatter", "ema", "ms_per_step", "ms_blocks"}
SECONDARY_KEYS = {"sampler", "scatter", "ema", "ms_per_step", "ms_blocks", "samples_per_sec", "vs_baseline"}


@pytest.mark.parametrize("protocol", ["2d", "3d", "refverbatim"])
def test_bench_cpu_run_prints_the_root_bench_line(protocol, capsys):
    """The 2d default from the command line; the others in process."""
    argv = ["--device", "cpu", "--batch", "4096", "--steps", "4", "--timing-blocks", "2", "--warmup", "2"]
    if protocol == "3d":
        argv += ["--protocol", "3d", "--log2-hashmap", "12"]
    if protocol == "refverbatim":
        argv += ["--reference-verbatim", "--width", "16"]
    if protocol == "2d":
        r = _run("tcnn_tpu_torch.benchmarks.bench", *argv)
        stdout, stderr = r.stdout, r.stderr
    else:
        tbench.main(argv)
        stdout, stderr = capsys.readouterr()
    lines = stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    metric = {"2d": "image_fit_training_throughput_hashgrid16x2_ffmlp64x2_b2^18",
              "3d": "nerf3d_training_throughput_hashgrid16x2_ffmlp64x2_b2^18",
              "refverbatim": "image_fit_training_throughput_hashgrid16x2_ffmlp64x2_b2^18_refverbatim"}[protocol]
    assert out["metric"] == metric and out["unit"] == "samples/s"
    if protocol == "2d":
        assert set(out) == BENCH_KEYS | {"secondary"} and set(out["secondary"]) == SECONDARY_KEYS
        assert (out["sampler"], out["scatter"], out["ema"]) == ("stratified", "factored_sr", 0.99)
        assert out["secondary"]["sampler"] == "phase_locked"
    else:
        assert set(out) == BENCH_KEYS
    assert len(out["ms_blocks"]) == 2 and np.isfinite(out["value"]) and out["value"] > 0
    assert "card: cpu" in stderr
    if protocol == "3d":
        assert "ignores the TPU execution knobs --split-state" in stderr


def test_bench_training_loss_falls_and_serving_line(monkeypatch):
    """In process: the returned runs carry first and final losses; the
    serving line has the root bench's keys (a 64^2 raster here)."""
    result, runs = tbench.main(["--device", "cpu", "--batch", "4096", "--steps", "8", "--timing-blocks", "2",
                                "--warmup", "2", "--no-ab"])
    assert runs["secondary"] is None and runs["primary"]["final_loss"] < runs["primary"]["first_loss"]
    monkeypatch.setattr(tbench, "SERVING_SIDE", 64)
    monkeypatch.setattr(tbench, "SERVING_REPS", 2)
    result, runs = tbench.main(["--device", "cpu", "--serving", "--timing-blocks", "1", "--log2-hashmap", "10",
                                "--width", "16", "--hidden", "1"])
    assert runs == {}
    assert set(result) == {"metric", "value", "unit", "vs_baseline", "ms_per_raster", "ms_blocks"}
    assert result["metric"] == "flagship_serving_throughput_raster1024_frozen"


def test_steps_per_call_runs_through_training_steps(monkeypatch):
    """--steps-per-call 2 runs its steps through Trainer.training_steps
    (the captured graph on the card; on the CPU a loop of the same steps),
    so the losses equal the one-step-a-call run's: the same batches from
    the same generator."""
    from tcnn_tpu_torch.trainer import Trainer

    argv = ["--device", "cpu", "--batch", "4096", "--steps", "8", "--timing-blocks", "2", "--warmup", "2", "--no-ab"]
    _, one = tbench.main(argv)
    calls = []
    steps = Trainer.training_steps

    def counted(self, batch_fn, n_steps, data=None):
        calls.append(n_steps)
        return steps(self, batch_fn, n_steps, data)

    monkeypatch.setattr(Trainer, "training_steps", counted)
    _, two = tbench.main(argv + ["--steps-per-call", "2"])
    assert calls == [2] * 5
    for key in ("first_loss", "final_loss"):
        assert two["primary"][key] == one["primary"][key]


def test_3d_default_resolves_the_jax_gradient_classes():
    """--protocol 3d: phase_locked with locked_rounding single. The port's
    encoding snaps the same levels, locks the same levels at the 2^18 =
    64^3 batch and gives them the single class (RN contributions, fp32
    sums); the other levels take the JAX scatter mode's class."""
    ta, _, t_scatter = _resolve(tbench, ["--protocol", "3d"])
    cfg = tbench.build_config(ta, ta.sampler, ta.ema, t_scatter)["encoding"]
    je = jenc.create_encoding(3, cfg, alignment=16)
    te = tenc.create_encoding(3, cfg, alignment=16)
    np.testing.assert_array_equal(te.scales, np.asarray(je.scales))
    np.testing.assert_array_equal(te.offset_table, np.asarray(je.offset_table))
    locked = te._locked_levels(64)
    assert locked and locked == je._locked_levels(64)
    classes = te.gradient_classes(2**18)
    static = te.scales <= te.raster_max_scale
    for lvl in range(te.n_levels):
        if lvl in locked:
            want = [sr.CONTRIB_RN, sr.ACC_F32]
        elif static[lvl] and int(np.ceil(te.scales[lvl] / 64)) + 1 <= te.stratified_max_variants:
            want = [sr.CONTRIB_NONE, sr.ACC_F32]
        else:
            size = int(te.offset_table[lvl + 1] - te.offset_table[lvl])
            want = list(tenc.grid._MODE_CLASSES[je._scatter_mode(2**18, size)])
        assert list(classes[lvl]) == want, lvl


def test_bench_mlp_cpu_run():
    r = _run("tcnn_tpu_torch.benchmarks.bench_mlp", "--device", "cpu", "--batch", "256", "--iters", "1",
             "--widths", "16")
    entries = [json.loads(line) for line in r.stdout.strip().splitlines()]
    assert {(e["method"], e["mode"]) for e in entries} == {
        (m, mode) for m in ("fully_fused", "mlp_chain", "fully_fused_packed") for mode in ("inference", "training")}
    for e in entries:
        assert set(e) == {"width", "method", "mode", "batch", "elements_per_second", "blocks"}
        assert e["width"] == 16 and e["batch"] == 256 and e["elements_per_second"] > 0 and len(e["blocks"]) == 3
    assert "fully_fused_cf skipped" in r.stderr


def test_bench_mlp_width128_has_no_packed_method():
    entries = bench_mlp.main(["--device", "cpu", "--batch", "64", "--iters", "1", "--widths", "128"])
    assert {e["method"] for e in entries} == {"fully_fused", "mlp_chain"}


@pytest.mark.parametrize("baseline", [False, True])
def test_bench_image_cpu_run(baseline, tmp_path):
    out = tmp_path / "image.json"
    argv = ["--device", "cpu", "--min-pow", "8", "--max-pow", "8", "--iters", "2", "--out", str(out)]
    entries = bench_image.main(argv + (["--baseline"] if baseline else []))
    assert len(entries) == 1
    e = entries[0]
    assert e["method"] == ("mlp_chain" if baseline else "fully_fused")
    assert e["final_loss"] < e["first_loss"] and e["batch"] == 256
    written = json.loads(out.read_text())
    assert tuple(written[0]) == bench_image.KEYS == ("batch", "training_elements_per_second",
                                                    "inference_elements_per_second", "final_loss", "method")
    assert bench_image.CONFIG_ONEBLOB["encoding"] == {"otype": "OneBlob", "n_bins": 64}


def test_benchmarks_need_a_card_unless_told_cpu():
    code = (
        "from tcnn_tpu_torch.benchmarks import bench, probe_rows\n"
        "for m in (bench, probe_rows):\n"
        "    try:\n"
        "        m.main([])\n"
        "    except RuntimeError as e:\n"
        "        assert 'no CUDA device' in str(e), e\n"
        "    else:\n"
        "        raise AssertionError(m)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_lookup_scatter_times_needs_a_card():
    code = (
        "from tcnn_tpu_torch.benchmarks import lookup_scatter_times as m\n"
        "try:\n"
        "    m.main([])\n"
        "except RuntimeError as e:\n"
        "    assert 'no CUDA device' in str(e), e\n"
        "else:\n"
        "    raise AssertionError('ran without a card')\n"
        "print('ok')\n"
    )
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_lookup_scatter_times_inputs_and_sass_parser():
    """The timed shapes (built here on the CPU at a small batch) and the
    SASS parser."""
    import torch

    from tcnn_tpu_torch.benchmarks import lookup_scatter_times as m

    inputs = m.lookup_inputs(1024, 32, torch.device("cpu"), 0)
    assert list(inputs) == ["flagship stratified", "flagship uniform", "3D model uniform", "flagship raster 32^2"]
    for enc, x, levels, params in inputs.values():
        assert x.shape[1] == enc.n_dims_to_encode and levels.shape == (16, 32) and params.numel() == enc.n_params
    cases = m.scatter_cases(torch.device("cpu"), 0)
    assert [(i.shape[0], r.shape[1], s) for i, r, s, _ in cases.values()] == [
        (2**18, 4, 64), (2**18, 8, 4096), (2**18, 8, 32768), (8192, 8, 65536)]
    sass = "\n".join([
        "        Function : _Z20grid_forward_kernelIfEvv",
        "        /*0000*/                   LDC R1, c[0x0][0x28] ;",
        "        /*0010*/                   CALL.REL.NOINC `($__internal_0_$__cuda_sm20_rem_u64) ;",
        "        Function : _Z5otherv",
        "        /*0000*/                   EXIT ;",
    ])
    assert m.parse_sass(sass) == {
        "_Z20grid_forward_kernelIfEvv": {"instructions": 2, "calls": ["$__internal_0_$__cuda_sm20_rem_u64"]},
        "_Z5otherv": {"instructions": 1, "calls": []}}


def test_grid_second_order_times_needs_a_card():
    code = (
        "from tcnn_tpu_torch.benchmarks import grid_second_order_times as m\n"
        "try:\n"
        "    m.main([])\n"
        "except RuntimeError as e:\n"
        "    assert 'no CUDA device' in str(e), e\n"
        "else:\n"
        "    raise AssertionError('ran without a card')\n"
        "print('ok')\n"
    )
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_grid_second_order_times_inputs_and_report_parsers():
    """The timed operands and calls (built and run here on the CPU at a
    small batch: the wrappers take their plain versions), the row0 level
    table, and the ptxas report parser."""
    import numpy as np
    import torch

    from tcnn_tpu_torch.benchmarks import grid_second_order_times as m

    t = m.inputs(64, torch.device("cpu"), 0)
    enc = t["enc"]
    assert (enc.n_dims_to_encode, enc.n_levels, enc.n_features_per_level, enc.n_params) == (3, 16, 2, 13_044_816)
    assert t["x"].shape == (64, 3) and t["dy"].shape == (64, 32) and t["dy"].dtype == torch.bfloat16
    assert t["cgx"].shape == (64, 3) and t["cgp"].shape == t["params"].shape and t["classes"].shape == (16, 2)
    row0 = t["levels_row0"].numpy().view(np.uint32)
    levels = t["levels"].numpy().view(np.uint32)
    assert (row0[:, 1] == 1).all() and (row0[:, 0] == levels[:, 0]).all() and not row0[:, -2:].any()
    fns = m.cases(t, plain=True)
    assert list(fns) == ["lookup", "table gradient", "G1", "G2 cgx", "G2 cgx+cgp", "G1 row0", "G2 cgx, no scatter",
                         "G2 cgx, row0, no scatter", "lookup row0", "G3 curvature", "G3 every cotangent", "G1 plain",
                         "G2 cgx plain"]
    # row0: every corner reads its level's first row, whose weights sum to 1.
    table = t["params"].view(-1, 2)[torch.from_numpy(levels[:, 0].astype(np.int64))]
    want = table.reshape(1, -1).expand(64, -1)
    torch.testing.assert_close(fns["lookup row0"]().float(), want.bfloat16().float(), rtol=1e-2, atol=1e-2)
    d_params, d_x, d_dy = fns["G2 cgx"]()
    assert d_params.shape == t["params"].shape and d_x.shape == (64, 3) and d_dy.shape == (64, 32)
    assert fns["G2 cgx, no scatter"]()[0] is None
    g3 = fns["G3 curvature"]()
    assert g3[0].shape == t["params"].shape and g3[1].shape == (64, 3) and g3[3] is None
    torch.testing.assert_close(fns["G1"](), fns["G1 plain"]())
    log = "\n".join([
        "ptxas info    : Compiling entry function '_Z26grid_backward_input_kernelIfLi2ELi3EEvv' for 'sm_90a'",
        "ptxas info    : Function properties for _Z26grid_backward_input_kernelIfLi2ELi3EEvv",
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 72 registers, used 1 barriers, 400 bytes cmem[0]",
    ])
    assert m.parse_ptxas(log) == {"_Z26grid_backward_input_kernelIfLi2ELi3EEvv": {
        "registers": 72, "spill_stores": 8, "spill_loads": 4}}



def test_ffmlp_adam_times_needs_a_card():
    code = (
        "from tcnn_tpu_torch.benchmarks import ffmlp_adam_times as m\n"
        "try:\n"
        "    m.main([])\n"
        "except RuntimeError as e:\n"
        "    assert 'no CUDA device' in str(e), e\n"
        "else:\n"
        "    raise AssertionError('ran without a card')\n"
        "print('ok')\n"
    )
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_ffmlp_adam_times_arguments_bounds_and_operands():
    """The parser's defaults, the bounds of every timed shape (the numbers
    chip_smoke.py gives the same kernels), and the operands built here on
    the CPU at small sizes: the weights views of one buffer in
    flat-parameter order, Adam's share of exactly-zero gradients."""
    import torch

    from tcnn_tpu_torch.benchmarks import ffmlp_adam_times as m
    from tcnn_tpu_torch.ops import ffmlp

    args = m.build_parser().parse_args([])
    assert (args.reps, args.seed, args.end_to_end, args.steps) == (20, 0, False, 50)
    args = m.build_parser().parse_args(["--end-to-end", "--steps", "7", "--reps", "3"])
    assert (args.reps, args.end_to_end, args.steps) == (3, True, 7)

    bounds = {k: m.k1_bound(*s) for k, s in m.K1_SHAPES.items()}
    flagship = bounds["flagship B=2^18 32->64x2->16"]
    assert flagship[1] == "bytes" and flagship[0] == pytest.approx((2**18 * 48 * 2 + 7168 * 2) / 3.35e9)
    assert flagship[0] == pytest.approx(0.0075, abs=5e-5)
    assert bounds["raster B=2^20 32->64x2->16"][0] == pytest.approx(4 * flagship[0], rel=1e-3)
    # 128 x 5: 83,968 weights a row, past the bf16 ridge.
    image = bounds["bench_image B=2^18 128->128x5->16"]
    assert image[1] == "operations" and image[0] == pytest.approx(2 * 2**18 * 83968 / 989e9)
    k7 = m.k1_bound(*m.K7_SHAPE[1])
    assert k7[1] == "bytes" and k7[0] == pytest.approx(0.0801, abs=1e-4)
    a, b = (m.adam_bound(n) for n, _ in m.ADAM_SIZES.values())
    assert a[1] == b[1] == "bytes"
    assert a[0] == pytest.approx(715_760 * 36 / 3.35e9) and a[0] == pytest.approx(0.0077, abs=1e-4)
    assert b[0] == pytest.approx(0.1403, abs=1e-4)

    gen = torch.Generator().manual_seed(0)
    x, ws = m.mlp_operands((40, 32, 64, 2, 16), torch.device("cpu"), gen)
    assert x.shape == (40, 32) and x.dtype == torch.bfloat16
    assert [tuple(w.shape) for w in ws] == [(64, 32), (64, 64), (16, 64)]
    assert ffmlp.flat_weights(ws).data_ptr() == ws[0].data_ptr()
    opt, state, params, grads = m.adam_operands(1000, 100, torch.device("cpu"), 0)
    assert params.shape == grads.shape == (1000,) and opt.n_matrix_weights == 100
    assert (grads[:100] != 0).all() and 0 < int((grads[100:] == 0).sum()) < 300


def test_grid_ab_times_needs_a_card_and_names_kernels():
    """The grid A/B entry point refuses to run without a card (its times
    and compiler report are the card's), and shortens the compiler's
    demangled names to the kernel and its template arguments."""
    import torch

    from tcnn_tpu_torch.benchmarks import grid_ab_times as m

    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA"):
            m.main([])
    assert m._kernel("void <unnamed>::grid_forward_kernel<float, (int)2, (int)2, (bool)0>(const void *, int)") == (
        "grid_forward_kernel<float, (int)2, (int)2, (bool)0>")
    assert m._kernel("void <unnamed>::fold_bf16_kernel(float *, long)") == "fold_bf16_kernel"
