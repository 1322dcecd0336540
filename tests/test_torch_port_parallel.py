"""The port's data parallelism and sharded serving
(``tcnn_tpu_torch.parallel.DataParallelTrainer``, ``FrozenServer(mesh=)``)
against the JAX package's (``tcnn_tpu.parallel.DataParallelTrainer`` on
``make_mesh(jax.devices()[:2])``, ``FrozenServer(mesh=)``), on the CPU.

Two gloo ranks are spawned once (``parallel.launch.run_ranks``, a
``file://`` store in the test's temporary directory) and run every case;
they import no JAX. The parent builds each case's inputs (the JAX
package's initial weights, handed to the port through
``params_from_numpy``; the JAX sampler's stratified batches; the JAX
trainer's perturbation uniforms) and compares. The cases and tolerances
are tests/test_parallel.py's:

- bf16 CONFIG (OneBlob + CutlassMLP), 5 steps: loss 5e-2 relative, params
  rtol 2e-2 atol 2e-4; the same in fp32: loss 1e-3, params rtol 1e-3 atol
  1e-5; the ``data_pdf`` variant (fp32): loss 1e-3;
- ``perturbation_sigma`` (fp32): with the JAX trainer's uniforms, loss
  1e-3; with the port's own generator, the loss of the single port trainer
  within 1e-5 (every rank draws the global batch's uniforms);
- the external-gradient step (fp32): params rtol 1e-3 atol 1e-5 of the
  JAX step's (not divided by the degree);
- the stratified factored fast path, the phase-locked path and the
  flagship-like config (stratified, phase-locked, EMA, FullyFusedMLP):
  loss 5e-2, params (and the EMA weights) rtol 2e-2 atol 2e-4; the last two
  in fp32 against the JAX package, and in bf16 against the port's single
  trainer (see CASES);
- every case's DP run against the port's single trainer on the same
  global batches, at the same tolerances (the batch-dependent choices are
  the global batch's);
- inference: rtol 2e-2 atol 2e-4;
- every step issues exactly one ``all_reduce`` (``collectives
  .ALL_REDUCES``); ``shard_batch`` returns views of a tensor on the
  trainer's device; an indivisible batch raises;
- the sharded ``FrozenServer``: a batch and a raster against the JAX
  package's sharded server (bf16 outputs: p99 RAE 1e-2, max 4 bf16 ulps),
  and bitwise the port's single server.
"""

import copy

import numpy as np
import pytest
import torch

import tcnn_tpu_torch as tt
from tcnn_tpu_torch.parallel import DataParallelTrainer, collectives, make_mesh
from tcnn_tpu_torch.parallel.launch import run_ranks

CONFIG = {
    "loss": {"otype": "L2"},
    "optimizer": {"otype": "Adam", "learning_rate": 1e-2},
    "encoding": {"otype": "OneBlob", "n_bins": 8},
    "network": {"otype": "CutlassMLP", "n_neurons": 32, "n_hidden_layers": 1},
}
GRID = {
    "loss": {"otype": "RelativeL2"},
    "optimizer": {"otype": "Adam", "learning_rate": 1e-2},
    "encoding": {"otype": "HashGrid", "n_levels": 5, "n_features_per_level": 2, "log2_hashmap_size": 9,
                 "base_resolution": 4, "per_level_scale": 1.5, "hash": "CoherentAdditive",
                 "gather_strategy": "stratified", "strata": 32, "scatter_strategy": "factored"},
    "network": {"otype": "CutlassMLP", "n_neurons": 16, "n_hidden_layers": 1},
}
LOCKED = {
    "loss": {"otype": "RelativeL2"},
    "optimizer": {"otype": "Adam", "learning_rate": 1e-2},
    "encoding": {"otype": "HashGrid", "n_levels": 6, "n_features_per_level": 2, "log2_hashmap_size": 10,
                 "base_resolution": 4, "per_level_scale": 2.0, "hash": "CoherentAdditive",
                 "gather_strategy": "stratified", "strata": 32, "phase_locked": True, "locked_phases": 4},
    "network": {"otype": "CutlassMLP", "n_neurons": 16, "n_hidden_layers": 1},
}
FLAGSHIP_LIKE = {
    "loss": {"otype": "RelativeL2"},
    "optimizer": {"otype": "EMA", "decay": 0.99,
                  "nested": {"otype": "Adam", "learning_rate": 1e-2, "beta2": 0.99, "epsilon": 1e-15,
                             "l2_reg": 1e-6}},
    "encoding": {"otype": "HashGrid", "n_levels": 16, "n_features_per_level": 2, "log2_hashmap_size": 12,
                 "base_resolution": 16, "per_level_scale": 1.5, "hash": "CoherentAdditive",
                 "gather_strategy": "stratified", "strata": 64, "phase_locked": True, "locked_phases": 1},
    "network": {"otype": "FullyFusedMLP", "n_neurons": 64, "n_hidden_layers": 2},
}
SERVE = {
    "loss": {"otype": "RelativeL2"},
    "optimizer": {"otype": "Adam", "learning_rate": 1e-2},
    "encoding": {"otype": "HashGrid", "n_levels": 8, "n_features_per_level": 2, "log2_hashmap_size": 10,
                 "base_resolution": 4, "per_level_scale": 1.5, "hash": "CoherentAdditive",
                 "gather_strategy": "stratified", "strata": 16},
    "network": {"otype": "FullyFusedMLP", "activation": "ReLU", "output_activation": "None", "n_neurons": 64,
                "n_hidden_layers": 2},
}
SIGMA = 0.1
# case -> (config, seed, precision, tolerances (loss rtol, params rtol,
# atol), held against the JAX package's run too). The phase-locked and
# flagship-like configs meet the JAX package in fp32: in bf16 the two
# libraries' rounding flips, amplified by Adam where a gradient is near
# zero, move 0.4% of their params by up to 2 lr in 3-4 steps
# (tests/test_torch_port_training.py bounds the same); their bf16 runs are
# held to the port's own single trainer, as tests/test_parallel.py holds
# the JAX package's DP to its single trainer. There a rank's MLP backward
# rounds its weight gradient (a sum over its rows) to bf16 once, as the
# single trainer's rounds the sum over all rows, and the two roundings
# differ by a bf16 ulp; Adam turns that into the same flips, so these two
# cases hold 99% of the params to the tolerance and every param to 2 lr a
# step (ROUNDED).
CASES = {
    "bf16": (CONFIG, 11, None, (5e-2, 2e-2, 2e-4), True),
    "fp32": (CONFIG, 11, "float32", (1e-3, 1e-3, 1e-5), True),
    "pdf": (CONFIG, 7, "float32", (1e-3, 1e-3, 1e-5), True),
    "perturbation": (CONFIG, 13, "float32", (1e-3, 1e-3, 1e-5), True),
    "grid_fast_paths": (GRID, 5, None, (5e-2, 2e-2, 2e-4), True),
    "phase_locked": (LOCKED, 5, "float32", (5e-2, 2e-2, 2e-4), True),
    "phase_locked_bf16": (LOCKED, 5, None, (5e-2, 2e-2, 2e-4), False),
    "flagship_like": (FLAGSHIP_LIKE, 5, "float32", (5e-2, 2e-2, 2e-4), True),
    "flagship_like_bf16": (FLAGSHIP_LIKE, 5, None, (5e-2, 2e-2, 2e-4), False),
}
JAX_CASES = [name for name, case in CASES.items() if case[4]]
ROUNDED = ("phase_locked_bf16", "flagship_like_bf16")


def _target(xy):
    return np.stack([xy[:, 0], xy[:, 1], xy.sum(1) / 2], 1).astype(np.float32)


def _jax_model(name):
    """The JAX package's trainer of a case (the perturbation case: built as
    tests/test_parallel.py builds it)."""
    import tcnn_tpu as tc

    cfg, seed, precision = CASES[name][:3]
    kw = {} if precision is None else {"precision": precision}
    if name != "perturbation":
        return tc.create_from_config(2, 3, cfg, seed=seed, **kw).trainer
    from tcnn_tpu.losses import create_loss
    from tcnn_tpu.network_with_input_encoding import NetworkWithInputEncoding
    from tcnn_tpu.optimizers import create_optimizer
    from tcnn_tpu.trainer import Trainer

    model = NetworkWithInputEncoding(2, 3, cfg["encoding"], cfg["network"], precision=precision)
    return Trainer(model, create_optimizer(cfg["optimizer"]), create_loss(cfg["loss"]), seed=seed,
                   perturbation_sigma=SIGMA)


def _batches(name):
    """The case's global batches: (x, targets, pdf or None)."""
    import jax

    from tcnn_tpu.utils.sampling import stratified_uniform

    name = name.removesuffix("_bf16")
    if name in ("grid_fast_paths", "phase_locked", "flagship_like"):
        n, phases = {"grid_fast_paths": (1024, None), "phase_locked": (1024, 4), "flagship_like": (4096, 1)}[name]
        kw = {} if phases is None else {"phase_locked": phases}
        xs = [np.asarray(stratified_uniform(jax.random.PRNGKey(i), n, 2, **kw)) for i in range(4 if n == 1024 else 3)]
        return [(x, _target(x), None) for x in xs]
    r = np.random.default_rng({"bf16": 0, "fp32": 0, "pdf": 2, "perturbation": 4}[name])
    out = []
    for _ in range(5 if name in ("bf16", "fp32") else 3):
        xy = r.uniform(0, 1, (512, 2)).astype(np.float32)
        t = _target(xy)
        pdf = (0.5 + r.uniform(0, 1, t.shape)).astype(np.float32) if name == "pdf" else None
        out.append((xy, t, pdf))
    return out


def _jax_draws(trainer, batches):
    """The JAX trainer's perturbation uniforms, step by step (its carried
    key split once a step; tcnn_tpu/trainer.py:243-256)."""
    import jax
    import jax.numpy as jnp

    key, draws = trainer.state["rng"], []
    for x, _, _ in batches:
        k, key = jax.random.split(key)
        draws.append(np.array(jax.random.uniform(k, (x.shape[0], trainer.model.padded_output_width), jnp.float32,
                                                 1e-9, 1.0 - 1e-9)))
    return draws


def _port_trainer(name, params, seed_only=False):
    cfg, seed, precision = CASES[name][:3]
    if name == "perturbation":
        model = tt.NetworkWithInputEncoding(2, 3, cfg["encoding"], cfg["network"], precision=precision, device="cpu")
        trainer = tt.Trainer(model, cfg["optimizer"], cfg["loss"], seed=seed, perturbation_sigma=SIGMA)
    else:
        trainer = tt.create_from_config(2, 3, cfg, seed=seed, precision=precision, device="cpu").trainer
    if not seed_only:
        trainer.params = tt.params_from_numpy(params, trainer.model)
    return trainer


def _serve_params(model):
    r = np.random.default_rng(5)
    parts = [r.uniform(-np.sqrt(6 / (a + b)), np.sqrt(6 / (a + b)), a * b) for a, b in model.network.layer_sizes()]
    parts.append(r.uniform(-1, 1, model.encoding.n_params))
    return np.concatenate(parts).astype(np.float32)


def _serve_queries():
    r = np.random.default_rng(6)
    return np.concatenate([r.uniform(0, 1, (2048, 2)), r.uniform(-0.25, 1.25, (512, 2))]).astype(np.float32)


def _rank(rank, world, specs):
    """Every case on this rank of a 2-rank mesh: losses, params, all_reduce
    counts; the checks that need no JAX run here."""
    import sys

    assert "jax" not in sys.modules and "tcnn_tpu" not in sys.modules
    mesh = make_mesh(device="cpu")
    out = {}
    for name, spec in specs["cases"].items():
        trainer = _port_trainer(name, spec["params"])
        if name == "perturbation":
            draws = list(spec["draws"])
            trainer.perturbation_uniforms = lambda b, w: torch.from_numpy(draws.pop(0))
        dp = DataParallelTrainer(trainer, mesh)
        single = _port_trainer(name, spec["params"])
        if name == "perturbation":
            single_draws = list(spec["draws"])
            single.perturbation_uniforms = lambda b, w: torch.from_numpy(single_draws.pop(0))
        losses, single_losses, reduces = [], [], []
        for x, t, pdf in spec["batches"]:
            before = collectives.ALL_REDUCES
            losses.append(float(dp.training_step(x, t, pdf)))
            reduces.append(collectives.ALL_REDUCES - before)
            single_losses.append(float(single.training_step(x, t, pdf)))
        out[name] = {"losses": losses, "params": trainer.params.numpy().copy(), "reduces": reduces,
                     "inference_params": trainer.inference_params().numpy().copy(),
                     "single": {"losses": single_losses, "params": single.params.numpy().copy(),
                                "inference_params": single.inference_params().numpy().copy()}}

    # perturbation_sigma with the port's own generator, beside the single
    # port trainer on the same global batches.
    spec = specs["cases"]["perturbation"]
    dp = DataParallelTrainer(_port_trainer("perturbation", None, seed_only=True), mesh)
    single = _port_trainer("perturbation", None, seed_only=True)
    out["own_generator"] = {
        "dp": [float(dp.training_step(x, t)) for x, t, _ in spec["batches"]],
        "single": [float(single.training_step(x, t)) for x, t, _ in spec["batches"]],
    }

    spec = specs["external"]
    trainer = _port_trainer("fp32", spec["params"])
    dp = DataParallelTrainer(trainer, mesh)
    before = collectives.ALL_REDUCES
    dp.training_step_with_gradients(spec["x"], spec["g"])
    out["external"] = {"params": trainer.params.numpy().copy(), "reduces": collectives.ALL_REDUCES - before}

    spec = specs["inference"]
    dp = DataParallelTrainer(_port_trainer("bf16", spec["params"]), mesh)
    out["inference"] = dp.inference(spec["x"]).numpy()
    x = torch.from_numpy(spec["x"])
    view = dp.shard_batch(x)
    out["shard_is_view"] = view._base is x and view.data_ptr() == x[rank * 128].data_ptr()
    try:
        dp.training_step(np.zeros((2 * 4 + 1, 2), np.float32), np.zeros((9, 3), np.float32))
        out["indivisible_raises"] = False
    except ValueError:
        out["indivisible_raises"] = True

    spec = specs["serve"]
    m = tt.create_from_config(2, 3, SERVE, device="cpu")
    m.trainer.params = tt.params_from_numpy(spec["params"], m.model)
    server, single = m.trainer.freeze_serving(mesh=mesh), m.trainer.freeze_serving()
    out["serve"] = {"batch": server(spec["x"]).numpy(), "raster": server.raster(16).numpy(),
                    "single_batch": single(spec["x"]).numpy(), "single_raster": single.raster(16).numpy()}
    assert "jax" not in sys.modules and "tcnn_tpu" not in sys.modules
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each case's inputs; the port's ranks started on them; the JAX
    package's DataParallelTrainer on two devices run on them meanwhile.
    Returns (inputs, the JAX runs, the ranks' results)."""
    import threading

    import jax
    import jax.numpy as jnp

    import tcnn_tpu as tc
    from tcnn_tpu.parallel import DataParallelTrainer as JaxDP
    from tcnn_tpu.parallel import make_mesh as jax_mesh

    specs, trainers = {"cases": {}}, {}
    for name in CASES:
        trainer = trainers[name] = _jax_model(name)
        batches = _batches(name)
        spec = specs["cases"][name] = {"params": np.asarray(trainer.params), "batches": batches}
        if name == "perturbation":
            spec["draws"] = _jax_draws(trainer, batches)
    trainers["external"] = _jax_model("fp32")
    r = np.random.default_rng(5)
    x = r.uniform(0, 1, (256, 2)).astype(np.float32)
    g = r.normal(size=(256, trainers["external"].model.padded_output_width)).astype(np.float32)
    specs["external"] = {"params": np.asarray(trainers["external"].params), "x": x, "g": g}
    trainers["inference"] = _jax_model("bf16")
    x = np.random.default_rng(1).uniform(0, 1, (256, 2)).astype(np.float32)
    specs["inference"] = {"params": np.asarray(trainers["inference"].params), "x": x}
    jm = tc.create_from_config(2, 3, SERVE)
    specs["serve"] = {"params": _serve_params(jm.model), "x": _serve_queries()}

    ranks = []
    thread = threading.Thread(target=lambda: ranks.extend(
        run_ranks(_rank, 2, specs, tmp_dir=tmp_path_factory.mktemp("dp_ranks"))))
    thread.start()
    try:
        mesh = jax_mesh(jax.devices()[:2])
        want = {}
        for name in JAX_CASES:
            dp = JaxDP(trainers[name], mesh)
            losses = [float(dp.training_step(jnp.asarray(x), jnp.asarray(t), None if pdf is None else jnp.asarray(pdf)))
                      for x, t, pdf in specs["cases"][name]["batches"]]
            want[name] = {"losses": losses, "params": np.asarray(trainers[name].params),
                          "inference_params": np.asarray(trainers[name].inference_params())}
        spec = specs["external"]
        JaxDP(trainers["external"], mesh).training_step_with_gradients(jnp.asarray(spec["x"]), jnp.asarray(spec["g"]))
        want["external"] = np.asarray(trainers["external"].state["params"])
        want["inference"] = np.asarray(JaxDP(trainers["inference"], mesh).inference(jnp.asarray(specs["inference"]["x"])))
        jm.trainer.params = jnp.asarray(specs["serve"]["params"])
        server = jm.trainer.freeze_serving(mesh=mesh)
        want["serve"] = {"batch": np.asarray(server(jnp.asarray(specs["serve"]["x"]))),
                         "raster": np.asarray(server.raster(16))}
    finally:
        thread.join()
    assert len(ranks) == 2, "a rank failed"
    return specs, want, ranks


@pytest.fixture(scope="module")
def jax_runs(runs):
    return runs[0], runs[1]


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[2]


def _assert_lockstep(got, want, tolerances, rounded=False):
    loss_rtol, rtol, atol = tolerances
    rel = np.abs(np.subtract(got["losses"], want["losses"])) / np.maximum(np.abs(want["losses"]), 1e-9)
    assert (rel < loss_rtol).all(), (got["losses"], want["losses"])
    for key in ("params", "inference_params"):
        if not rounded:
            np.testing.assert_allclose(got[key], want[key], rtol=rtol, atol=atol)
            continue
        d = np.abs(got[key] - want[key])
        assert np.mean(d <= atol + rtol * np.abs(want[key])) >= 0.99
        assert d.max() <= 2 * 1e-2 * len(got["losses"])


@pytest.mark.parametrize("name", JAX_CASES)
def test_data_parallel_matches_jax(jax_runs, ranks, name):
    for out in ranks:
        _assert_lockstep(out[name], jax_runs[1][name], CASES[name][3])


@pytest.mark.parametrize("name", list(CASES))
def test_data_parallel_matches_the_single_trainer(ranks, name):
    for out in ranks:
        got = out[name]
        assert got["reduces"] == [1] * len(got["losses"])
        _assert_lockstep(got, got["single"], CASES[name][3], rounded=name in ROUNDED)
    np.testing.assert_array_equal(ranks[0][name]["params"], ranks[1][name]["params"])


def test_perturbation_draws_the_global_batch(ranks):
    for out in ranks:
        np.testing.assert_allclose(out["own_generator"]["dp"], out["own_generator"]["single"], rtol=1e-5)


def test_external_gradients_match_jax(jax_runs, ranks):
    for out in ranks:
        assert out["external"]["reduces"] == 1
        assert not np.allclose(out["external"]["params"], jax_runs[0]["external"]["params"])
        np.testing.assert_allclose(out["external"]["params"], jax_runs[1]["external"], rtol=1e-3, atol=1e-5)


def test_inference_matches_jax(jax_runs, ranks):
    for out in ranks:
        assert out["inference"].shape == (256, 3)
        np.testing.assert_allclose(out["inference"], jax_runs[1]["inference"], rtol=2e-2, atol=2e-4)


def test_shard_batch_and_divisibility(ranks):
    for out in ranks:
        assert out["shard_is_view"]
        assert out["indivisible_raises"]


@pytest.mark.parametrize("what", ["batch", "raster"])
def test_sharded_server_matches_jax(jax_runs, ranks, what):
    from test_torch_port_ffmlp import assert_bf16_close

    for out in ranks:
        got = out["serve"][what]
        np.testing.assert_array_equal(got, out["serve"]["single_" + what])
        assert_bf16_close(got, jax_runs[1]["serve"][what])


def test_sharded_server_needs_a_divisible_batch():
    m = tt.create_from_config(2, 3, copy.deepcopy(SERVE), device="cpu")
    server = m.trainer.freeze_serving()
    server._group, server._n, server._index = None, 2, 0
    with pytest.raises(ValueError, match="divisible"):
        server(np.zeros((3, 2), np.float32))
    with pytest.raises(ValueError, match="divisible"):
        server.raster(3)
