"""The serving slice as a whole: the PyTorch port against the JAX package.

A reduced flagship config (same encoding and network kinds, fewer levels
and smaller tables) is built in both packages. The JAX model trains three
steps with an EMA-wrapped Adam; its ``inference_params()`` are carried into
the port with ``params_from_numpy``, as the params of a port trainer whose
optimizer is the nested Adam (an EMA trainer serves its own EMA weights,
which carried params do not set). Then ``inference``,
``inference_raster`` and ``freeze_serving()`` (batch and raster) are
compared.

Tolerance (bf16 network path): ``match_rae(eps=1e-2, percentile=99)`` and
max |diff| <= 4 bf16 ulps of max |ref|. The port's raster is its per-sample
lookup at the tile centers, while the JAX package's raster path uses a
separable static lerp on coarse levels: the same function up to fp32
rounding, which the bf16 rounding of the features then flips now and then.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_ffmlp import assert_bf16_close

import tcnn_tpu as tc
import tcnn_tpu_torch as tt
from tcnn_tpu.utils.sampling import stratified_uniform

STRATA = 16
B = STRATA**2

CONFIG = {
    "loss": {"otype": "RelativeL2"},
    "optimizer": {
        "otype": "EMA", "decay": 0.99,
        "nested": {"otype": "Adam", "learning_rate": 1e-2, "beta1": 0.9, "beta2": 0.99,
                   "epsilon": 1e-15, "l2_reg": 1e-6},
    },
    "encoding": {
        "otype": "HashGrid", "n_levels": 8, "n_features_per_level": 2,
        "log2_hashmap_size": 10, "base_resolution": 4, "per_level_scale": 1.5,
        "hash": "CoherentAdditive", "gather_strategy": "stratified", "strata": STRATA,
    },
    "network": {
        "otype": "FullyFusedMLP", "activation": "ReLU", "output_activation": "None",
        "n_neurons": 64, "n_hidden_layers": 2,
    },
}


@pytest.fixture(scope="module")
def pair():
    jm = tc.create_from_config(2, 3, CONFIG)
    r = np.random.default_rng(0)
    for i in range(3):
        xy = stratified_uniform(jax.random.PRNGKey(i), B, 2)
        t = jnp.asarray(r.uniform(0, 1, (B, 3)).astype(np.float32))
        jm.training_step(xy, t)
    tm = tt.create_from_config(2, 3, dict(CONFIG, optimizer=CONFIG["optimizer"]["nested"]), device="cpu")
    flat = np.asarray(jm.trainer.inference_params())
    # The EMA weights differ from the raw params after training.
    assert not np.array_equal(flat, np.asarray(jm.trainer.params))
    tm.trainer.params = tt.params_from_numpy(flat, tm.model)
    return jm, tm


def _queries(n=2000, seed=1):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.uniform(0, 1, (n, 2)), rng.uniform(-0.25, 1.25, (n // 4, 2)),
    ]).astype(np.float32)


def test_inference_matches_jax(pair):
    jm, tm = pair
    x = _queries()
    want = np.asarray(jm.inference(jnp.asarray(x)))
    got = tm.inference(x)
    assert got.dtype == torch.float32 and got.shape == (len(x), 3)
    assert_bf16_close(got.numpy(), want)
    # Also through the model's own parameter and nn.Module call.
    with torch.no_grad():
        y = tm.model(torch.from_numpy(x))[:, :3].float()
    assert torch.equal(y, got)


@pytest.mark.parametrize("side", [16, (32, 16)])
def test_inference_raster_matches_jax(pair, side):
    jm, tm = pair
    want = np.asarray(jm.trainer.inference_raster(side))
    got = tm.trainer.inference_raster(side)
    n = side * side if isinstance(side, int) else side[0] * side[1]
    assert got.shape == (n, 3) and got.dtype == torch.float32
    assert_bf16_close(got.numpy(), want)


@pytest.mark.parametrize("side", [16, (32, 16)])
def test_frozen_server_matches_jax(pair, side):
    jm, tm = pair
    js, ts = jm.trainer.freeze_serving(), tm.trainer.freeze_serving()
    x = _queries(seed=2)
    assert_bf16_close(ts(x).numpy(), np.asarray(js(jnp.asarray(x))))
    assert_bf16_close(ts.raster(side).numpy(), np.asarray(js.raster(side)))
    # The raster equals the batch path at the raster's tile centers.
    from tcnn_tpu_torch.utils.sampling import raster_centers

    assert torch.equal(ts.raster(side), ts(raster_centers(side, 2)))


def test_frozen_server_table_dtype_matches_jax(pair):
    jm, tm = pair
    js = jm.trainer.freeze_serving(table_dtype="bfloat16")
    ts = tm.trainer.freeze_serving(table_dtype="bfloat16")
    x = _queries(seed=3)
    got = ts(x)
    assert_bf16_close(got.numpy(), np.asarray(js(jnp.asarray(x))))
    assert not torch.equal(got, tm.trainer.freeze_serving()(x))


@pytest.mark.parametrize("over,served", [
    ({"hash": "CoherentPrime", "gather_strategy": "quad"}, True),
    ({"interpolation": "Smoothstep", "gather_strategy": "per_level"}, False),
], ids=["coherent_prime", "smoothstep_per_level"])
def test_frozen_server_table_dtype_per_level_matches_jax(over, served):
    """A serve-time bfloat16 through both packages' FrozenServer, on the
    same random parameters (grid uniform +-1): batch and raster match the
    JAX package (tolerance above). Under Smoothstep the JAX package builds
    no quad table, so the port's bf16 server equals its fp32 one exactly;
    under CoherentPrime the dense coarse levels are rounded and the answer
    moves."""
    cfg = copy.deepcopy(CONFIG)
    cfg["optimizer"] = CONFIG["optimizer"]["nested"]
    cfg["encoding"] = {k: v for k, v in cfg["encoding"].items() if k != "strata"}
    cfg["encoding"].update(over)
    jm = tc.create_from_config(2, 3, cfg)
    tm = tt.create_from_config(2, 3, cfg, device="cpu")
    r = np.random.default_rng(7)
    n_net = tm.model.network.n_params
    flat = np.concatenate([r.uniform(-0.2, 0.2, n_net), r.uniform(-1, 1, tm.model.n_params - n_net)])
    flat = flat.astype(np.float32)
    jm.trainer.params = jnp.asarray(flat)
    tm.trainer.params = tt.params_from_numpy(flat, tm.model)
    js = jm.trainer.freeze_serving(table_dtype="bfloat16")
    ts = tm.trainer.freeze_serving(table_dtype="bfloat16")
    x = _queries(seed=6)
    got = ts(x)
    assert_bf16_close(got.numpy(), np.asarray(js(jnp.asarray(x))))
    assert_bf16_close(ts.raster(16).numpy(), np.asarray(js.raster(16)))
    assert torch.equal(got, tm.trainer.freeze_serving()(x)) != served


def test_frozen_server_is_a_snapshot(pair):
    _, tm = pair
    server = tm.trainer.freeze_serving()
    x = _queries(n=64, seed=4)
    before = server(x)
    saved = tm.trainer.params.clone()
    try:
        tm.trainer.params = torch.zeros_like(saved)
        assert torch.equal(server(x), before)
    finally:
        tm.trainer.params = saved
    with pytest.raises(TypeError, match="DeviceMesh"):
        tm.trainer.freeze_serving(mesh=object())


def test_commented_config_loads():
    text = "// flagship, reduced\n" + json.dumps(CONFIG, indent=1).replace(
        '"loss"', '/* the loss */ "loss"'
    ) + "\n# trailing comment\n"
    cfg = tt.loads_config(text)
    assert cfg == CONFIG
    m = tt.create_from_config(2, 3, cfg, device="cpu")
    assert m.trainer.optimizer_config == CONFIG["optimizer"]
    assert m.trainer.loss_config == CONFIG["loss"]
    assert m.params.shape == (m.model.n_params,)


def test_training_step_raises():
    """``training_step`` runs on the reduced flagship: a finite 0-d loss,
    params that change, and EMA weights as the inference params."""
    m = tt.create_from_config(2, 3, CONFIG, device="cpu")
    before = m.params.clone()
    r = np.random.default_rng(5)
    loss = m.training_step(r.uniform(0, 1, (B, 2)).astype(np.float32), r.uniform(0, 1, (B, 3)).astype(np.float32))
    assert loss.dim() == 0 and torch.isfinite(loss)
    assert not torch.equal(m.params, before)
    ema = m.trainer.inference_params()
    assert ema is m.trainer.opt_state["weights_ema"] and not torch.equal(ema, m.params)


def test_params_from_numpy_checks_length_and_dtype():
    m = tt.create_from_config(2, 3, CONFIG, device="cpu")
    n = m.model.n_params
    with pytest.raises(ValueError, match="float32"):
        tt.params_from_numpy(np.zeros(n, np.float64), m.model)
    with pytest.raises(ValueError, match="shape"):
        tt.params_from_numpy(np.zeros(n + 1, np.float32), m.model)
    cfg = copy.deepcopy(CONFIG)
    cfg["encoding"]["n_levels"] = 4
    other = tt.create_from_config(2, 3, cfg, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        tt.params_from_numpy(m.params.numpy(), other.model)


def test_inference_stratified_argument_matches_jax():
    """Under gather_strategy "stratified" with the encoding's own
    table_dtype, which levels round depends on whether a batch is taken for
    the stratified layout: ``inference(x)`` serves it as an arbitrary batch
    and ``inference(x, stratified=True)`` opts in, in both packages
    (tcnn_tpu/trainer.py: _inference_kwargs). Same random parameters, a
    stratified 16^2 batch; each mode matches the JAX package's (tolerance
    above) and lies nearer to it than the two modes lie to each other."""
    cfg = copy.deepcopy(CONFIG)
    cfg["optimizer"] = CONFIG["optimizer"]["nested"]
    cfg["encoding"]["table_dtype"] = "bfloat16"
    jm = tc.create_from_config(2, 3, cfg)
    tm = tt.create_from_config(2, 3, cfg, device="cpu")
    r = np.random.default_rng(11)
    n_net = tm.model.network.n_params
    flat = np.concatenate([r.uniform(-0.2, 0.2, n_net), r.uniform(-1, 1, tm.model.n_params - n_net)])
    flat = flat.astype(np.float32)
    jm.trainer.params = jnp.asarray(flat)
    tm.trainer.params = tt.params_from_numpy(flat, tm.model)
    x = np.asarray(stratified_uniform(jax.random.PRNGKey(3), B, 2))
    want = np.asarray(jm.trainer.inference(jnp.asarray(x)))
    want_strat = np.asarray(jm.trainer.inference(jnp.asarray(x), stratified=True))
    got = tm.trainer.inference(x).numpy()
    got_strat = tm.trainer.inference(x, stratified=True).numpy()
    assert_bf16_close(got, want)
    assert_bf16_close(got_strat, want_strat)
    between = np.abs(want - want_strat).max()
    assert between > 0
    assert np.abs(got - want).max() < between / 4 and np.abs(got_strat - want_strat).max() < between / 4
