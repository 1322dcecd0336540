"""SGD, Novograd, the Average, Batched, Lookahead, ExponentialDecay and EMA
wrappers and Composite: the PyTorch port against the JAX package.

Each optimizer is allocated for 128 weights (two weight matrices, 64
matrix weights, then 64 non-matrix ones), starts from the same numpy
params and takes five steps on the same numpy gradients (loss scale 128, a
share of them exactly zero). The state trees must have the same leaves in
the same order (dict keys sorted, lists in order: the npz checkpoints'
numbering) and the params and every leaf must agree.

Tolerance: integer leaves equal; params and fp32 leaves to rtol 1e-5, atol
1e-6 (the same fp32 operations; Novograd's per-layer norm is a sum that
reduces in another order, and a ``pow`` or ``sqrt`` may differ by an ulp
between libraries).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcnn_tpu.optimizers as jopt
import tcnn_tpu_torch.optimizers as topt
from tcnn_tpu_torch.optimizers.base import tree_leaves

N = 128
LAYERS = [(8, 4), (4, 8)]
LOSS_SCALE = 128.0
STEPS = 5

CONFIGS = {
    "sgd": {"otype": "SGD", "learning_rate": 1e-2, "l2_reg": 1e-4},
    "novograd": {"otype": "Novograd", "learning_rate": 1e-2, "relative_decay": 0.1, "absolute_decay": 1e-3},
    "ema": {"otype": "EMA", "decay": 0.9, "nested": {"otype": "Adam", "learning_rate": 1e-2}},
    "average": {"otype": "Average", "n_samples": 3, "nested": {"otype": "Adam", "learning_rate": 1e-2}},
    "batched": {"otype": "Batched", "batch_size_multiplier": 2, "nested": {"otype": "Adam", "learning_rate": 1e-2}},
    "batched_sgd": {"otype": "Batched", "batch_size_multiplier": 3, "nested": {"otype": "SGD", "learning_rate": 0.1}},
    "lookahead": {"otype": "Lookahead", "alpha": 0.3, "n_steps": 2, "nested": {"otype": "Adam", "learning_rate": 1e-2}},
    "exponential_decay": {"otype": "ExponentialDecay", "decay_base": 0.5, "decay_start": 2, "decay_interval": 2,
                          "decay_end": 100, "nested": {"otype": "Adam", "learning_rate": 1e-2}},
    "composite": {"otype": "Composite", "nested": [
        {"otype": "Novograd", "n_params_to_optimize": 64, "learning_rate": 1e-2},
        {"otype": "EMA", "decay": 0.8, "nested": {"otype": "Adam", "learning_rate": 1e-2}},
    ]},
    "composite_plain": {"otype": "Composite", "nested": [
        {"otype": "SGD", "n_params_to_optimize": 32, "learning_rate": 1e-2},
        {"otype": "Adam", "learning_rate": 1e-2},
    ]},
}


def _data(seed):
    rng = np.random.default_rng(seed)
    params = rng.normal(0, 0.5, N).astype(np.float32)
    grads = []
    for _ in range(STEPS):
        g = rng.normal(0, 1.0, N).astype(np.float32) * LOSS_SCALE
        g[rng.random(N) < 0.2] = 0.0
        grads.append(g)
    return params, grads


def run_jax(cfg, params, grads):
    opt = jopt.create_optimizer(cfg)
    opt.allocate(N, LAYERS)
    state = opt.init_state()
    step = jax.jit(lambda s, p, g: opt.step(s, p, g, LOSS_SCALE))
    p = jnp.asarray(params)
    for g in grads:
        state, p = step(state, p, jnp.asarray(g))
    return opt, state, np.asarray(p)


def run_port(cfg, params, grads):
    opt = topt.create_optimizer(cfg)
    opt.allocate(N, LAYERS)
    state = opt.init_state("cpu")
    p = torch.from_numpy(params.copy())
    for g in grads:
        state, p = opt.step(state, p, torch.from_numpy(g), LOSS_SCALE)
    return opt, state, p.numpy()


def _without_fused(hp):
    """The JAX package's hyperparams less Adam's "fused" key, its switch
    between a Pallas kernel and XLA, which the port does not have."""
    if isinstance(hp, dict):
        return {k: _without_fused(v) for k, v in hp.items() if k != "fused"}
    if isinstance(hp, list):
        return [_without_fused(v) for v in hp]
    return hp


def assert_states_close(t_state, j_state):
    t_leaves = tree_leaves(t_state)
    j_leaves = jax.tree_util.tree_leaves(j_state)
    assert len(t_leaves) == len(j_leaves)
    for t, j in zip(t_leaves, j_leaves):
        j = np.asarray(j)
        assert tuple(t.shape) == j.shape
        if j.dtype.kind == "i":
            np.testing.assert_array_equal(t.numpy(), j)
        else:
            np.testing.assert_allclose(t.numpy(), j, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_five_steps_match_jax(name):
    params, grads = _data(len(name))
    jo, js, jp = run_jax(CONFIGS[name], params, grads)
    to, ts, tp = run_port(CONFIGS[name], params, grads)
    assert to.otype == jo.otype and to.hyperparams() == _without_fused(jo.hyperparams())
    np.testing.assert_allclose(tp, jp, rtol=1e-5, atol=1e-6)
    assert not np.allclose(tp, params)
    assert_states_close(ts, js)
    jc = jo.custom_weights(js)
    tc_ = to.custom_weights(ts)
    assert (jc is None) == (tc_ is None)
    if jc is not None:
        if callable(jc):
            jc, tc_ = jc(jnp.asarray(jp)), tc_(torch.from_numpy(tp))
        np.testing.assert_allclose(tc_.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-6)


def test_batched_steps_only_every_n():
    """The nested SGD steps on calls 3 and 6 only, on the mean of the
    gradients since its last step (batched.h:46-90)."""
    params = np.zeros(N, np.float32)
    grads = [np.full(N, 3.0 * k, np.float32) for k in range(1, 7)]
    opt = topt.create_optimizer(CONFIGS["batched_sgd"])
    opt.allocate(N, LAYERS)
    state, p = opt.init_state("cpu"), torch.from_numpy(params)
    seen = []
    for g in grads:
        state, p = opt.step(state, p, torch.from_numpy(g), 1.0)
        seen.append(float(p[0]))
    lr = 0.1
    first = -lr * (3 + 6 + 9) / 3
    assert seen[:2] == [0.0, 0.0] and seen[2] == pytest.approx(first, rel=1e-6)
    assert seen[3:5] == [seen[2]] * 2 and seen[5] == pytest.approx(first - lr * (12 + 15 + 18) / 3, rel=1e-5)
    assert int(state["nested"]["step"]) == 2 and int(state["step"]) == 6


def test_exponential_decay_factor():
    """The factor halves at steps 2 and 4 of [2, 100] (decay_interval 2)."""
    params, grads = _data(3)
    opt = topt.create_optimizer(CONFIGS["exponential_decay"])
    opt.allocate(N, LAYERS)
    state, p = opt.init_state("cpu"), torch.from_numpy(params)
    factors = []
    for g in grads:
        state, p = opt.step(state, p, torch.from_numpy(g), LOSS_SCALE)
        factors.append(float(state["lr_factor"]))
    assert factors == [1.0, 1.0, 0.5, 0.5, 0.25]


def test_hyperparams_round_trip_and_learning_rate():
    for name, cfg in CONFIGS.items():
        opt = topt.create_optimizer(cfg)
        other = topt.create_optimizer(cfg)
        other.update_hyperparams(opt.hyperparams())
        assert other.hyperparams() == opt.hyperparams(), name
        opt.learning_rate = 5e-3
        assert opt.learning_rate == 5e-3, name
    sgd = topt.create_optimizer(CONFIGS["sgd"])
    sgd.update_hyperparams({"learning_rate": 1e-4})
    assert sgd.hyperparams()["learning_rate"] == 1e-4


def test_composite_checks_ranges():
    with pytest.raises(ValueError, match="array of nested"):
        topt.create_optimizer({"otype": "Composite"})
    with pytest.raises(ValueError, match="only one"):
        topt.create_optimizer({"otype": "Composite", "nested": [{"otype": "SGD"}, {"otype": "SGD"}]})
    opt = topt.create_optimizer({"otype": "Composite", "nested": [
        {"otype": "SGD", "n_params_to_optimize": 16}, {"otype": "SGD"}]})
    with pytest.raises(ValueError, match="within a layer"):
        opt.allocate(N, LAYERS)
