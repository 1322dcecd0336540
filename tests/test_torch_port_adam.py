"""Adam and EMA: the PyTorch port against the JAX package.

``AdamOptimizer._step_plain`` (the fused CUDA kernel's plain version, which
runs on the CPU) against JAX ``_step_xla`` and the Pallas kernel
``adam_step_fused`` (interpret mode), over the knob list of
``tests/test_fused_adam.py``: three steps from the same params with the same
numpy gradients (loss scale 128), a share of them exactly zero so that
skip-zero-grad acts on the non-matrix entries. Then the EMA wrapper's
custom weights against JAX ``EmaOptimizer``.

Tolerance: ``param_steps`` and the global step equal; params, moments and
EMA weights to rtol 1e-6 with atol 1e-7, as tests/test_fused_adam.py holds
the JAX package's two paths to each other (the same fp32 operations in the
same order; a ``pow`` or ``sqrt`` may differ by an ulp between libraries,
which moves an update of size ~lr by ~1e-9).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_fused_adam import KNOBS

import tcnn_tpu.optimizers as jopt
import tcnn_tpu_torch.optimizers as topt

LOSS_SCALE = 128.0


def _grads(rng, n, steps):
    out = []
    for _ in range(steps):
        g = rng.normal(0, 1.0, (n,)).astype(np.float32) * LOSS_SCALE
        g[rng.random(n) < 0.3] = 0.0
        out.append(g)
    return out


def _run_jax(cfg, n, n_matrix, params, grads, fused):
    opt = jopt.create_optimizer(cfg)
    opt.allocate(n, [(1, n_matrix)] if n_matrix else [])
    inner = opt if cfg.get("otype", "Adam") == "Adam" else opt.nested(0)
    inner.fused = fused
    state = opt.init_state()
    p = jnp.asarray(params)
    step = jax.jit(lambda s, p, g: opt.step(s, p, g, LOSS_SCALE))
    for g in grads:
        state, p = step(state, p, jnp.asarray(g))
    return opt, state, np.asarray(p)


def _run_port(cfg, n, n_matrix, params, grads):
    opt = topt.create_optimizer(cfg)
    opt.allocate(n, [(1, n_matrix)] if n_matrix else [])
    state = opt.init_state("cpu")
    p = torch.from_numpy(params.copy())
    for g in grads:
        state, p = opt.step(state, p, torch.from_numpy(g), LOSS_SCALE)
    return opt, state, p.numpy()


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("hp", KNOBS, ids=[str(sorted(k)) for k in KNOBS])
@pytest.mark.parametrize("n,n_matrix", [(1000, 128), (300, 0)])
def test_step_plain_matches_jax(hp, n, n_matrix):
    rng = np.random.default_rng(n + len(hp))
    params = rng.normal(0, 0.3, (n,)).astype(np.float32)
    grads = _grads(rng, n, 3)
    _, t_state, t_params = _run_port(dict(hp), n, n_matrix, params, grads)
    for fused in (False, True):
        _, j_state, j_params = _run_jax(dict(hp), n, n_matrix, params, grads, fused)
        assert int(t_state["step"]) == int(j_state["step"]) == 3
        np.testing.assert_array_equal(t_state["param_steps"].numpy(), np.asarray(j_state["param_steps"]))
        _close(t_params, j_params)
        _close(t_state["first_moments"].numpy(), j_state["first_moments"])
        _close(t_state["second_moments"].numpy(), j_state["second_moments"])


def test_skip_zero_grad_keeps_untouched_entries():
    """Non-matrix entries whose gradient is exactly zero keep their value,
    moments and step count; matrix entries always step."""
    n, n_matrix = 64, 16
    opt = topt.create_optimizer({"otype": "Adam", "learning_rate": 1e-2})
    opt.allocate(n, [(1, n_matrix)])
    state = opt.init_state("cpu")
    p = torch.linspace(-1, 1, n)
    g = torch.ones(n)
    g[n_matrix::2] = 0.0
    g[1] = 0.0
    state, p2 = opt.step(state, p, g, 1.0)
    untouched = torch.zeros(n, dtype=torch.bool)
    untouched[n_matrix::2] = True
    assert torch.equal(p2[untouched], p[untouched])
    assert not state["param_steps"][untouched].any() and not state["first_moments"][untouched].any()
    assert (state["param_steps"][~untouched] == 1).all()
    assert p2[1] != p[1]  # matrix entry with a zero gradient still steps (l2, moments)


def test_ema_custom_weights_match_jax():
    cfg = {"otype": "EMA", "decay": 0.9, "nested": {"otype": "Adam", "learning_rate": 1e-2, "beta2": 0.99,
                                                     "epsilon": 1e-15, "l2_reg": 1e-6}}
    n, n_matrix = 500, 96
    rng = np.random.default_rng(11)
    params = rng.normal(0, 0.3, (n,)).astype(np.float32)
    grads = _grads(rng, n, 4)
    topt_, t_state, t_params = _run_port(cfg, n, n_matrix, params, grads)
    jopt_, j_state, j_params = _run_jax(cfg, n, n_matrix, params, grads, fused=False)
    _close(t_params, j_params)
    t_ema = topt_.custom_weights(t_state)
    _close(t_ema.numpy(), jopt_.custom_weights(j_state))
    assert not np.allclose(t_ema.numpy(), t_params)
    assert topt_.learning_rate == 1e-2
    topt_.learning_rate = 5e-3
    assert topt_.nested(0).learning_rate == 5e-3


def test_factory():
    assert isinstance(topt.create_optimizer(None), topt.AdamOptimizer)
    ema = topt.create_optimizer({"otype": "ema", "nested": {"otype": "Adam", "fused": True, "beta1": 0.5}})
    assert isinstance(ema, topt.EmaOptimizer) and ema.nested(0).beta1 == 0.5
    assert ema.hyperparams()["nested"]["beta1"] == 0.5
    for otype, cls in (("sgd", topt.SGDOptimizer), ("Novograd", topt.NovogradOptimizer),
                       ("Average", topt.AverageOptimizer), ("Lookahead", topt.LookaheadOptimizer),
                       ("Batched", topt.BatchedOptimizer), ("ExponentialDecay", topt.ExponentialDecayOptimizer)):
        assert isinstance(topt.create_optimizer({"otype": otype}), cls)
    comp = topt.create_optimizer({"otype": "Composite", "nested": [{"otype": "SGD"}]})
    assert isinstance(comp, topt.CompositeOptimizer)
    assert isinstance(topt.create_optimizer({"otype": "Shampoo"}), topt.ShampooOptimizer)
    with pytest.raises(ValueError, match="Invalid optimizer"):
        topt.create_optimizer({"otype": "NoSuch"})
