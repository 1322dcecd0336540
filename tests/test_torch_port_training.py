"""The training slice as a whole: the PyTorch port against the JAX package.

A reduced flagship config (same encoding, network, loss and optimizer kinds;
8 levels, 2^10-entry tables, 32 strata) is built in both packages from the
same seed (PCG32 init is bit-identical) and trained on the same five numpy
batches: stratified 32^2 batches (the JAX package's static coarse-level
path) alternating with a non-square batch (its per-sample path). Once with
plain Adam, once in the SR + EMA mode of
``benchmarks/configs/config_hash_strat_sr_ema.json``.

Tolerances:
- per-step loss: 1e-2 relative (the forward is the same function; what
  differs are bf16 rounding flips of fp32 sums in another order, and from
  the second step on the params those flips moved);
- params and inference params, fp32-class gradients (plain Adam): max
  |diff| <= 1e-4, where Adam moves a param by up to ~lr = 1e-2 a step;
- params and inference params, SR class: an Adam step is about lr times the
  sign of the gradient, so a gradient that is tiny on one side and rounds
  the other way on the other moves a param by up to 2 lr a step. Bound: max
  |diff| <= 2 * 5 * lr, and 99% of the params within 1e-4.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcnn_tpu as tc
import tcnn_tpu_torch as tt
from tcnn_tpu_torch.utils.sampling import is_stratified, strata_of, stratified_uniform

STRATA = 32
B = STRATA**2
LR = 1e-2

CONFIG = {
    "loss": {"otype": "RelativeL2"},
    "optimizer": {"otype": "Adam", "learning_rate": LR, "beta1": 0.9, "beta2": 0.99, "epsilon": 1e-15,
                  "l2_reg": 1e-6},
    "encoding": {
        "otype": "HashGrid", "n_levels": 8, "n_features_per_level": 2, "log2_hashmap_size": 10,
        "base_resolution": 4, "per_level_scale": 1.5, "hash": "CoherentAdditive",
        "gather_strategy": "stratified", "strata": STRATA,
    },
    "network": {"otype": "FullyFusedMLP", "activation": "ReLU", "output_activation": "None", "n_neurons": 64,
                "n_hidden_layers": 2},
}
SR_EMA = copy.deepcopy(CONFIG)
SR_EMA["optimizer"] = {"otype": "EMA", "decay": 0.99, "nested": CONFIG["optimizer"]}
SR_EMA["encoding"]["scatter_strategy"] = "factored_sr"


def _batches(seed=0):
    r = np.random.default_rng(seed)
    out = []
    for i in range(5):
        if i % 2 == 0:
            ids = np.arange(B)
            base = np.stack([ids % STRATA, ids // STRATA], 1)
            xy = ((base + r.uniform(0, 1, (B, 2))) / STRATA).astype(np.float32)
            assert is_stratified(xy)
        else:
            xy = r.uniform(0, 1, (1000, 2)).astype(np.float32)
        t = np.stack([np.sin(6 * xy[:, 0]), np.cos(4 * xy[:, 1]), xy[:, 0] * xy[:, 1]], 1).astype(np.float32)
        out.append((xy, 0.5 + 0.5 * t))
    return out


@pytest.fixture(scope="module", params=["adam", "sr_ema"])
def trained(request):
    cfg = CONFIG if request.param == "adam" else SR_EMA
    jm, tm = tc.create_from_config(2, 3, cfg), tt.create_from_config(2, 3, cfg, device="cpu")
    np.testing.assert_array_equal(np.asarray(jm.trainer.params), tm.params.numpy())
    losses = []
    for xy, t in _batches():
        lj = float(jm.training_step(jnp.asarray(xy), jnp.asarray(t)))
        lt = tm.training_step(xy, t)
        assert lt.dim() == 0 and lt.dtype == torch.float32
        losses.append((lj, float(lt)))
    return request.param, jm, tm, losses


def test_per_step_loss_matches_jax(trained):
    _, _, _, losses = trained
    lj, lt = np.array(losses).T
    np.testing.assert_allclose(lt, lj, rtol=1e-2)
    assert lt[-1] < lt[0]


def _assert_params_close(kind, got, want):
    d = np.abs(np.asarray(got) - np.asarray(want))
    if kind == "adam":
        assert d.max() <= 1e-4, d.max()
    else:
        assert d.max() <= 2 * 5 * LR, d.max()
        assert np.mean(d <= 1e-4) >= 0.99, np.mean(d <= 1e-4)


def test_params_and_inference_params_match_jax(trained):
    kind, jm, tm, _ = trained
    _assert_params_close(kind, tm.params.numpy(), jm.trainer.params)
    ti, ji = tm.trainer.inference_params(), np.asarray(jm.trainer.inference_params())
    _assert_params_close(kind, ti.numpy(), ji)
    if kind == "sr_ema":
        assert ti is tm.trainer.opt_state["weights_ema"]
        assert not np.allclose(ti.numpy(), tm.params.numpy())
        assert np.array_equal(np.asarray(jm.trainer.state["opt"]["nested"]["step"]), 5)
        assert int(tm.trainer.opt_state["nested"]["step"]) == 5
    else:
        assert ti is tm.params or torch.equal(ti, tm.params)


def test_training_step_with_gradients_matches_jax():
    jm, tm = tc.create_from_config(2, 3, CONFIG), tt.create_from_config(2, 3, CONFIG, device="cpu")
    r = np.random.default_rng(1)
    xy = r.uniform(0, 1, (700, 2)).astype(np.float32)
    dL = np.zeros((700, tm.model.padded_output_width), np.float32)
    dL[:, :3] = r.normal(0, 1, (700, 3)) * tm.trainer.loss_scale / 700
    jm.trainer.training_step_with_gradients(jnp.asarray(xy), jnp.asarray(dL))
    tm.trainer.training_step_with_gradients(xy, dL)
    _assert_params_close("adam", tm.params.numpy(), jm.trainer.params)
    assert int(tm.trainer.opt_state["step"]) == 1


def test_forward_evaluate_loss_and_learning_rate():
    jm, tm = tc.create_from_config(2, 3, CONFIG), tt.create_from_config(2, 3, CONFIG, device="cpu")
    xy, t = _batches(seed=3)[1]
    out = tm.trainer.forward(xy)
    assert out.shape == (len(xy), 16) and out.dtype == torch.bfloat16
    values, total = tm.trainer.evaluate_loss(xy, t)
    jv, jt = jm.trainer.evaluate_loss(jnp.asarray(xy), jnp.asarray(t))
    assert values.shape == (len(xy), 16)
    np.testing.assert_allclose(float(total), float(jt), rtol=1e-2)
    assert tm.trainer.loss_scale == jm.trainer.loss_scale == 128.0
    assert tm.trainer.learning_rate == LR
    tm.trainer.learning_rate = 2e-3
    assert tm.trainer.optimizer.learning_rate == 2e-3
    # data_pdf reaches the loss.
    l1 = tm.trainer.training_step(xy, t, np.full_like(t, 2.0))
    assert torch.isfinite(l1)


def test_plain_step_is_the_step_on_the_cpu():
    """``training_step_plain`` is the same step as ``training_step`` on the
    CPU, where every kernel wrapper takes its plain version."""
    a, b = tt.create_from_config(2, 3, SR_EMA, device="cpu"), tt.create_from_config(2, 3, SR_EMA, device="cpu")
    for xy, t in _batches(seed=2)[:2]:
        assert torch.equal(a.training_step(xy, t), b.trainer.training_step_plain(xy, t))
    assert torch.equal(a.params, b.params)
    assert torch.equal(a.trainer.inference_params(), b.trainer.inference_params())


def test_not_ported_training_features_raise():
    """Of the features that once raised here, only ``split_grid_state`` (a
    TPU layout, not to port) still does; a stochastic-interpolation config
    trains and serves, and ``perturbation_sigma`` is taken
    (test_torch_port_training_extras.py holds it to the JAX package)."""
    cfg = copy.deepcopy(CONFIG)
    cfg["encoding"].update(stochastic_interpolation=True, gather_strategy="per_level")
    m = tt.create_from_config(2, 3, cfg, device="cpu")
    assert torch.isfinite(m.training_step(*_batches()[1]))
    assert m.inference(_batches()[1][0]).shape == (1000, 3)
    model = tt.create_from_config(2, 3, CONFIG, device="cpu").model
    assert tt.Trainer(model, CONFIG["optimizer"], CONFIG["loss"], perturbation_sigma=0.1).perturbation_sigma == 0.1
    with pytest.raises(NotImplementedError, match="not to port"):
        tt.Trainer(model, CONFIG["optimizer"], CONFIG["loss"], split_grid_state=True)


def test_stochastic_interpolation_config_trains_as_jax():
    """A ``"stochastic_interpolation": true`` config (here on the
    stratified strategy, whose static coarse levels its deterministic
    steps still take) through both Trainers: neither trainer hands the
    encoding an ``rng``, so both take the deterministic table gradient
    (tcnn_tpu/trainer.py:216-217). Loss and params within match_rae of the
    plain-Adam tolerances above (1e-2 on the losses, and the params' p99
    RAE within 1e-2: Adam moves small params by about lr on either side of
    a bf16 rounding flip)."""
    from utils import match_rae

    cfg = copy.deepcopy(CONFIG)
    cfg["encoding"]["stochastic_interpolation"] = True
    jm, tm = tc.create_from_config(2, 3, cfg), tt.create_from_config(2, 3, cfg, device="cpu")
    losses = [(float(jm.training_step(jnp.asarray(xy), jnp.asarray(t))), float(tm.training_step(xy, t)))
              for xy, t in _batches()[:3]]
    lj, lt = np.array(losses).T
    match_rae(lt, lj, 1e-2)
    _assert_params_close("adam", tm.params.numpy(), jm.trainer.params)
    match_rae(tm.params.numpy(), np.asarray(jm.trainer.params), 1e-2, percentile=99)


def test_scatter_strategy_changes_training():
    """The scatter strategy is part of what a step computes (it selects
    the table gradient's rounding class)."""
    cfg = copy.deepcopy(CONFIG)
    cfg["encoding"]["scatter_strategy"] = "xla_half"
    a, b = tt.create_from_config(2, 3, CONFIG, device="cpu"), tt.create_from_config(2, 3, cfg, device="cpu")
    xy, t = _batches()[1]
    a.training_step(xy, t)
    b.training_step(xy, t)
    n_net = a.model.network.n_params
    assert torch.equal(a.params[:n_net], b.params[:n_net])
    assert not torch.equal(a.params[n_net:], b.params[n_net:])


@pytest.mark.parametrize("phase_locked", [False, True, 4])
def test_stratified_uniform_layout(phase_locked):
    g = torch.Generator().manual_seed(0)
    x = stratified_uniform(4096, 2, g, phase_locked=phase_locked)
    assert x.shape == (4096, 2) and x.dtype == torch.float32
    assert is_stratified(x) and strata_of(4096) == 64 and strata_of(4097) is None
    assert float(x.min()) >= 0.0 and float(x.max()) < 1.0
    frac = (x * 64 - torch.floor(x * 64)).numpy()
    n_phases = {False: 4096, True: 1, 4: 4}[phase_locked]
    assert len(np.unique(frac.round(4), axis=0)) == n_phases
    r = stratified_uniform(4096, 2, torch.Generator().manual_seed(1), run_correlated=True)
    assert is_stratified(r)
    assert (r[:64, 1] - r[0, 1]).abs().max() < 1 / 64
    with pytest.raises(ValueError, match="perfect"):
        stratified_uniform(1000, 2, g)
    with pytest.raises(ValueError, match="exclusive"):
        stratified_uniform(4096, 2, g, phase_locked=True, run_correlated=True)
