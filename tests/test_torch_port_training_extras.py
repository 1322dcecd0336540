"""The trainer's extras: ``Trainer(perturbation_sigma=...)``, the Shampoo
optimizer and a ``fixed_point_pos`` model, the PyTorch port against the
JAX package.

Cross-package runs compute in fp32 (``precision="fp32"``), as
test_torch_port_trainer_api.py does, so that they compare the algorithm
rather than bf16 rounding flips. Tolerances:

- perturbation: the JAX package's uniforms are handed to the port through
  ``Trainer.perturbation_uniforms``; losses rtol 1e-5, params atol 2e-6
  (the noise's fp32 log may differ by an ulp between the libraries; the
  rest is test_torch_port_trainer_api.py's rtol 2e-5 class);
- Shampoo, the optimizer alone on the JAX oracle test's shapes
  (tests/test_shampoo_oracle.py: two runs of 8 x 8 and one 4 x 8 matrix
  and 16 other params) over 112 steps, across refreshes and the early to
  late interval change at step 100: params and the moments (of order 1)
  atol 1e-5, the preconditioners and roots atol 1e-4 (both packages run the coupled Newton iteration in fp32, batched
  here and one matrix at a time there: sums in another order, and the
  iteration's stop may fall one step apart);
- Shampoo through both trainers, 7 steps (refreshes at 3 and 6): losses
  rtol 1e-5, params atol 1e-5.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcnn_tpu as tc
import tcnn_tpu_torch as tt
import tcnn_tpu_torch.optimizers as topt
from tcnn_tpu_torch import interchange as tic

B = 256
CONFIG = {
    "loss": {"otype": "RelativeL2"},
    "optimizer": {"otype": "Adam", "learning_rate": 1e-2},
    "encoding": {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2, "log2_hashmap_size": 10,
                 "base_resolution": 4, "per_level_scale": 2.0},
    "network": {"otype": "FullyFusedMLP", "n_neurons": 16, "n_hidden_layers": 1},
}
LAYERS = [(8, 8), (8, 8), (4, 8)]
N_OPT = sum(r * c for r, c in LAYERS) + 16


def _batches(n, seed=0, fixed=False):
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        xy = r.uniform(0, 1, (B, 2)).astype(np.float32)
        t = np.stack([np.sin(5 * xy[:, 0]), xy[:, 1], xy[:, 0] * xy[:, 1]], 1).astype(np.float32)
        if fixed:
            xy = (xy.astype(np.float64) * 2.0**32).astype(np.uint64).clip(0, 2**32 - 1).astype(np.uint32)
        out.append((xy, 0.5 + 0.5 * t))
    return out


def _pair(cfg, **trainer_kw):
    jm = tc.create_from_config(2, 3, cfg, precision="fp32")
    tm = tt.create_from_config(2, 3, cfg, precision="fp32", device="cpu")
    if trainer_kw:
        jm.trainer = tc.Trainer(jm.trainer.model, jm.trainer.optimizer, jm.trainer.loss, **trainer_kw)
        tm.trainer = tt.Trainer(tm.model, cfg["optimizer"], cfg["loss"], **trainer_kw)
    np.testing.assert_array_equal(np.asarray(jm.trainer.params), tm.params.numpy())
    return jm, tm


def _train_both(jm, tm, batches, rtol, atol):
    for xy, t in batches:
        lj = float(jm.trainer.training_step(jnp.asarray(xy), jnp.asarray(t)))
        lt = float(tm.trainer.training_step(xy, t))
        np.testing.assert_allclose(lt, lj, rtol=rtol)
    np.testing.assert_allclose(tm.params.numpy(), np.asarray(jm.trainer.params), rtol=0, atol=atol)


def test_perturbation_sigma_matches_jax_with_the_same_draws():
    jm, tm = _pair(CONFIG, perturbation_sigma=0.1)
    batches = _batches(4)
    # The JAX trainer's draws: split the carried key, one uniform per
    # output entry (tcnn_tpu/trainer.py:243-256).
    key, draws = jax.random.PRNGKey(1337), []
    for _ in batches:
        k, key = jax.random.split(key)
        draws.append(np.array(jax.random.uniform(k, (B, tm.model.padded_output_width), jnp.float32, 1e-9,
                                                 1.0 - 1e-9)))
    tm.trainer.perturbation_uniforms = lambda b, w: torch.from_numpy(draws.pop(0))
    _train_both(jm, tm, batches, 1e-5, 2e-6)
    assert not draws


def test_perturbation_draws_are_seeded_and_move_the_step():
    """The default draws come from the trainer's own generator, seeded from
    ``seed``: two trainers agree, in the loop and through
    ``training_steps`` alike, and the noise changes the step."""
    batches = _batches(3, seed=1)
    a = tt.create_from_config(2, 3, CONFIG, device="cpu")
    b = tt.create_from_config(2, 3, CONFIG, device="cpu")
    plain = tt.create_from_config(2, 3, CONFIG, device="cpu")
    for m in (a, b):
        m.trainer = tt.Trainer(m.model, CONFIG["optimizer"], CONFIG["loss"], perturbation_sigma=0.1)
    u = a.trainer.perturbation_uniforms(B, 16)
    assert u.shape == (B, 16) and float(u.min()) >= 1e-9 and float(u.max()) < 1.0
    a.trainer.initialize_params(1337)
    for xy, t in batches:
        a.trainer.training_step(xy, t)
        plain.trainer.training_step(xy, t)
    losses = b.trainer.training_steps(lambda i: batches[int(i)], 3)
    assert losses.shape == (3,)
    assert torch.equal(a.params, b.params) and not torch.equal(a.params, plain.params)


def test_shampoo_optimizer_matches_jax_across_refreshes():
    for overrides, n_steps in (({}, 112), ({"cg_on_momentum": False, "frobenius_normalization": False,
                                            "relative_decay": 1e-3, "absolute_decay": 1e-5}, 16)):
        cfg = {"otype": "Shampoo", **overrides}
        jo, to = tc.create_optimizer(cfg), topt.create_optimizer(cfg)
        jo.allocate(N_OPT, LAYERS)
        to.allocate(N_OPT, LAYERS)
        assert to.matrix_batches == jo.matrix_batches == [(0, 2), (2, 3)]
        assert to.hyperparams() == jo.hyperparams()
        js, ts = jo.init_state(), to.init_state("cpu")
        r = np.random.default_rng(7)
        p = r.standard_normal(N_OPT).astype(np.float32) * 0.5
        jp, tp = jnp.asarray(p), torch.from_numpy(p.copy())
        step = jax.jit(jo.step)
        refreshed = 0
        for s in range(n_steps):
            g = (r.standard_normal(N_OPT) * 128).astype(np.float32)
            js, jp = step(js, jp, jnp.asarray(g), 128.0)
            before = ts["L_root"][2].clone()
            ts, tp = to.step(ts, tp, torch.from_numpy(g), 128.0)
            refreshed += int(not torch.equal(before, ts["L_root"][2]))
            np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-5, err_msg=f"step {s + 1}")
        assert int(ts["step"]) == n_steps
        for key in ("first_moments", "second_moments", "shampoo_momentum"):
            np.testing.assert_allclose(ts[key].numpy(), np.asarray(js[key]), rtol=1e-4, atol=1e-5)
        for key in ("L", "R", "L_root", "R_root"):
            for a, b in zip(ts[key], js[key]):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4)
        # The 4 x 8 run (the second of two) refreshes on step 1, then on
        # steps 5, 15, ..., 95 (interval 10 // 2, in turn with the other
        # run) and 100 (interval 200 // 2 from step 100 on).
        assert refreshed == (12 if n_steps == 112 else 3)


def test_inverse_4th_root_converges_and_freezes():
    a = torch.from_numpy(np.diag([4.0, 1.0, 0.0625]).astype(np.float32))[None]
    x = topt.shampoo.inverse_4th_root(a)
    np.testing.assert_allclose(x[0].numpy(), np.diag([4.0 ** -0.25, 1.0, 2.0]), rtol=1e-5)
    assert torch.equal(x, topt.shampoo.inverse_4th_root(a, max_iters=60))


def test_shampoo_trains_as_jax_and_does_not_serialize():
    cfg = copy.deepcopy(CONFIG)
    cfg["optimizer"] = {"otype": "Shampoo", "learning_rate": 1e-2}
    jm, tm = _pair(cfg)
    _train_both(jm, tm, _batches(7, seed=2), 1e-5, 1e-5)
    with pytest.raises(NotImplementedError, match="Shampoo optimizer does not yet support serialization"):
        tm.trainer.serialize(True)
    with pytest.raises(NotImplementedError, match="Shampoo optimizer does not yet support serialization"):
        jm.trainer.serialize(True)
    assert tm.trainer.serialize(False)["n_params"] == tm.trainer.n_params
    with pytest.raises(NotImplementedError, match="Shampoo"):
        tic.deserialize_optimizer(tm.trainer.optimizer, tm.trainer.opt_state, {})
    comp = copy.deepcopy(cfg)
    comp["optimizer"] = {"otype": "Composite", "nested": [
        {"otype": "Shampoo", "n_params_to_optimize": tm.model.network.n_params}, {"otype": "Adam"}]}
    c = tt.create_from_config(2, 3, comp, device="cpu")
    before = c.params.clone()
    c.training_step(*_batches(1)[0])
    assert not torch.equal(before, c.params)


def test_fixed_point_model_trains_as_jax():
    """uint32 positions pass through the trainer and ``FrozenServer`` as the
    JAX package takes them; the float raster raises in both."""
    cfg = copy.deepcopy(CONFIG)
    cfg["encoding"]["fixed_point_pos"] = True
    jm, tm = _pair(cfg)
    batches = _batches(3, seed=3, fixed=True)
    _train_both(jm, tm, batches, 2e-5, 2e-6)
    x = batches[0][0]
    np.testing.assert_allclose(tm.inference(x).numpy(), np.asarray(jm.inference(jnp.asarray(x))), rtol=1e-5,
                               atol=1e-6)
    mod = tt.modules.NetworkWithInputEncoding(2, 3, cfg["encoding"], cfg["network"], device="cpu")
    assert mod(torch.from_numpy(x.astype(np.int64)).to(torch.uint32)).shape == (B, 3)
    server = tm.trainer.freeze_serving()
    assert torch.equal(server(x), tm.inference(x))
    with pytest.raises(TypeError, match="uint32"):
        server.raster(8)
    with pytest.raises(TypeError, match="uint32"):
        tm.trainer.inference_raster(8)
    with pytest.raises(TypeError, match="uint32"):
        jm.trainer.inference_raster(8)
    with pytest.raises(TypeError, match="uint32"):
        tm.training_step(x.astype(np.float32), batches[0][1])
