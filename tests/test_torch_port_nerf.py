"""The NeRF path of the port against the JAX package: the Instant-NGP
radiance field ``Composite[HashGrid(xyz) + SphericalHarmonics(dir)] ->
FullyFusedMLP`` of ``samples/nerf_synthetic.py`` and of
``tests/test_nerf_config.py``.

- the sample's model, built from the same seed in both packages: the same
  widths and bitwise-equal initial parameters;
- one whole sample step at toy size (64 rays x 32 samples): the same rays
  and depth jitter, drawn by ``jax.random`` and handed to the port,
  rendered, the loss, its gradient and one Adam step at loss scale 1;
- five ``training_step`` calls of ``tests/test_nerf_config.py``'s
  NERF_CONFIG;
- ``FrozenServer`` with a serve-time ``table_dtype`` on the composite;
- the port's sample run end to end on the CPU.

Tolerances (those of ``tests/test_torch_port_training.py``): losses 1e-2
relative (the same function; bf16 roundings of fp32 sums taken in another
order flip); params max |diff| <= 1e-4 (fp32-class table gradients: batches
below the JAX package's factored-scatter gate); model outputs
``assert_bf16_close``. Gradients and Adam's moments, which see the
gradient's size where one Adam step sees only its sign: the network's and
the table's parts each within 1e-3 of the JAX package's in norm and in max
|diff| relative to max |JAX| (``_assert_near``; they agree to ~1e-6).
"""

import copy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_ffmlp import assert_bf16_close

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import samples.nerf_synthetic as jsample  # noqa: E402
import tcnn_tpu as tc  # noqa: E402
import tcnn_tpu_torch as tt  # noqa: E402
from tcnn_tpu_torch.samples import nerf_synthetic as tsample  # noqa: E402
from test_nerf_config import NERF_CONFIG, _batch  # noqa: E402

N_RAYS = 64


def test_sample_constants_equal_the_jax_sample():
    assert tsample.CONFIG == jsample.CONFIG
    assert (tsample.N_SAMPLES, tsample.NEAR, tsample.FAR) == (jsample.N_SAMPLES, jsample.NEAR, jsample.FAR)


def test_nerf_model_matches_jax_at_init():
    """6 inputs, 4 outputs; 256,480 params (7,168 network, 249,312 table);
    nested widths [(16, 0), (9, 7)]; PCG32 init bitwise equal."""
    jm = tc.create_from_config(6, 4, jsample.CONFIG)
    tm = tt.create_from_config(6, 4, tsample.CONFIG, device="cpu")
    assert tm.model.n_params == jm.model.n_params == 256480
    assert tm.model.network.n_params == 7168 and tm.model.encoding.n_params == 249312
    assert [(e.n_output_dims, e.n_to_pad) for e in tm.model.encoding.nested] == [(16, 0), (9, 7)]
    assert tm.optimizer.n_matrix_weights == jm.optimizer.n_matrix_weights == 7168
    np.testing.assert_array_equal(tm.params.numpy(), np.asarray(jm.trainer.params))
    assert tm.model.hyperparams() == jm.model.hyperparams()


def _jax_step(jm, origins, dirs, jitter):
    """The JAX sample's ``train_step`` body (samples/nerf_synthetic.py:
    171-202) with the jitter given: render, loss, gradient, Adam at loss
    scale 1."""
    trainer = jm.trainer

    def field(params, pts, d):
        out = jm.model.apply(params, jnp.concatenate([pts, (d + 1.0) * 0.5], axis=1)).astype(jnp.float32)
        return jax.nn.softplus(out[:, 3] - 1.0), jax.nn.sigmoid(out[:, :3])

    def render(fn):
        n = origins.shape[0]
        t = jnp.linspace(jsample.NEAR, jsample.FAR, jsample.N_SAMPLES + 1)[:-1]
        t = t[None] + jitter * ((jsample.FAR - jsample.NEAR) / jsample.N_SAMPLES)
        dt = (jsample.FAR - jsample.NEAR) / jsample.N_SAMPLES
        pts = (origins[:, None, :] + dirs[:, None, :] * t[..., None]).reshape(n * jsample.N_SAMPLES, 3)
        dcast = jnp.broadcast_to(dirs[:, None, :], (n, jsample.N_SAMPLES, 3)).reshape(-1, 3)
        sigma, rgb = fn(jnp.clip(pts, 0.0, 1.0), dcast)
        sigma, rgb = sigma.reshape(n, jsample.N_SAMPLES), rgb.reshape(n, jsample.N_SAMPLES, 3)
        alpha = 1.0 - jnp.exp(-sigma * dt)
        trans = jnp.cumprod(1.0 - alpha + 1e-10, axis=1)
        trans = jnp.concatenate([jnp.ones((n, 1)), trans[:, :-1]], axis=1)
        return jnp.sum((alpha * trans)[..., None] * rgb, axis=1)

    target = render(lambda p, d: jsample.scene_sigma_rgb(p))

    def loss_fn(params):
        pred = render(lambda p, d: field(params, p, d))
        diff = pred - target
        return jnp.mean(diff * diff / (pred * pred + 1e-2))

    state = trainer.state
    loss, grads = jax.value_and_grad(loss_fn)(state["params"])
    opt_state, new_params = trainer.optimizer.step(state["opt"], state["params"], grads, 1.0)
    trainer.state = {**state, "params": new_params, "opt": opt_state}
    return float(loss), np.asarray(grads)


def _assert_near(got, want, n_net, rtol=1e-3):
    """The network part ``[:n_net]`` and the table part of two flat
    vectors: ||got - want|| <= rtol ||want|| and max |got - want| <= rtol
    max |want|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    for part in (slice(0, n_net), slice(n_net, None)):
        a, b = got[part], want[part]
        assert np.abs(b).max() > 0
        assert np.linalg.norm(a - b) <= rtol * np.linalg.norm(b), (part, np.linalg.norm(a - b), np.linalg.norm(b))
        assert np.abs(a - b).max() <= rtol * np.abs(b).max(), (part, np.abs(a - b).max(), np.abs(b).max())


def _assert_moments_near(tm, jm):
    """Adam's first and second moments of the port and of the JAX package."""
    n_net = tm.model.network.n_params
    for key in ("first_moments", "second_moments"):
        _assert_near(tm.trainer.opt_state[key].numpy(), jm.trainer.state["opt"][key], n_net)


def _draws(seed):
    """Rays and jitter as the JAX sample draws them (make_rays' uniform
    image-plane points, render's uniform jitter)."""
    kr, kt = jax.random.split(jax.random.PRNGKey(seed))
    uv = jax.random.uniform(kr, (N_RAYS, 2))
    origins, dirs = jsample.make_rays(kr, N_RAYS)
    jitter = jax.random.uniform(kt, (N_RAYS, jsample.N_SAMPLES))
    return uv, origins, dirs, jitter


def test_one_sample_step_matches_jax():
    jm = tc.create_from_config(6, 4, jsample.CONFIG)
    tm = tt.create_from_config(6, 4, tsample.CONFIG, device="cpu")
    uv, origins, dirs, jitter = _draws(0)
    t_origins, t_dirs = tsample.make_rays(torch.from_numpy(np.asarray(uv)))
    np.testing.assert_allclose(t_dirs.numpy(), np.asarray(dirs), rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_origins.numpy(), np.asarray(origins), rtol=0, atol=0)
    t_jitter = torch.from_numpy(np.asarray(jitter))
    # The rendered ground truth: the same quadrature in both packages.
    want_gt = np.asarray(jsample.render(lambda p, d: jsample.scene_sigma_rgb(p), origins, dirs))
    got_gt = tsample.render(tsample.gt_field, t_origins, t_dirs).numpy()
    np.testing.assert_allclose(got_gt, want_gt, rtol=1e-4, atol=1e-5)

    jloss, jgrads = _jax_step(jm, origins, dirs, jitter)
    n_net = tm.model.network.n_params
    _, tgrads = tsample.loss_and_grad(tm, t_origins, t_dirs, t_jitter)
    _assert_near(tgrads.numpy(), jgrads, n_net)
    before = tm.params.clone()
    tloss = float(tsample.train_step(tm, t_origins, t_dirs, t_jitter))
    assert tloss == pytest.approx(jloss, rel=1e-2)
    _assert_moments_near(tm, jm)
    assert not torch.equal(before, tm.params)
    d = np.abs(tm.params.numpy() - np.asarray(jm.trainer.params))
    assert d.max() <= 1e-4, d.max()
    assert int(tm.trainer.opt_state["step"]) == 1
    # Every part of the model received a gradient: the network and the
    # grid's visited table entries.
    moved = (tm.params - before).abs() > 0
    assert moved[:n_net].all() and moved[n_net:].any()
    assert np.array_equal(moved.numpy(), np.asarray(jm.trainer.params) != before.numpy())


def test_nerf_config_training_steps_match_jax():
    """tests/test_nerf_config.py's NERF_CONFIG (SH degree 4 beside a 2^13
    hash grid), five training_step calls in both packages on the same
    numpy batches: losses, params, Adam's moments and the outputs."""
    jm = tc.create_from_config(6, 4, NERF_CONFIG, seed=3)
    tm = tt.create_from_config(6, 4, NERF_CONFIG, seed=3, device="cpu")
    np.testing.assert_array_equal(tm.params.numpy(), np.asarray(jm.trainer.params))
    r = np.random.default_rng(0)
    losses = []
    for _ in range(5):
        x, t = _batch(r, 512)
        losses.append((float(jm.training_step(x, t)), float(tm.training_step(np.asarray(x), np.asarray(t)))))
    lj, lt = np.array(losses).T
    np.testing.assert_allclose(lt, lj, rtol=1e-2)
    assert lt[-1] < lt[0]
    d = np.abs(tm.params.numpy() - np.asarray(jm.trainer.params))
    assert d.max() <= 1e-4, d.max()
    _assert_moments_near(tm, jm)
    x, _ = _batch(r, 256)
    assert_bf16_close(tm.trainer.inference(np.asarray(x)).numpy(), np.asarray(jm.inference(x)))


def test_frozen_server_table_dtype_on_the_composite_matches_jax():
    """A serve-time bfloat16 rounds the nested grid's served levels (all 8
    under gather_strategy "quad"), as the JAX package's prebuilt bf16
    tables; the SH part is untouched."""
    cfg = copy.deepcopy(NERF_CONFIG)
    jm = tc.create_from_config(6, 4, cfg, seed=5)
    tm = tt.create_from_config(6, 4, cfg, seed=5, device="cpu")
    r = np.random.default_rng(6)
    # Table entries of O(1), so the bf16 rounding shows.
    params = np.asarray(jm.trainer.params).copy()
    n_net = tm.model.network.n_params
    params[n_net:] = r.uniform(-1, 1, params.size - n_net).astype(np.float32)
    jm.trainer.params = jnp.asarray(params)
    tm.trainer.params = torch.from_numpy(params)
    grid = tm.model.encoding.nested[0]
    assert grid.served_levels() == [True] * grid.n_levels
    x, _ = _batch(r, 300)
    js = jm.trainer.freeze_serving(table_dtype="bfloat16")
    ts = tm.trainer.freeze_serving(table_dtype="bfloat16")
    got = ts(np.asarray(x))
    assert_bf16_close(got.numpy(), np.asarray(js(x)))
    assert not torch.equal(got, tm.trainer.freeze_serving()(np.asarray(x)))
    enc = tm.model.encoding
    xt = torch.from_numpy(np.asarray(x))
    served = enc.apply(tm.params[n_net:], xt, table_dtype="bfloat16")
    plain = enc.apply(tm.params[n_net:], xt)
    assert torch.equal(served[:, 16:], plain[:, 16:]) and not torch.equal(served[:, :16], plain[:, :16])


def test_sample_runs_on_the_cpu(tmp_path):
    """The port's sample, 3 steps of 64 rays with --device cpu: the JAX
    sample's outputs (loss curve, PSNR, ms/step, frames and field
    evaluations per second), every value finite, the loss falling; the
    served view is the rendered one."""
    out = tsample.main(["3", "64", str(tmp_path), "--device", "cpu"])
    assert set(out) >= {"loss_curve", "psnr_db", "ms_per_step", "fps", "evals_per_s"}
    assert [i for i, _ in out["loss_curve"]] == [0, 2]
    assert out["loss_curve"][-1][1] < out["loss_curve"][0][1]
    assert all(np.isfinite(v) for v in (out["psnr_db"], out["ms_per_step"], out["fps"], out["evals_per_s"]))
    assert out["n_params"] == 256480
    assert out["served_psnr_db"] == pytest.approx(out["psnr_db"], rel=1e-6)
    assert np.load(tmp_path / "nerf_pred.npy").shape == np.load(tmp_path / "nerf_gt.npy").shape == (128, 128, 3)
