"""The port's SDF sample (``tcnn_tpu_torch.samples.sdf_learning``) against the
JAX package's ``samples/sdf_learning.py``, on the CPU.

- ``CONFIG`` equals the JAX sample's, and both packages build the same
  model from it: bitwise-equal initial parameters;
- ``target_sdf`` on a numpy draw: max |diff| <= 1e-6 (fp32 norms and
  square roots of values below 1, the same operations);
- ``total_loss`` and its parameter gradient at the same parameters and
  points against the JAX sample's total loss (samples/sdf_learning.py:82-91,
  rebuilt here over ``tcnn_tpu``'s ``net.apply``): loss, data and eikonal
  terms within 1e-5 relative; the gradient's table part within 1e-4 of the
  JAX package's in norm and in max |diff| relative to max |JAX| (fp32 sums
  in another order: ~1e-5 measured), its network part within 1e-2 (the
  eikonal term backpropagates through the bf16 network twice, and bf16
  roundings of its cotangents fall at other points: ~4e-3 measured);
- the eikonal term's gradient stays finite where grad_x f is exactly 0;
- a 120-step fit at batch 2048 meets the JAX sample test's criteria
  (tests/test_samples.py:31-54): the last logged loss below a fifth of the
  first, validation sdf-l2 < 5e-3, eikonal residual < 0.5.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcnn_tpu as tc
import tcnn_tpu_torch as tt
from tcnn_tpu_torch.samples import sdf_learning as ts

_spec = importlib.util.spec_from_file_location(
    "jax_sdf_learning", Path(__file__).resolve().parents[1] / "samples" / "sdf_learning.py")
js = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(js)


def test_config_equals_the_jax_sample():
    assert ts.CONFIG == js.CONFIG
    assert ts.EIKONAL_WEIGHT == 0.01


def test_target_sdf_matches_jax():
    x = np.random.default_rng(3).uniform(-0.1, 1.1, (4096, 3)).astype(np.float32)
    got = ts.target_sdf(torch.from_numpy(x)).numpy()
    want = np.asarray(js.target_sdf(jnp.asarray(x)))
    assert got.shape == want.shape == (4096,)
    assert np.abs(got - want).max() <= 1e-6


def _jax_total_loss(net):
    """The JAX sample's ``total_loss`` (samples/sdf_learning.py:82-91)."""

    def total_loss(params, x, d_true):
        d_pred = net.apply(params, x)[:, 0].astype(jnp.float32)
        data = jnp.mean((d_pred - d_true) ** 2)

        def f_scalar(pt):
            return net.apply(params, pt[None, :])[0, 0].astype(jnp.float32)

        grads = jax.vmap(jax.grad(f_scalar))(x)
        eik = jnp.mean((jnp.linalg.norm(grads, axis=-1) - 1.0) ** 2)
        return data + 0.01 * eik, (data, eik)

    return jax.jit(jax.value_and_grad(total_loss, has_aux=True))


def _assert_near(got, want, rtol):
    assert got.shape == want.shape and np.isfinite(got).all() and np.abs(want).max() > 0
    assert np.linalg.norm(got - want) <= rtol * np.linalg.norm(want)
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


def test_total_loss_and_gradient_match_jax():
    jm = tc.create_from_config(3, 1, js.CONFIG)
    tm = tt.create_from_config(3, 1, ts.CONFIG, device="cpu")
    np.testing.assert_array_equal(tm.params.numpy(), np.asarray(jm.trainer.params))
    x = np.random.default_rng(1).random((256, 3), np.float32)
    d = ts.target_sdf(torch.from_numpy(x))
    (loss, (data, eik)), g = _jax_total_loss(jm.model)(jm.trainer.params, jnp.asarray(x), jnp.asarray(d.numpy()))
    params = tm.model.params
    t_loss, (t_data, t_eik) = ts.total_loss(tm.model, params, torch.from_numpy(x), d)
    (t_g,) = torch.autograd.grad(t_loss, params)
    for a, b in ((t_loss, loss), (t_data, data), (t_eik, eik)):
        assert abs(float(a.detach()) - float(b)) <= 1e-5 * abs(float(b))
    n_net = tm.model.network.n_params
    g, t_g = np.asarray(g), t_g.numpy()
    _assert_near(t_g[:n_net], g[:n_net], 1e-2)
    _assert_near(t_g[n_net:], g[n_net:], 1e-4)


def test_eikonal_gradient_is_finite_at_a_zero_spatial_gradient():
    tm = tt.create_from_config(3, 1, ts.CONFIG, device="cpu")
    with torch.no_grad():
        tm.model.params.zero_()  # f = 0 everywhere: grad_x f = 0, |grad_x f| at its kink
    x = torch.from_numpy(np.random.default_rng(2).random((64, 3), np.float32))
    loss, (_, eik) = ts.total_loss(tm.model, tm.model.params, x, ts.target_sdf(x))
    (g,) = torch.autograd.grad(loss, tm.model.params)
    assert float(eik.detach()) == 1.0
    assert bool(torch.isfinite(g).all())


@pytest.fixture
def one_thread():
    """The plain grid code's small ops gain nothing from torch's threads,
    and under parallel test workers the threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_fit_meets_the_jax_sample_criteria(capsys, one_thread):
    d, e, hist = ts.fit(n_steps=120, batch=2048, log_every=60, device="cpu")
    assert len(hist) == 3 and hist[-1] < hist[0] * 0.2, hist
    assert d < 5e-3 and e < 0.5, (d, e)
    out = capsys.readouterr().out
    assert "step   120" in out and "validation sdf-l2" in out


@pytest.mark.parametrize("argv", [["2", "64", "--device", "cpu"]])
def test_main_runs_on_the_cpu(argv, capsys):
    d, e, hist = ts.main(argv)
    assert np.isfinite([d, e, *hist]).all() and len(hist) == 1
    assert "done in" in capsys.readouterr().out
