"""The port's realtime-render and fused-ray-marcher samples against the JAX
package's ``samples/realtime_render.py`` and ``samples/fused_ray_marcher.py``,
on the CPU.

- ``base_grid`` and ``view(i)`` equal the JAX sample's pan/zoom formula
  (:105-121) bit for bit (the same fp32 products and sums);
- a ``FrozenServer`` of the image sample's DEFAULT_CONFIG at the same
  parameters: its static frame (``raster``) and its moving frames
  (``server(view(i))``) at side 32 against ``tcnn_tpu``'s ``FrozenServer``,
  ``assert_bf16_close`` (the model's bf16 outputs; fp32 sums in another
  order flip roundings);
- the eager march ``render_plain`` of the ray marcher's model at the same
  parameters, 64 rays x 8 steps, against the JAX march written from
  samples/fused_ray_marcher.py:59-84: colour within 2.25 and transmittance
  within 1 times 4 bf16 ulps of the largest raw output (the models' raw
  outputs agree to 4 bf16 ulps; sigmoid' <= 1/4 and softplus', exp' <= 1,
  and the steps' alpha * dt sum to 1, which bounds how far the compositing
  can carry that difference); ``Marcher`` on the CPU is the eager march;
- both samples' ``main`` at toy sizes on the CPU.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_ffmlp import assert_bf16_close

import tcnn_tpu as tc
import tcnn_tpu_torch as tt
from tcnn_tpu.rng import make_rng
from tcnn_tpu_torch.samples import fused_ray_marcher as tfm
from tcnn_tpu_torch.samples import mlp_learning_an_image as timage
from tcnn_tpu_torch.samples import realtime_render as trr

ROOT = Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "samples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jfm = _load("fused_ray_marcher")
SIDE = 32
FRAMES = 120


def _jax_view(side, frames):
    """The JAX sample's base grid and ``view`` (samples/realtime_render.py:
    105-121)."""
    base = jnp.asarray(
        np.stack(
            np.meshgrid((np.arange(side) + 0.5) / side, (np.arange(side) + 0.5) / side, indexing="ij"), axis=-1,
        ).reshape(side * side, 2)[:, ::-1].copy()
    )

    def view(i):
        zoom = 0.6 + 0.4 * np.cos(2 * np.pi * i / frames)
        pan = 0.5 * (1 - zoom)
        ox = pan * (0.5 + 0.5 * np.sin(2 * np.pi * i / frames))
        oy = pan
        return base * zoom + jnp.asarray([ox, oy], jnp.float32)

    return base, view


@pytest.mark.parametrize("side", [1, 7, SIDE])
def test_base_grid_equals_jax(side):
    base, _ = _jax_view(side, FRAMES)
    got = trr.base_grid(side, "cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(base))


@pytest.mark.parametrize("i", [0, 1, 17, 30, 60, 97, 119])
def test_view_equals_jax(i):
    _, view = _jax_view(SIDE, FRAMES)
    got = trr.view(trr.base_grid(SIDE, "cpu"), i, FRAMES)
    np.testing.assert_array_equal(got.numpy(), np.asarray(view(i)))


def _random_tables(n_params, n_net, seed, scale):
    """Flat parameters from numpy: the network's at +-0.3, the table's at
    +-scale, so that the field varies over the unit cube."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-0.3, 0.3, n_net), rng.uniform(-scale, scale, n_params - n_net)]).astype(
        np.float32)


@pytest.fixture(scope="module")
def image_pair():
    jm = tc.create_from_config(2, 3, timage.DEFAULT_CONFIG)
    tm = tt.create_from_config(2, 3, timage.DEFAULT_CONFIG, device="cpu")
    flat = _random_tables(tm.model.n_params, tm.model.network.n_params, 5, 0.5)
    jm.trainer.params = jnp.asarray(flat)
    tm.trainer.params = tt.params_from_numpy(flat, tm.model)
    return jm.trainer.freeze_serving(), tm.trainer.freeze_serving()


def test_static_frame_matches_jax(image_pair):
    js, ts_ = image_pair
    got = ts_.raster((SIDE, SIDE))
    assert got.shape == (SIDE * SIDE, 3) and float(got.std()) > 1e-3
    assert_bf16_close(got.numpy(), np.asarray(js.raster((SIDE, SIDE))))


@pytest.mark.parametrize("i", [0, 45, 100])
def test_moving_frame_matches_jax(image_pair, i):
    js, ts_ = image_pair
    _, view = _jax_view(SIDE, FRAMES)
    got = ts_(trr.view(trr.base_grid(SIDE, "cpu"), i, FRAMES))
    assert_bf16_close(got.numpy(), np.asarray(js(view(i))))


def _jax_march(model, params, origins, dirs, n_steps):
    """The JAX sample's ``render`` (samples/fused_ray_marcher.py:59-84)."""
    dt = 1.0 / n_steps

    def step(carry, i):
        color, transmittance = carry
        t = (i.astype(jnp.float32) + 0.5) * dt
        pos = origins + dirs * t
        raw = model.apply(params, pos).astype(jnp.float32)
        sigma = jax.nn.softplus(raw[:, 0:1])
        rgb = jax.nn.sigmoid(raw[:, 1:4])
        alpha = 1.0 - jnp.exp(-sigma * dt)
        color = color + transmittance * alpha * rgb
        transmittance = transmittance * (1.0 - alpha)
        return (color, transmittance), raw

    init = (jnp.zeros((origins.shape[0], 3)), jnp.ones((origins.shape[0], 1)))
    (color, transmittance), raws = jax.lax.scan(step, init, jnp.arange(n_steps))
    return color, transmittance, raws


def test_config_and_sizes_equal_the_jax_sample():
    assert tfm.CONFIG == jfm.CONFIG
    assert (tfm.N_RAYS, tfm.N_STEPS) == (4096, 64)


@pytest.mark.parametrize("scale", [0.0, 2.0])
def test_render_plain_matches_jax(scale):
    """``scale`` 0: the sample's own PCG32 parameters; else
    ``_random_tables``, a field with structure."""
    n_rays, n_steps = 64, 8
    jmodel = tc.NetworkWithInputEncoding(3, 4, encoding_config=jfm.CONFIG["encoding"],
                                         network_config=jfm.CONFIG["network"])
    tmodel, tparams = tfm.make_model("cpu")
    flat = np.asarray(jmodel.initialize_params(make_rng(1337)), np.float32)
    np.testing.assert_array_equal(tparams.numpy(), flat)
    if scale:
        flat = _random_tables(flat.size, tmodel.network.n_params, 9, scale)
        tparams = torch.from_numpy(flat)
    origins, dirs = tfm.make_rays(n_rays, device="cpu")
    dirs = dirs + torch.from_numpy(np.random.default_rng(4).uniform(-0.3, 0.3, (n_rays, 3)).astype(np.float32))
    color, trans, raws = _jax_march(jmodel, jnp.asarray(flat), jnp.asarray(origins.numpy()),
                                    jnp.asarray(dirs.numpy()), n_steps)
    got_c, got_t = tfm.render_plain(tmodel, tparams, origins, dirs, n_steps)
    assert got_c.shape == (n_rays, 3) and got_t.shape == (n_rays, 1)
    top = float(np.abs(np.asarray(raws)).max())
    ulp4 = 4 * 2.0 ** (np.floor(np.log2(top)) - 7)
    assert np.abs(got_c.numpy() - np.asarray(color)).max() <= 2.25 * ulp4
    assert np.abs(got_t.numpy() - np.asarray(trans)).max() <= ulp4
    if scale:
        assert float(got_c.std()) > 1e-3 and float(got_t.std()) > 1e-3
    c2, t2 = tfm.Marcher(tmodel, tparams, n_rays, n_steps)(origins, dirs)
    assert torch.equal(c2, got_c) and torch.equal(t2, got_t)


def test_realtime_render_main_runs_on_the_cpu(tmp_path, capsys):
    out = trr.main(["--device", "cpu", "--steps", "3", "--side", "16", "--frames", "2", "--batch", "256",
                    "--out", str(tmp_path / "frame.npy")])
    text = capsys.readouterr().out
    assert "static view :" in text and "moving view :" in text and "trained 3 steps" in text
    assert np.isfinite([out["loss"], out["static_fps"], out["moving_fps"]]).all()
    assert np.load(tmp_path / "frame.npy").shape == (16, 16, 3)


def test_fused_ray_marcher_main_runs_on_the_cpu(capsys):
    out = tfm.main(["--device", "cpu", "--rays", "32", "--steps", "4", "--renders", "2"])
    text = capsys.readouterr().out
    assert "compile+first render" in text and "rays x 4 steps" in text and "mean transmittance" in text
    assert 0 < out["mean_transmittance"] <= 1


def test_make_rays_defaults_to_the_card():
    """``make_rays`` resolves its device as ``make_model`` does: with no
    device named it puts the rays on the card, and raises where there is
    none; ``device="cpu"`` gives the CPU rays."""
    origins, dirs = tfm.make_rays(8, device="cpu")
    assert origins.device.type == dirs.device.type == "cpu" and origins.shape == dirs.shape == (8, 3)
    if torch.cuda.is_available():
        assert tfm.make_rays(8)[0].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tfm.make_rays(8)
