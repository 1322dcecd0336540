"""Parameterless encodings of the port against the JAX package: OneBlob
(``tcnn_tpu/encodings/basic.py:115-165``).

Tolerances: the forward within 1e-6 absolute (the same fp32 elementwise
operations in the same order; values in [0, 1]); the input gradient within
1e-4 of max |ref| (each output is a difference of clamped quartic CDFs whose
derivatives, of size up to n_bins, cancel across the three wrapped terms,
and the two frameworks may contract multiply-adds differently).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcnn_tpu as tc
import tcnn_tpu_torch as tt
from tcnn_tpu_torch.encodings import OneBlobEncoding


def _points(n, d, seed):
    r = np.random.default_rng(seed)
    # Bin boundaries, their neighbours, the wrap-around edges and points
    # outside [0, 1] besides uniform samples.
    edge = np.array([0.0, 1.0, 0.5, 1 / 64, 63 / 64, -0.25, 1.25], np.float32)
    x = r.uniform(0, 1, (n, d)).astype(np.float32)
    x[: len(edge)] = edge[:, None]
    x[len(edge): 2 * len(edge)] = np.nextafter(edge, np.float32(2))[:, None]
    return x


@pytest.mark.parametrize("n_bins", [4, 16, 64])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_oneblob_forward_matches_jax(n_bins, d):
    x = _points(512, d, n_bins + d)
    je = tc.create_encoding(d, {"otype": "OneBlob", "n_bins": n_bins}, alignment=16)
    te = tt.create_encoding(d, {"otype": "OneBlob", "n_bins": n_bins}, alignment=16)
    je.output_dtype = jnp.float32
    te.output_dtype = torch.float32
    assert isinstance(te, OneBlobEncoding) and te.padded_output_width == je.padded_output_width
    want = np.asarray(je.apply(None, jnp.asarray(x)))
    got = te.apply(torch.zeros(0), torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (512, te.padded_output_width)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # Padding columns hold 1.0; each dim's bins sum to one (a partition of unity).
    np.testing.assert_array_equal(got[:, d * n_bins:], 1.0)
    np.testing.assert_allclose(got[:, : d * n_bins].reshape(512, d, n_bins).sum(-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("n_bins", [16, 64])
def test_oneblob_input_gradient_matches_jax(n_bins):
    d = 2
    x = _points(256, d, 7)
    r = np.random.default_rng(8)
    je = tc.create_encoding(d, {"otype": "OneBlob", "n_bins": n_bins}, alignment=16)
    te = tt.create_encoding(d, {"otype": "OneBlob", "n_bins": n_bins}, alignment=16)
    je.output_dtype = jnp.float32
    te.output_dtype = torch.float32
    g = r.normal(size=(256, te.padded_output_width)).astype(np.float32)
    want = np.asarray(jax.grad(lambda xx: jnp.sum(je.apply(None, xx) * g))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    (got,) = torch.autograd.grad((te.apply(torch.zeros(0), xt) * torch.from_numpy(g)).sum(), xt)
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()


def test_oneblob_config_surface():
    """Registered as "OneBlob" (default n_bins 16, as the JAX factory),
    bf16 output by default, n_bins a power of two."""
    te = tt.create_encoding(2, {"otype": "OneBlob"}, alignment=16)
    assert te.n_bins == 16 and te.n_output_dims == 32 and te.n_params == 0
    assert "OneBlob" in tt.builtin_encodings()
    y = te.apply(torch.zeros(0), torch.rand(5, 2))
    assert y.dtype == torch.bfloat16 and y.shape == (5, 32)
    with pytest.raises(ValueError, match="power of two"):
        tt.create_encoding(2, {"otype": "OneBlob", "n_bins": 12})
    # Differentiable twice (an eikonal-style loss over the encoding).
    te.output_dtype = torch.float32
    x = torch.rand(8, 2, requires_grad=True)
    (gx,) = torch.autograd.grad(te.apply(torch.zeros(0), x).square().sum(), x, create_graph=True)
    (gxx,) = torch.autograd.grad(gx.sum(), x)
    assert torch.isfinite(gxx).all()


def test_oneblob_model_matches_jax():
    """OneBlob-64 into a FullyFusedMLP (bench_image's model at a small
    width): the same params give the same outputs, within the bf16 network
    tolerance of tests/test_torch_port_ffmlp.py (4 bf16 ulps of max |ref|)."""
    cfg = {"encoding": {"otype": "OneBlob", "n_bins": 64},
           "network": {"otype": "FullyFusedMLP", "n_neurons": 32, "n_hidden_layers": 2}}
    jm = tc.create_from_config(2, 3, cfg)
    tm = tt.create_from_config(2, 3, cfg, device="cpu")
    assert tm.model.n_params == jm.trainer.n_params
    params = np.asarray(jm.trainer.params)
    np.testing.assert_array_equal(tm.params.numpy(), params)
    x = _points(300, 2, 3)
    want = np.asarray(jm.inference(jnp.asarray(x)), np.float32)
    got = tm.inference(x).numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got - want).max() <= 4 * ulp
