"""Packed-I/O fused MLP (K7/K8): the PyTorch port's ``apply_packed`` against
the JAX package's.

The same numpy inputs go through the port's ``FullyFusedMLP.apply_packed``
(on the CPU the block-diagonal plain versions, the references of the CUDA
kernels) and through the JAX ``FullyFusedMLP.apply_packed`` (the Pallas
kernels ``mlp_forward_pallas_packed`` / ``mlp_backward_pallas_packed`` in
interpret mode). The batch is the compact row-major (B, w) array viewed as
(B/G, 128), G = 128/w.

Tolerances, those of tests/test_ffmlp_packed.py: outputs rtol 2e-2, atol
2e-3; parameter gradients rtol 3e-2, atol 3e-2 of max |gradient|; input
gradients rtol 3e-2, atol 2e-2. Both sides take exact bf16 products with
fp32 sums and round at the same places (each layer's output; the bf16 delta;
dW summed over the batch in fp32 and rounded once; dx), so they differ only
in the order of fp32 sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcnn_tpu.common as jcommon
import tcnn_tpu_torch.common as tcommon
from tcnn_tpu.networks.fully_fused import FullyFusedMLP as JaxFFMLP
from tcnn_tpu_torch.networks.fully_fused import FullyFusedMLP
from tcnn_tpu_torch.ops import ffmlp


def _pair(width, out_dims, n_hidden, in_width=None, act="ReLU"):
    kw = dict(input_width=in_width or width, output_width=out_dims, n_neurons=width, n_hidden_layers=n_hidden)
    jnet = JaxFFMLP(**kw, activation=jcommon.Activation(act), output_activation=jcommon.Activation.NONE)
    tnet = FullyFusedMLP(**kw, activation=tcommon.Activation(act), output_activation=tcommon.Activation.NONE)
    return jnet, tnet


def _data(net, batch, seed, in_width):
    r = np.random.default_rng(seed)
    params = (r.standard_normal(net.n_params) * 0.3).astype(np.float32)
    x = r.uniform(-1, 1, (batch, in_width)).astype(np.float32)
    return params, x


def _outputs(jnet, tnet, params, x):
    B, w = x.shape
    xp = x.reshape(B * w // 128, 128)
    want = np.asarray(jnet.apply_packed(jnp.asarray(params), jnp.asarray(xp)), np.float32)
    got = tnet.apply_packed(torch.from_numpy(params), torch.from_numpy(xp))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    return got.float().numpy(), want


@pytest.mark.parametrize("width", [16, 32, 64])
@pytest.mark.parametrize("out_dims", [1, 3, 16])
def test_packed_outputs_match_jax(width, out_dims):
    jnet, tnet = _pair(width, out_dims, 3)
    params, x = _data(jnet, 1024, 0, width)
    got, want = _outputs(jnet, tnet, params, x)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-3)
    # Unpacking is a reshape: the same values as the unpacked apply.
    plain = tnet.apply(torch.from_numpy(params), torch.from_numpy(x)).float().numpy()
    np.testing.assert_allclose(got.reshape(plain.shape), plain, rtol=2e-2, atol=2e-3)


@pytest.mark.parametrize("width", [16, 32, 64])
@pytest.mark.parametrize("out_dims", [1, 3, 16])
def test_packed_gradients_match_jax(width, out_dims):
    jnet, tnet = _pair(width, out_dims, 2)
    params, x = _data(jnet, 512, 5, width)
    xp = x.reshape(-1, 128)

    def loss(p, xx):
        return jnet.apply_packed(p, xx).astype(jnp.float32).sum()

    gp_j, gx_j = jax.grad(loss, argnums=(0, 1))(jnp.asarray(params), jnp.asarray(xp))
    pt = torch.from_numpy(params).requires_grad_(True)
    xt = torch.from_numpy(xp).requires_grad_(True)
    gp, gx = torch.autograd.grad(tnet.apply_packed(pt, xt).float().sum(), (pt, xt))
    gp_j = np.asarray(gp_j)
    np.testing.assert_allclose(gp.numpy(), gp_j, rtol=3e-2, atol=3e-2 * np.abs(gp_j).max())
    np.testing.assert_allclose(gx.numpy(), np.asarray(gx_j, np.float32), rtol=3e-2, atol=2e-2)


def test_packed_zero_hidden_layers_and_ragged_rows():
    """n_hidden_layers=0 applies the one matrix once; a row count that is
    no multiple of any tile (37 rows of G samples) works, as in JAX."""
    for n_hidden, batch in ((0, 512), (2, 8 * 37)):
        jnet, tnet = _pair(16, 2, n_hidden)
        params, x = _data(jnet, batch, 3 + n_hidden, 16)
        got, want = _outputs(jnet, tnet, params, x)
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-3)


def test_packed_backward_plain_is_the_block_diagonal_backward():
    """K8's plain version against autograd of K7's: the same rounding places
    except that autograd rounds nothing in between, so equal to bf16
    tolerance; and dW is summed over the whole batch once (no per-tile
    rounding)."""
    jnet, tnet = _pair(32, 3, 2)
    params, x = _data(jnet, 256, 7, 32)
    ws = [w.bfloat16() for w in tnet._weights(torch.from_numpy(params))]
    xp = torch.from_numpy(x.reshape(-1, 128)).bfloat16()
    g = torch.ones((xp.shape[0], 4 * 16), dtype=torch.bfloat16)
    dx, dws = ffmlp.ffmlp_backward_packed(xp, g, ws, tcommon.Activation.ReLU, tcommon.Activation.NONE)
    dx_u, dws_u = ffmlp.ffmlp_backward_plain(
        xp.view(-1, 32), g.view(-1, 16), ws, tcommon.Activation.ReLU, tcommon.Activation.NONE
    )
    assert dx.shape == xp.shape and torch.equal(dx.view(-1, 32), dx_u)
    for a, b in zip(dws, dws_u):
        torch.testing.assert_close(a.float(), b.float(), rtol=1e-2, atol=1e-2 * float(b.float().abs().max()))


def test_packed_rejects_what_jax_rejects():
    for width, in_width in ((128, 128), (64, 32)):
        jnet, tnet = _pair(width, 3, 2, in_width=in_width)
        params = torch.zeros(tnet.n_params)
        with pytest.raises(ValueError, match="narrow uniform"):
            jnet.apply_packed(jnp.zeros(tnet.n_params), jnp.zeros((8, 128), jnp.float32))
        with pytest.raises(ValueError, match="narrow uniform"):
            tnet.apply_packed(params, torch.zeros((8, 128)))
    jnet, tnet = _pair(32, 3, 2)
    with pytest.raises(ValueError, match=r"\(batch/G, 128\)"):
        tnet.apply_packed(torch.zeros(tnet.n_params), torch.zeros((8, 64)))
    assert ffmlp.packed_group(32, [torch.zeros(32, 32)] * 3) == 4
    assert ffmlp.packed_group(48, [torch.zeros(48, 48)] * 3) == 1


def test_packed_wrapper_rejects_other_devices():
    ws = [torch.zeros((16, 16), dtype=torch.bfloat16, device="meta")] * 2
    x = torch.zeros((4, 128), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ffmlp.ffmlp_forward_packed(x, ws, tcommon.Activation.ReLU, tcommon.Activation.NONE)
    with pytest.raises(ValueError, match="unsupported device"):
        ffmlp.ffmlp_backward_packed(x, x, ws, tcommon.Activation.ReLU, tcommon.Activation.NONE)


def test_packed_second_order_is_the_chain_on_the_unpacked_view():
    """A create_graph backward through apply_packed runs autograd of the
    plain chain, as through apply: the input gradient and its gradient with
    respect to the params equal those of the unpacked chain."""
    _, tnet = _pair(32, 3, 2)
    params, x = _data(tnet, 64, 11, 32)
    grads = []
    for packed in (True, False):
        p = torch.from_numpy(params).requires_grad_(True)
        xt = torch.from_numpy(x.reshape(-1, 128) if packed else x).requires_grad_(True)
        y = tnet.apply_packed(p, xt) if packed else tnet.apply(p, xt)
        (gx,) = torch.autograd.grad(y.float().sum(), xt, create_graph=True)
        (gp,) = torch.autograd.grad(gx.float().square().sum(), p)
        grads.append((gx.reshape(x.shape), gp))
    assert torch.equal(grads[0][0], grads[1][0]) and torch.equal(grads[0][1], grads[1][1])
