"""Fused MLP backward: the PyTorch port's plain version against the JAX
package.

The same numpy inputs (x, the output gradient g, the weights) go through
the port's ``ffmlp_backward`` (on the CPU ``ffmlp_backward_plain``, the
reference of the CUDA kernel), through the JAX Pallas kernel
``mlp_backward_pallas`` in interpret mode (``rm`` and ``cf`` layouts) and
through ``jax.vjp`` of ``ffmlp_apply`` (the custom VJP the JAX trainer
differentiates). dx and every dW are compared; dW in the port is (fan_out,
fan_in), the JAX kernels' transpose.

Tolerance: that of test_torch_port_ffmlp.py, ``match_rae(eps=1e-2,
percentile=99)`` and max |diff| <= 4 bf16 ulps of max |ref|: both sides
take exact bf16 products with fp32 sums and round at the same places (d16,
the summed dW, dx), but the sums run in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_ffmlp import ACTS, IN_WIDTH, N_HIDDEN, WIDTHS, _inputs, _nets, assert_bf16_close

import tcnn_tpu.common as jcommon
import tcnn_tpu.networks.activations as jact
import tcnn_tpu_torch.common as tcommon
import tcnn_tpu_torch.networks as tnets
from tcnn_tpu.ops.ffmlp import ffmlp_apply, mlp_backward_pallas
from tcnn_tpu.ops.pallas_utils import set_interpret_mode
from tcnn_tpu_torch.networks.activations import activation_backward
from tcnn_tpu_torch.ops.ffmlp import FfmlpFunction, ffmlp_backward, ffmlp_backward_plain


def _bf16_np(a):
    return np.asarray(jnp.asarray(jnp.asarray(a, jnp.bfloat16), jnp.float32))


def _case(width, n_hidden, act, out_act, seed):
    jnet, tnet = _nets(width, n_hidden, act, out_act)
    params, x = _inputs(jnet, seed=seed, act=act)
    g = np.random.default_rng(seed + 1).uniform(-1, 1, (x.shape[0], 16)).astype(np.float32)
    ws = [_bf16_np(w) for w in jnet._weights(jnp.asarray(params))]
    return tnet, params, _bf16_np(x), _bf16_np(g), ws


def _port(x, g, ws, act, out_act):
    dx, dws = ffmlp_backward(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(g).bfloat16(),
        [torch.from_numpy(w).bfloat16() for w in ws], tcommon.Activation(act), tcommon.Activation(out_act),
    )
    assert dx.dtype == torch.bfloat16 and all(d.dtype == torch.bfloat16 for d in dws)
    return dx.float().numpy(), [d.float().numpy() for d in dws]


def _jax_kernel(x, g, ws, act, out_act, layout):
    set_interpret_mode(True)
    try:
        dx, dws = mlp_backward_pallas(
            jnp.asarray(x, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16),
            tuple(jnp.asarray(w, jnp.bfloat16).T for w in ws),
            jcommon.Activation(act), jcommon.Activation(out_act), layout=layout,
        )
    finally:
        set_interpret_mode(None)
    # _ffmlp_bwd rounds the summed partials to the weights' dtype.
    return np.asarray(dx, np.float32), [_bf16_np(d).T for d in dws]


def _jax_vjp(x, g, ws, act, out_act):
    set_interpret_mode(True)
    try:
        weights_t = tuple(jnp.asarray(w, jnp.bfloat16).T for w in ws)
        _, vjp = jax.vjp(
            lambda xx, wt: ffmlp_apply(xx, wt, jcommon.Activation(act), jcommon.Activation(out_act)),
            jnp.asarray(x, jnp.bfloat16), weights_t,
        )
        dx, dwt = vjp(jnp.asarray(g, jnp.bfloat16))
    finally:
        set_interpret_mode(None)
    return np.asarray(dx, np.float32), [np.asarray(d, np.float32).T for d in dwt]


def _assert_same(got, want):
    assert_bf16_close(got[0], want[0])
    assert len(got[1]) == len(want[1])
    for a, b in zip(got[1], want[1]):
        assert a.shape == b.shape
        assert_bf16_close(a, b)


@pytest.mark.parametrize("n_hidden", N_HIDDEN)
@pytest.mark.parametrize("width", WIDTHS)
def test_backward_plain_matches_jax(width, n_hidden):
    """Each width and depth against both Pallas layouts and the custom VJP;
    the hidden and output activations cycle over the ten."""
    i = WIDTHS.index(width) * len(N_HIDDEN) + N_HIDDEN.index(n_hidden)
    act, out_act = ACTS[i % len(ACTS)], ACTS[(i + 5) % len(ACTS)]
    _, _, x, g, ws = _case(width, n_hidden, act, out_act, seed=200 + i)
    got = _port(x, g, ws, act, out_act)
    for layout in ("rm", "cf"):
        _assert_same(got, _jax_kernel(x, g, ws, act, out_act, layout))
    _assert_same(got, _jax_vjp(x, g, ws, act, out_act))


@pytest.mark.parametrize("act", ACTS)
def test_backward_plain_matches_jax_every_activation(act):
    """Every activation as both the hidden and the output activation."""
    k = ACTS.index(act)
    _, _, x, g, ws = _case(32, 1, act, act, seed=300 + k)
    got = _port(x, g, ws, act, act)
    _assert_same(got, _jax_kernel(x, g, ws, act, act, ("rm", "cf")[k % 2]))


@pytest.mark.parametrize("act", ACTS)
def test_activation_backward_matches_jax_autodiff(act):
    """``activation_backward`` against ``jax.vjp`` of the JAX package's
    forms, fp32; ReLU away from its kink (at 0 the fused backward, and the
    port, take 0)."""
    rng = np.random.default_rng(ACTS.index(act))
    z = rng.uniform(-3, 3, 4096).astype(np.float32)
    g = rng.uniform(-1, 1, 4096).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jact.activation_fn(t, jcommon.Activation(act)), jnp.asarray(z))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    got = activation_backward(torch.from_numpy(g), torch.from_numpy(z), tcommon.Activation(act)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if act == "ReLU":
        zero = activation_backward(torch.ones(1), torch.zeros(1), tcommon.Activation.ReLU)
        assert float(zero) == 0.0


def test_function_backward_is_the_plain_backward():
    """On the CPU ``FullyFusedMLP.apply`` differentiates through
    ``FfmlpFunction``, whose backward is the plain backward; the weight
    gradients land in the flat parameter gradient at the layers' offsets,
    upcast from bf16."""
    width, n_hidden, act = 64, 2, "Sine"
    tnet = tnets.create_network(IN_WIDTH, 3, {
        "otype": "FullyFusedMLP", "n_neurons": width, "n_hidden_layers": n_hidden, "activation": act,
    })
    rng = np.random.default_rng(0)
    params = torch.from_numpy(rng.uniform(-0.3, 0.3, tnet.n_params).astype(np.float32)).requires_grad_(True)
    x = torch.from_numpy(rng.uniform(-1, 1, (300, IN_WIDTH)).astype(np.float32)).bfloat16().requires_grad_(True)
    out = tnet.apply(params, x)
    g = torch.from_numpy(rng.uniform(-1, 1, out.shape).astype(np.float32)).bfloat16()
    dparams, dx = torch.autograd.grad(out, (params, x), g)
    ws = [w.detach().bfloat16() for w in tnet._weights(params)]
    dx_p, dws_p = ffmlp_backward_plain(x.detach(), g, ws, tcommon.Activation(act), tcommon.Activation.NONE)
    assert torch.equal(dx, dx_p)
    assert torch.equal(dparams, torch.cat([d.float().reshape(-1) for d in dws_p]))
    # The plain route on any device is the same Function with plain=True.
    out2 = tnet.apply_plain(params, x)
    assert torch.equal(out2, out)
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        y = FfmlpFunction.apply(x, tcommon.Activation.ReLU, tcommon.Activation.NONE, True, *[w.requires_grad_() for w in ws])
        (gx,) = torch.autograd.grad(y.float().sum(), x, create_graph=True)
