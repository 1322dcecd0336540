"""Second order through the port's module API, against the JAX package.

Mirrors tests/test_torch_second_order.py (the reference's gradcheck and
gradgradcheck protocol, scripts/test_grid_bwdbwd.py:119-133) for
``tcnn_tpu_torch.modules``, whose input gradient and double backward are the
grid's G1/G2 kernels (their plain versions on the CPU) and, through
FullyFusedMLP, the differentiable chain (as the JAX package routes second-
order traces, tcnn_tpu/networks/fully_fused.py:145-162). Exactness is held
against ``jax.grad`` of ``jax.grad`` of the JAX modules.

Tolerances: gradcheck and gradgradcheck as the JAX bridge's test (fp32,
eps 1e-3, atol and rtol 1e-2). The fp32 ``Encoding`` against JAX: rtol
1e-5, atol 1e-6 (the same fp32 products, summed in another order). Through
``NetworkWithInputEncoding`` + FullyFusedMLP, whose activations and
cotangents are rounded to bf16 at every layer on both sides: 1e-3 of the
norm, as bf16 roundings that flip in another sum order move single entries
by an ulp of bf16 (2^-8 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import autograd

import tcnn_tpu.modules as jm
import tcnn_tpu_torch.modules as tm
from tcnn_tpu_torch.ops import grid_encode as ge

# Smoothstep: a C1 forward, so finite differences of the backward are
# well-posed (the reference's bwdbwd script uses smoothstep for the same
# reason).
ENC = {
    "otype": "HashGrid", "n_levels": 3, "n_features_per_level": 2,
    "log2_hashmap_size": 8, "base_resolution": 4, "per_level_scale": 1.6,
    "interpolation": "Smoothstep",
}
# Interior points away from cell boundaries.
X0 = np.array([[0.17, 0.55], [0.63, 0.29], [0.41, 0.87]], np.float32)


@pytest.fixture(scope="module")
def enc():
    return tm.Encoding(2, ENC, seed=11, device="cpu")


def test_gradcheck_wrt_input(enc):
    x = torch.from_numpy(X0.copy()).requires_grad_(True)
    assert autograd.gradcheck(lambda xx: enc(xx), (x,), eps=1e-3, atol=1e-2, rtol=1e-2)


def test_gradgradcheck_wrt_input(enc):
    x = torch.from_numpy(X0.copy()).requires_grad_(True)
    assert autograd.gradgradcheck(lambda xx: enc(xx), (x,), eps=1e-3, atol=1e-2, rtol=1e-2)


def _jax_eikonal_like(j, n_out, w, x0):
    def first(p, xx):
        return jnp.sum(j.apply(p, xx)[:, :n_out].astype(jnp.float32) * w)

    def second(p, xx):
        g = jax.grad(first, argnums=1)(p, xx)
        return jnp.sum(g * g)

    return jax.grad(second, argnums=(0, 1))(j.params, jnp.asarray(x0))


@pytest.mark.parametrize("dims,interp", [(2, "Smoothstep"), (2, "Linear"), (3, "Linear"), (3, "Smoothstep")])
def test_second_order_exact_vs_jax(dims, interp):
    """d/dparams and d/dx of sum((dy/dx . w)^2): every term of the double
    backward, including Linear's cross second derivatives."""
    cfg = dict(ENC, interpolation=interp)
    t, j = tm.Encoding(dims, cfg, seed=11, device="cpu"), jm.Encoding(dims, cfg, seed=11)
    x0 = np.random.default_rng(dims).uniform(0.05, 0.95, (7, dims)).astype(np.float32)
    w = np.random.default_rng(3).standard_normal((7, t.n_output_dims)).astype(np.float32)
    x = torch.from_numpy(x0.copy()).requires_grad_(True)
    (gx,) = autograd.grad((t(x) * torch.from_numpy(w)).sum(), x, create_graph=True)
    (gx * gx).sum().backward()
    gp_j, gx2_j = _jax_eikonal_like(j, t.n_output_dims, w, x0)
    np.testing.assert_allclose(t.params.grad.numpy(), np.asarray(gp_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx2_j), rtol=1e-5, atol=1e-6)


def test_second_order_params_only(enc):
    """grad wrt params of sum(dL/dx) with params in the graph (the term the
    reference also supports), exact against JAX."""
    j = jm.Encoding(2, ENC, seed=11)
    x = torch.from_numpy(X0.copy()).requires_grad_(True)
    (gx,) = autograd.grad(enc(x).sum(), x, create_graph=True)
    (gp,) = autograd.grad(gx.sum(), enc.params)

    def first(p, xx):
        return jnp.sum(j.apply(p, xx)[:, : enc.n_output_dims].astype(jnp.float32))

    gp_j = jax.grad(lambda p: jnp.sum(jax.grad(first, argnums=1)(p, jnp.asarray(X0))))(j.params)
    np.testing.assert_allclose(gp.numpy(), np.asarray(gp_j), rtol=1e-5, atol=1e-6)


def test_table_gradient_cotangent_terms_vs_jax(enc):
    """The cgp terms: d/dx and d/d(dL/dy) of <v, dL/dparams>."""
    j = jm.Encoding(2, ENC, seed=11)
    r = np.random.default_rng(5)
    v = r.standard_normal(enc.n_params).astype(np.float32)
    w = r.standard_normal((3, enc.n_output_dims)).astype(np.float32)
    x = torch.from_numpy(X0.copy()).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    (gp,) = autograd.grad((enc(x) * wt).sum(), enc.params, create_graph=True)
    gx, gw = autograd.grad((gp * torch.from_numpy(v)).sum(), (x, wt))

    def inner(xx, ww):
        g = jax.grad(lambda p: jnp.sum(j.apply(p, xx)[:, : enc.n_output_dims] * ww))(j.params)
        return jnp.sum(g * v)

    gx_j, gw_j = jax.grad(inner, argnums=(0, 1))(jnp.asarray(X0), jnp.asarray(w))
    np.testing.assert_allclose(gx.numpy(), np.asarray(gx_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gw.numpy(), np.asarray(gw_j), rtol=1e-5, atol=1e-6)


def test_third_order_raises(enc):
    """Once a raise, the third order is now the JAX package's value: d/dx
    and d/dparams of sum(d/dx sum((dy/dx)^2)), autograd of the plain double
    backward against three jax.grads (tests/test_torch_port_higher_order.py
    holds the other cases)."""
    j = jm.Encoding(2, ENC, seed=11)
    x = torch.from_numpy(X0.copy()).requires_grad_(True)
    (gx,) = autograd.grad(enc(x).sum(), x, create_graph=True)
    (gx2,) = autograd.grad((gx * gx).sum(), x, create_graph=True)
    gp3, gx3 = autograd.grad(gx2.sum(), (enc.params, x))

    def first(p, xx):
        return jnp.sum(j.apply(p, xx)[:, : enc.n_output_dims].astype(jnp.float32))

    def third(p, xx):
        return jnp.sum(jax.grad(lambda z: jnp.sum(jax.grad(first, argnums=1)(p, z) ** 2))(xx))

    gp_j, gx_j = jax.grad(third, argnums=(0, 1))(j.params, jnp.asarray(X0))
    assert np.abs(np.asarray(gx_j)).max() > 0
    np.testing.assert_allclose(gp3.numpy(), np.asarray(gp_j), rtol=1e-5, atol=1e-6 * np.abs(np.asarray(gp_j)).max())
    np.testing.assert_allclose(gx3.numpy(), np.asarray(gx_j), rtol=1e-5, atol=1e-6 * np.abs(np.asarray(gx_j)).max())


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_eikonal_through_network_with_fully_fused_mlp_vs_jax():
    """The SDF loss term mean((|grad_x f| - 1)^2) through the grid and
    FullyFusedMLP: d/dparams and d/dx against jax.grad of jax.grad."""
    cfg = dict(ENC, n_levels=4, log2_hashmap_size=9, interpolation="Linear")
    net = {"otype": "FullyFusedMLP", "n_neurons": 32, "n_hidden_layers": 2}
    t, j = tm.NetworkWithInputEncoding(3, 1, cfg, net, seed=7, device="cpu"), \
        jm.NetworkWithInputEncoding(3, 1, cfg, net, seed=7)
    r = np.random.default_rng(0)
    p0 = (r.standard_normal(t.n_params) * 0.5).astype(np.float32)
    with torch.no_grad():
        t.params.copy_(torch.from_numpy(p0))
    x_np = r.uniform(0, 1, (300, 3)).astype(np.float32)
    x = torch.from_numpy(x_np.copy()).requires_grad_(True)
    f = t(x)
    (g,) = autograd.grad(f, x, torch.ones_like(f), create_graph=True)
    ((g.norm(dim=1) - 1) ** 2).mean().backward()

    def eik(p, xx):
        gg = jax.grad(lambda z: jnp.sum(j.apply(p, z)[:, 0].astype(jnp.float32)))(xx)
        return jnp.mean((jnp.linalg.norm(gg, axis=1) - 1) ** 2)

    gp_j, gx_j = jax.grad(eik, argnums=(0, 1))(jnp.asarray(p0), jnp.asarray(x_np))
    assert _rel(t.params.grad.numpy(), np.asarray(gp_j)) <= 1e-3
    assert _rel(x.grad.numpy(), np.asarray(gx_j)) <= 1e-3


def test_plain_route_is_the_same_function():
    """apply_plain takes the plain versions through both orders; on the CPU
    the kernel route is the same code, so the two agree bitwise."""
    cfg = dict(ENC, n_levels=4, log2_hashmap_size=9, scatter_strategy="factored_sr", table_dtype="bfloat16")
    net = {"otype": "FullyFusedMLP", "n_neurons": 32, "n_hidden_layers": 2}
    t = tm.NetworkWithInputEncoding(3, 1, cfg, net, seed=7, device="cpu")
    x_np = np.random.default_rng(1).uniform(0, 1, (64, 3)).astype(np.float32)
    grads = []
    for f_of in (lambda xx: t(xx), lambda xx: t.apply_plain(t.params, xx)[:, :1].float()):
        t.params.grad = None
        x = torch.from_numpy(x_np.copy()).requires_grad_(True)
        f = f_of(x)
        (g,) = autograd.grad(f, x, torch.ones_like(f), create_graph=True)
        ((g.norm(dim=1) - 1) ** 2).mean().backward()
        grads.append((t.params.grad.clone(), x.grad.clone()))
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_plain_double_backward_matches_autograd_of_plain_backward():
    """``grid_backward_backward_plain`` against torch autograd of the plain
    input gradient (a differentiable torch expression in x, params and dy)
    for a fp32-class table gradient."""
    from tcnn_tpu_torch.encodings import create_encoding

    te = create_encoding(3, dict(ENC, interpolation="Linear"), alignment=1)
    r = np.random.default_rng(2)
    x = torch.from_numpy(r.uniform(0, 1, (20, 3)).astype(np.float32)).requires_grad_(True)
    params = torch.from_numpy(r.uniform(-1, 1, te.n_params).astype(np.float32)).requires_grad_(True)
    dy = torch.from_numpy(r.standard_normal((20, te.padded_output_width)).astype(np.float32)).requires_grad_(True)
    cgx = torch.from_numpy(r.standard_normal((20, 3)).astype(np.float32))
    levels = te._levels_on(x.device)
    classes = torch.zeros((te.n_levels, 2), dtype=torch.int32)
    dx = ge.grid_backward_input_plain(x, dy, params, levels, 2, ge.INTERP_LINEAR)
    want = autograd.grad((dx * cgx).sum(), (params, x, dy))
    got = ge.grid_backward_backward_plain(
        x.detach(), dy.detach(), params.detach(), levels, 2, ge.INTERP_LINEAR, classes, None, cgx
    )
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
