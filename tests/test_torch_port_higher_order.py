"""Every derivative the JAX package's autodiff gives, through the port, on
the CPU: the grid beyond second order, the second derivative through the
table gradient of ``fixed_point_pos`` and of stochastic interpolation, SH
beyond second order, and a curvature loss through the module API.

The port takes the grid's first three orders from the kernels (their
plain versions here; the third is ``ops.grid_encode.grid_third_order_plain``,
G3's) and every further order from autograd of the plain G3
(``GridEncodeThirdOrderFunction``); SH's every order past the first from
autograd of its plain vjp; the JAX package takes them all from ``jax.grad``
(the grid's and the module's under ``jax.jit``, whose fusions sum in
another order). ``test_torch_port_third_order.py`` holds G3 itself.

Tolerances:
- the grid's third order and the cgp terms (fp32 on both sides, sums in
  another order): per entry 1e-5 of |JAX| plus 1e-6 of max |JAX|;
- SH degrees 1-8, third order: 1e-4 of the JAX result's norm (its values
  reach 1e8 at degree 8);
- the module-API curvature loss (FullyFusedMLP rounds activations and
  cotangents to bf16 at every layer on both sides, and bf16 roundings flip
  in another sum order): 1e-3 of the norm, as
  test_torch_port_second_order.py's network test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import autograd

import tcnn_tpu.modules as jm
import tcnn_tpu_torch.modules as tm
from tcnn_tpu.encodings.spherical_harmonics import SphericalHarmonicsEncoding as JaxSH
from tcnn_tpu_torch.encodings.grid import _INTERP_CODES
from tcnn_tpu_torch.encodings.spherical_harmonics import SphericalHarmonicsEncoding as TorchSH
from tcnn_tpu_torch.ops import grid_encode as ge
from tcnn_tpu_torch.ops.scatter_rows import ACC_DROP, ACC_F32, CONTRIB_NONE

from test_torch_port_grid_extras import GRID, _fixed_points, _jax_uniforms, _pair, _params, _torch_x
from test_torch_port_second_order import ENC


def _assert_close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = 1e-5 * np.abs(want) + 1e-6 * np.abs(want).max()
    bad = np.abs(got - want) > tol
    assert not bad.any(), f"{what}: {bad.sum()} entries off (max |diff| {np.abs(got - want).max():.3e})"


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / max(np.linalg.norm(np.asarray(b)), 1e-30))


@pytest.mark.parametrize("dims,interp", [(2, "Linear"), (2, "Smoothstep"), (3, "Linear"), (3, "Smoothstep")])
def test_grid_third_order_vs_jax(dims, interp):
    """d/dparams and d/dx of sum((H v)^2), H v the Hessian-vector product
    of <lookup, w> in x: the third order in x and, through the table, in
    the parameters (a curvature loss of an SDF)."""
    cfg = dict(ENC, interpolation=interp)
    t, j = tm.Encoding(dims, cfg, seed=11, device="cpu"), jm.Encoding(dims, cfg, seed=11)
    r = np.random.default_rng(dims)
    x0 = r.uniform(0.05, 0.95, (7, dims)).astype(np.float32)
    w = r.standard_normal((7, t.n_output_dims)).astype(np.float32)
    v = r.standard_normal((7, dims)).astype(np.float32)
    x = torch.from_numpy(x0.copy()).requires_grad_(True)
    (gx,) = autograd.grad((t(x) * torch.from_numpy(w)).sum(), x, create_graph=True)
    (hv,) = autograd.grad((gx * torch.from_numpy(v)).sum(), x, create_graph=True)
    gp, gx3 = autograd.grad((hv * hv).sum(), (t.params, x))

    def first(p, xx):
        return jnp.sum(j.apply(p, xx)[:, : t.n_output_dims].astype(jnp.float32) * w)

    def third(p, xx):
        h = jax.grad(lambda z: jnp.sum(jax.grad(first, argnums=1)(p, z) * v))(xx)
        return jnp.sum(h * h)

    gp_j, gx_j = jax.jit(jax.grad(third, argnums=(0, 1)))(j.params, jnp.asarray(x0))
    assert np.abs(np.asarray(gp_j)).max() > 0
    _assert_close(gp.numpy(), gp_j, "d/dparams")
    _assert_close(gx3.numpy(), gx_j, "d/dx")


def test_grid_fourth_order_is_autograd_of_the_third():
    """A fourth order: autograd of the plain G3, so the grid differentiates
    to any order. Held
    against finite differences of the third order's d/dx in x (Smoothstep:
    its third derivative is smooth inside a cell)."""
    t = tm.Encoding(2, ENC, seed=11, device="cpu")
    x0 = np.array([[0.31, 0.62], [0.44, 0.18]], np.float64)
    v = torch.tensor([[0.6, -0.8], [1.0, 0.5]])

    def third(xx):
        (g,) = autograd.grad(t(xx).sum(), xx, create_graph=True)
        (h,) = autograd.grad((g * v).sum(), xx, create_graph=True)
        (k,) = autograd.grad((h * h).sum(), xx, create_graph=True)
        return k

    x = torch.from_numpy(x0.astype(np.float32)).requires_grad_(True)
    (fourth,) = autograd.grad(third(x)[:, 0].sum(), x)
    eps = 1e-3
    for e in range(2):
        hi, lo = x0.copy(), x0.copy()
        hi[:, e] += eps
        lo[:, e] -= eps
        k_hi = third(torch.from_numpy(hi.astype(np.float32)).requires_grad_(True))[:, 0]
        k_lo = third(torch.from_numpy(lo.astype(np.float32)).requires_grad_(True))[:, 0]
        fd = ((k_hi - k_lo) / (2 * eps)).detach().numpy()
        np.testing.assert_allclose(fourth[:, e].numpy(), fd, rtol=2e-2, atol=2e-2 * np.abs(fd).max())


# (name, grid extras, dims): uint32 positions, stochastic interpolation in
# Linear and Smoothstep, and both flags together.
CGP_CASES = [
    ("fixed_point_pos", dict(fixed_point_pos=True), 2),
    ("stochastic", dict(stochastic_interpolation=True), 2),
    ("stochastic-Smoothstep-3d", dict(stochastic_interpolation=True, interpolation="Smoothstep"), 3),
    ("both", dict(fixed_point_pos=True, stochastic_interpolation=True), 3),
    ("stochastic-bf16-table", dict(stochastic_interpolation=True, table_dtype="bfloat16"), 2),
]


@pytest.mark.parametrize("name,extra,dims", CGP_CASES, ids=[c[0] for c in CGP_CASES])
def test_table_gradient_cotangent_vs_jax(name, extra, dims):
    """jax.grad of sum(jax.grad(f, params)^2) with f = sum(lookup^2 * w),
    so that dL/dy depends on the parameters and the positions; with fp32
    positions the mixed form adds sum(jax.grad(f, x)^2). Held in the
    parameters, w, and (fp32 positions) x."""
    je, te = _pair(dims, dict(GRID, **extra))
    batch = 32
    fixed = bool(extra.get("fixed_point_pos"))
    stochastic = bool(extra.get("stochastic_interpolation"))
    params = _params(te.n_params, 1)
    x = _fixed_points(batch, dims, 2) if fixed else np.random.default_rng(2).uniform(0, 1, (batch, dims)).astype(
        np.float32)
    w = np.random.default_rng(3).standard_normal((batch, te.padded_output_width)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    kw_t = {"rng": torch.from_numpy(_jax_uniforms(key, batch, te.n_levels))} if stochastic else {}

    def f_j(p, xx, ww, k):
        return jnp.sum(je.apply(p, xx, **({"rng": k} if stochastic else {})) ** 2 * ww)

    def loss_j(p, xx, ww, k):
        gp = jax.grad(f_j)(p, xx, ww, k)
        out = jnp.sum(gp * gp)
        if not fixed:
            out = out + jnp.sum(jax.grad(f_j, argnums=1)(p, xx, ww, k) ** 2)
        return out

    argnums = (0, 2) if fixed else (0, 2, 1)
    want = jax.jit(jax.grad(loss_j, argnums=argnums))(jnp.asarray(params), jnp.asarray(x), jnp.asarray(w), key)
    pt = torch.from_numpy(params).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    xt = _torch_x(x) if fixed else torch.from_numpy(x).requires_grad_()
    f = (te.apply(pt, xt, **kw_t) ** 2 * wt).sum()
    if fixed:
        (gp,) = autograd.grad(f, pt, create_graph=True)
        got = autograd.grad((gp * gp).sum(), (pt, wt))
    else:
        gp, gx = autograd.grad(f, (pt, xt), create_graph=True)
        got = autograd.grad((gp * gp).sum() + (gx * gx).sum(), (pt, wt, xt))
    for g, want_g, what in zip(got, want, ("d/dparams", "d/dw", "d/dx")):
        assert np.abs(np.asarray(want_g)).max() > 0
        _assert_close(g.numpy(), want_g, f"{name} {what}")


def _cgp_inputs(dims, extra, seed):
    te = _pair(dims, dict(GRID, **extra))[1]
    r = np.random.default_rng(seed)
    fixed = bool(extra.get("fixed_point_pos"))
    x = _torch_x(_fixed_points(64, dims, seed) if fixed else r.uniform(0, 1, (64, dims)).astype(np.float32))
    dy = torch.from_numpy(r.standard_normal((64, te.padded_output_width)).astype(np.float32))
    cgp = torch.from_numpy(r.standard_normal(te.n_params).astype(np.float32))
    u = torch.from_numpy(r.uniform(0, 1, (64, te.n_levels)).astype(np.float32))
    return te, x, dy, cgp, u


@pytest.mark.parametrize("fixed", [False, True], ids=["fp32", "fixed_point_pos"])
def test_sampled_gather_is_the_transpose_of_the_sampled_table_gradient(fixed):
    """<cgp, table gradient of dy with u> = <grid_encode_sampled(cgp), dy>
    (the plain versions of tcnn_grid_backward's sampled corner and of
    tcnn_grid_forward_sampled, which share the corner's choice), and a
    level dropped by its class takes no cotangent."""
    te, x, dy, cgp, u = _cgp_inputs(2, {"fixed_point_pos": fixed}, 7)
    levels = te._levels_on(torch.device("cpu"))
    F, interp, width = te.n_features_per_level, _INTERP_CODES[te.interpolation_type], te.padded_output_width
    classes = torch.tensor([[CONTRIB_NONE, ACC_F32]] * te.n_levels, dtype=torch.int32)
    grad = ge.grid_backward_plain(x, dy, levels, F, interp, classes, u)
    gathered = ge.grid_encode_sampled(x, cgp, levels, u, F, width, interp)
    assert gathered.shape == (64, width) and not gathered[:, te.n_levels * F:].any()
    np.testing.assert_allclose(float((cgp * grad).sum()), float((gathered * dy).sum()), rtol=1e-5)
    classes[1, 1] = ACC_DROP
    d_dy = ge._cgp_term(x, cgp, levels, classes, u, F, width, interp, True)
    assert not d_dy[:, F:2 * F].any()
    torch.testing.assert_close(torch.cat([d_dy[:, :F], d_dy[:, 2 * F:]], 1),
                               torch.cat([gathered[:, :F], gathered[:, 2 * F:]], 1), rtol=0, atol=0)
    with pytest.raises(ValueError, match="Nearest"):
        ge.grid_encode_sampled(x, cgp, levels, u, F, width, ge.INTERP_NEAREST)


@pytest.mark.parametrize("extra", [{}, {"fixed_point_pos": True}], ids=["fp32", "fixed_point_pos"])
def test_table_gradient_cotangent_reads_as_the_table_vs_jax(extra):
    """With table_dtype bfloat16 the lookup rounds its reads, and the JAX
    package's autodiff reads a cotangent of the table gradient through the
    same gather (the transpose of the transpose of its linear pair), so
    rounded too: d/d(dL/dy) (and d/dx at fp32 positions) of <v, dparams>
    against jax.grad (G2's cgp term, and the lookup of cgp at uint32
    positions)."""
    je, te = _pair(2, dict(GRID, table_dtype="bfloat16", **extra))
    fixed = bool(extra)
    params = _params(te.n_params, 9)
    x = _fixed_points(16, 2, 9) if fixed else np.random.default_rng(9).uniform(0, 1, (16, 2)).astype(np.float32)
    r = np.random.default_rng(10)
    v = r.standard_normal(te.n_params).astype(np.float32)
    w = r.standard_normal((16, te.padded_output_width)).astype(np.float32)
    assert (te._levels_on(torch.device("cpu"))[:, ge._OWN_COL] != ge.ROUND_NONE).any()
    pt = torch.from_numpy(params).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    xt = _torch_x(x) if fixed else torch.from_numpy(x).requires_grad_()
    (gp,) = autograd.grad((te.apply(pt, xt) * wt).sum(), pt, create_graph=True)
    got = autograd.grad((gp * torch.from_numpy(v)).sum(), (wt,) if fixed else (wt, xt))

    def inner(ww, xx):
        return jnp.sum(jax.grad(lambda p: jnp.sum(je.apply(p, xx) * ww))(jnp.asarray(params)) * v)

    want = jax.grad(inner, argnums=(0,) if fixed else (0, 1))(jnp.asarray(w), jnp.asarray(x))
    for g, want_g, what in zip(got, want, ("d/dw", "d/dx")):
        _assert_close(g.numpy(), want_g, what)


@pytest.mark.parametrize("degree", range(1, 9))
def test_sh_third_order_vs_jax(degree):
    """d/dx of sum((H v)^2) for <SH(x), w>: three jax.grads of
    SphericalHarmonicsEncoding.apply against the port's autograd, whose
    every order past the first is autograd of the plain vjp."""
    je, te = JaxSH(degree, 3), TorchSH(degree, 3)
    je.output_dtype, te.output_dtype = jnp.float32, torch.float32
    r = np.random.default_rng(degree)
    x = r.uniform(0, 1, (16, 3)).astype(np.float32)
    w = r.standard_normal((16, degree * degree)).astype(np.float32)
    v = r.standard_normal((16, 3)).astype(np.float32)

    def f_j(xx):
        return jnp.sum(je.apply(None, xx)[:, : degree * degree] * w)

    def loss_j(xx):
        h = jax.grad(lambda z: jnp.sum(jax.grad(f_j)(z) * v))(xx)
        return jnp.sum(h * h)

    want = np.asarray(jax.grad(loss_j)(jnp.asarray(x)))
    kw = {"allow_unused": True, "materialize_grads": True}  # degrees 1-2 are affine in x: zeros
    xt = torch.from_numpy(x).requires_grad_()
    y = te.apply(None, xt)[:, : degree * degree]
    (g,) = autograd.grad((y * torch.from_numpy(w)).sum(), xt, create_graph=True, **kw)
    (h,) = autograd.grad((g * torch.from_numpy(v)).sum(), xt, create_graph=True, **kw)
    (got,) = autograd.grad((h * h).sum(), xt, **kw)
    if degree <= 3:  # the SH of degree <= 3 are quadratic at most: no third derivative
        assert not want.any() and not got.any()
    else:
        assert _rel(got.numpy(), want) <= 1e-4


def test_curvature_loss_through_the_module_api_vs_jax():
    """A curvature regulariser of an SDF through NetworkWithInputEncoding
    (3D HashGrid + FullyFusedMLP): d/dparams and d/dx of sum((H v)^2), H v
    from two autograd.grad(create_graph=True) calls, against jax.grad of
    jax.jvp of jax.grad of the JAX module."""
    cfg = dict(ENC, n_levels=4, log2_hashmap_size=9)
    net = {"otype": "FullyFusedMLP", "n_neurons": 32, "n_hidden_layers": 2}
    t, j = tm.NetworkWithInputEncoding(3, 1, cfg, net, seed=7, device="cpu"), \
        jm.NetworkWithInputEncoding(3, 1, cfg, net, seed=7)
    r = np.random.default_rng(0)
    p0 = (r.standard_normal(t.n_params) * 0.5).astype(np.float32)
    with torch.no_grad():
        t.params.copy_(torch.from_numpy(p0))
    x_np = r.uniform(0, 1, (64, 3)).astype(np.float32)
    v_np = r.standard_normal((64, 3)).astype(np.float32)
    x = torch.from_numpy(x_np.copy()).requires_grad_(True)
    f = t(x)
    (g,) = autograd.grad(f, x, torch.ones_like(f), create_graph=True)
    (hv,) = autograd.grad((g * torch.from_numpy(v_np)).sum(), x, create_graph=True)
    (hv * hv).sum().backward()

    def f_j(p, z):
        return jnp.sum(j.apply(p, z)[:, 0].astype(jnp.float32))

    def loss_j(p, xx):
        hvp = jax.jvp(lambda z: jax.grad(f_j, argnums=1)(p, z), (xx,), (jnp.asarray(v_np),))[1]
        return jnp.sum(hvp * hvp)

    gp_j, gx_j = jax.jit(jax.grad(loss_j, argnums=(0, 1)))(jnp.asarray(p0), jnp.asarray(x_np))
    assert np.abs(np.asarray(gp_j)).max() > 0
    assert _rel(t.params.grad.numpy(), gp_j) <= 1e-3
    assert _rel(x.grad.numpy(), gx_j) <= 1e-3
