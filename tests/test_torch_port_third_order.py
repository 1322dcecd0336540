"""The grid's third order (G3) on the CPU: its plain version
(``ops.grid_encode.grid_third_order_plain``) against autograd of the plain
double backward, the routes of ``GridEncodeBackwardBackwardFunction``
against ``jax.grad`` of the JAX package, and the windowed G3 of a
row-sharded table against the whole table's.

Tolerances:
- the plain G3 against autograd of the plain G2 (the same fp32 products,
  sums in another order): per entry 1e-5 of |reference| plus 1e-6 of its
  max;
- against ``jax.grad`` in the fp32 class (fp32 on both sides, XLA's fusions
  sum in another order): the same;
- in a bf16 class, d/dparams level by level within 2^-7 of the JAX
  result's norm (both sides round each contribution to bf16, 2^-9 of it,
  and in a bf16 sum every add; the JAX package adds its corners' and
  terms' scatters in another grouping, so roundings differ by a bf16 ulp
  of a contribution or of a partial sum); a level whose class drops its
  table gradient exactly zero, and a class that sums in bf16 bf16-valued;
- in a stochastic-bf16 class, d/dparams level by level at least 2^-14 of
  its norm away from the same route with every class scatter of the third
  order unrounded (the rounding moves each contribution by up to 2^-8 of
  it, here 2^-9.3 of the norm or more; fp32 sums in another order move it
  by about 2^-22): the level's rounding reaches the third order;
- the windowed G3's partials summed over the shards against the whole
  table's: per entry 1e-5 of |reference| plus 1e-6 of its max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import autograd

from tcnn_tpu_torch.encodings.grid import _INTERP_CODES
from tcnn_tpu_torch.ops import grid_encode as ge
from tcnn_tpu_torch.ops.scatter_rows import ACC_BF16, ACC_DROP, ACC_F32, CONTRIB_NONE, CONTRIB_RN, CONTRIB_SR
from tcnn_tpu_torch.parallel import TableParallelGrid

from test_torch_port_grid_extras import GRID, _fixed_points, _jax_uniforms, _pair, _params, _torch_x


def _assert_close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = 1e-5 * np.abs(want) + 1e-6 * np.abs(want).max()
    bad = np.abs(got - want) > tol
    assert not bad.any(), f"{what}: {bad.sum()} entries off (max |diff| {np.abs(got - want).max():.3e})"


# The plain G3 against autograd of the plain G2: (name, cgp, cgx, g_params,
# g_x, g_dy) present or not; "curvature" is the curvature loss's (cgx, g_x,
# g_dy), "all" every operand.
SUBSETS = [
    ("all", 1, 1, 1, 1, 1),
    ("curvature", 0, 1, 0, 1, 1),
    ("g_x", 0, 1, 0, 1, 0),
    ("g_dy", 1, 1, 0, 0, 1),
    ("g_params", 0, 1, 1, 0, 0),
    ("cgp_only", 1, 0, 0, 1, 1),
]


def _operands(enc, n, seed, subset, window_rows=None):
    """Random G3 operands for ``enc`` at n points: x (points outside [0,
    1] too), dL_dy, the table, the cotangents that ``subset`` names."""
    r = np.random.default_rng(seed)
    d, W = enc.n_dims_to_encode, enc.padded_output_width
    n_params = enc.n_params if window_rows is None else window_rows

    def t(shape, on=True):
        return torch.from_numpy(r.standard_normal(shape).astype(np.float32)) if on else None

    _, cgp, cgx, gp, gx, gy = subset
    x = torch.from_numpy(r.uniform(-0.1, 1.1, (n, d)).astype(np.float32))
    return {"x": x, "dy": t((n, W)), "params": torch.from_numpy(r.uniform(-1, 1, n_params).astype(np.float32)),
            "cgp": t(n_params, cgp), "cgx": t((n, d), cgx), "g_params": t(n_params, gp), "g_x": t((n, d), gx),
            "g_dy": t((n, W), gy)}


def _autograd_of_g2(o, levels, F, interp, classes, window=None):
    """Today's route: autograd of the plain G2 for the operands ``o``, in
    G3's order (d/dparams, d/dx, d/d(dL_dy), d/dcgp, d/dcgx)."""
    def fn(xx, pp, yy, cp, cx):
        return ge.grid_backward_backward_plain(xx, yy, pp, levels, F, interp, classes, cp, cx, window)

    with torch.no_grad():
        d_x, d_p, d_dy, d_cgp, d_cgx = ge._autograd_of(
            fn, (o["x"], o["params"], o["dy"], o["cgp"], o["cgx"]), (True,) * 5, (o["g_params"], o["g_x"], o["g_dy"]))
    return d_p, d_x, d_dy, d_cgp, d_cgx


def _compare(got, want, names=("d/dparams", "d/dx", "d/d(dL_dy)", "d/dcgp", "d/dcgx")):
    for g, w, what in zip(got, want, names):
        if w is None or not w.any():
            assert g is None or not g.any(), what
            continue
        assert g is not None, what
        _assert_close(g.numpy(), w.numpy(), what)


@pytest.mark.parametrize("subset", SUBSETS, ids=[s[0] for s in SUBSETS])
@pytest.mark.parametrize("interp", ["Linear", "Smoothstep", "Nearest"])
@pytest.mark.parametrize("dims", [2, 3])
def test_plain_third_order_is_autograd_of_the_plain_double_backward(dims, interp, subset):
    """Every output of ``grid_third_order_plain`` against autograd of
    ``grid_backward_backward_plain`` (the fp32 class: no rounding, so the
    two agree on every term), with and without each operand."""
    _, te = _pair(dims, dict(GRID, interpolation=interp, log2_hashmap_size=9))
    F, interp_code = te.n_features_per_level, _INTERP_CODES[te.interpolation_type]
    levels = te._levels_on(torch.device("cpu"))
    classes = torch.tensor([[CONTRIB_NONE, ACC_F32]] * te.n_levels, dtype=torch.int32)
    o = _operands(te, 37, 10 * dims + len(interp), subset)
    got = ge.grid_third_order_plain(o["x"], o["dy"], o["params"], levels, F, interp_code, classes, o["cgp"], o["cgx"],
                                    o["g_params"], o["g_x"], o["g_dy"])
    want = _autograd_of_g2(o, levels, F, interp_code, classes)
    if interp != "Nearest":
        assert any(w is not None and w.abs().max() > 0 for w in want)
    _compare(got, want)


@pytest.mark.parametrize("n_shards", [2, 3])
@pytest.mark.parametrize("subset", SUBSETS[:4], ids=[s[0] for s in SUBSETS[:4]])
def test_plain_windowed_third_order_is_autograd_of_the_plain_windowed_double_backward(subset, n_shards):
    """``grid_third_order_plain`` with ``window`` against autograd of the
    plain windowed G2, every shard of a 3D Smoothstep table."""
    _, te = _pair(3, dict(GRID, interpolation="Smoothstep", log2_hashmap_size=9))
    F, interp = te.n_features_per_level, _INTERP_CODES[te.interpolation_type]
    for shard in range(n_shards):
        tpg = TableParallelGrid(te, None, shard=(shard, n_shards))
        levels, windows = tpg._tables_on(torch.device("cpu"))
        classes = ge._f32_classes(te.n_levels, torch.device("cpu"))
        o = _operands(te, 29, shard, subset, tpg.local_n_params)
        o["dy"], o["g_dy"] = (None if t is None else t[:, : te.n_levels * F].contiguous() for t in (o["dy"], o["g_dy"]))
        got = ge.grid_backward3_windowed(o["x"], o["dy"], o["params"], levels, windows, F, interp, o["cgp"], o["cgx"],
                                         o["g_params"], o["g_x"], o["g_dy"])
        _compare(got, _autograd_of_g2(o, levels, F, interp, classes, windows))


@pytest.mark.parametrize("n_shards", [2, 3])
def test_windowed_third_order_summed_over_shards_is_the_whole_table(n_shards):
    """Each shard's windowed G3 (plain): d/dparams and d/dcgp of its rows
    put back in the whole table's layout, d/dx, d/d(dL_dy) and d/dcgx
    summed over the shards, against the whole table's G3 (one shard, fp32
    classes)."""
    _, te = _pair(2, dict(GRID, interpolation="Linear", log2_hashmap_size=10))
    F, L, interp = te.n_features_per_level, te.n_levels, _INTERP_CODES[te.interpolation_type]
    whole = TableParallelGrid(te, None, shard=(0, 1))
    o = _operands(te, 41, 5, SUBSETS[0])
    o["dy"], o["g_dy"] = o["dy"][:, : L * F].contiguous(), o["g_dy"][:, : L * F].contiguous()
    flat = {k: whole.unshard_params(o[k].numpy()) for k in ("params", "cgp", "g_params")}
    levels, windows = whole._tables_on(torch.device("cpu"))
    classes = ge._f32_classes(L, torch.device("cpu"))
    want = ge.grid_third_order_plain(o["x"], o["dy"], *(torch.from_numpy(whole.local_params(flat["params"])),),
                                     levels, F, interp, classes,
                                     torch.from_numpy(whole.local_params(flat["cgp"])), o["cgx"],
                                     torch.from_numpy(whole.local_params(flat["g_params"])), o["g_x"], o["g_dy"])
    tables, sums = {"d/dparams": [], "d/dcgp": []}, [0, 0, 0]
    grids = [TableParallelGrid(te, None, shard=(s, n_shards)) for s in range(n_shards)]
    for g in grids:
        lv, win = g._tables_on(torch.device("cpu"))
        got = ge.grid_backward3_windowed(o["x"], o["dy"], torch.from_numpy(g.local_params(flat["params"])), lv, win,
                                         F, interp, torch.from_numpy(g.local_params(flat["cgp"])), o["cgx"],
                                         torch.from_numpy(g.local_params(flat["g_params"])), o["g_x"], o["g_dy"])
        tables["d/dparams"].append(got[0].numpy())
        tables["d/dcgp"].append(got[3].numpy())
        sums = [s + t.numpy() for s, t in zip(sums, (got[1], got[2], got[4]))]
    for what, i in (("d/dparams", 0), ("d/dcgp", 3)):
        _assert_close(grids[0].unshard_params(np.concatenate(tables[what])), whole.unshard_params(want[i].numpy()),
                      what)
    for what, got, i in zip(("d/dx", "d/d(dL_dy)", "d/dcgx"), sums, (1, 2, 4)):
        _assert_close(got, want[i].numpy(), what)


# The gradient classes of the JAX comparison, each forced on every level at
# toy size: (name, config, the class the port gives every level).
CLASS_CASES = [
    ("fp32", {}, (CONTRIB_NONE, ACC_F32)),
    ("single-bf16", {"scatter_strategy": "xla_half"}, (CONTRIB_RN, ACC_BF16)),
    ("stochastic-bf16", {"scatter_strategy": "factored_sr"}, (CONTRIB_SR, ACC_F32)),
    ("stochastic-bf16-sums", {"scatter_strategy": "xla_half_sr"}, (CONTRIB_SR, ACC_BF16)),
    ("drop", {"scatter_strategy": "drop"}, (CONTRIB_NONE, ACC_DROP)),
    ("bf16-table", {"table_dtype": "bfloat16"}, (CONTRIB_NONE, ACC_F32)),
]


def _third_loss_torch(te, pt, xt, wt, v):
    """A loss whose gradient in (params, x, w) is the grid's third order
    with every cotangent of G2 present: |H v|^2 (g_x), |d/dw <dx, v>|^2
    (g_dy) and |d/dparams <dx, v>|^2 (g_params), dx = d<lookup, w>/dx."""
    (gx,) = autograd.grad((te.apply(pt, xt) * wt).sum(), xt, create_graph=True)
    hv, gw, gp = autograd.grad((gx * v).sum(), (xt, wt, pt), create_graph=True)
    return (hv * hv).sum() + (gw * gw).sum() + (gp * gp).sum()


def _third_loss_jax(je, p, x, w, v):
    def first(pp, xx, ww):
        return jnp.sum(je.apply(pp, xx) * ww)

    def second(pp, xx, ww):
        return jnp.sum(jax.grad(first, argnums=1)(pp, xx, ww) * v)

    hv, gw, gp = jax.grad(second, argnums=(1, 2, 0))(p, x, w)
    return jnp.sum(hv * hv) + jnp.sum(gw * gw) + jnp.sum(gp * gp)


@pytest.mark.parametrize("name,extra,cls,dims", [pytest.param(*c, 2, id=f"{c[0]}-2d") for c in CLASS_CASES] + [
    pytest.param(*c, 3, id=f"{c[0]}-3d") for c in CLASS_CASES if c[0] in ("fp32", "stochastic-bf16")])
def test_third_order_route_vs_jax(name, extra, cls, dims, monkeypatch):
    """d/dparams, d/dx and d/d(dL_dy) of a loss with every G2 cotangent
    (``_third_loss_torch``) through ``GridEncodeBackwardBackwardFunction``
    (G3's plain route) against ``jax.grad`` of the JAX package, in each
    gradient class: a class is applied to the third order's d/dparams as to
    the table gradient (the JAX package's linear pair), a dropped level's
    d/dparams is zero and a bf16 sum bf16-valued; under stochastic rounding
    d/dparams moves when the third order's class scatters are made
    unrounded (``_ClassScatter`` given CONTRIB_NONE)."""
    cfg = dict(GRID, interpolation="Smoothstep", **extra)
    je, te = _pair(dims, cfg)
    n = 16
    params = _params(te.n_params, dims)
    r = np.random.default_rng(dims)
    x = r.uniform(0, 1, (n, dims)).astype(np.float32)
    w = r.standard_normal((n, te.padded_output_width)).astype(np.float32)
    v = r.standard_normal((n, dims)).astype(np.float32)
    classes = te.gradient_classes(n)
    assert (classes == np.asarray(cls)).all()
    want = jax.jit(jax.grad(lambda p, xx, ww: _third_loss_jax(je, p, xx, ww, v), argnums=(0, 1, 2)))(
        jnp.asarray(params), jnp.asarray(x), jnp.asarray(w))
    want = [np.asarray(a) for a in want]

    def route():
        pt, wt, xt = (torch.from_numpy(a).requires_grad_() for a in (params, w, x))
        loss = _third_loss_torch(te, pt, xt, wt, torch.from_numpy(v))
        return [g.numpy() for g in autograd.grad(loss, (pt, xt, wt))]

    got = route()
    _assert_close(got[1], want[1], f"{name} d/dx")
    _assert_close(got[2], want[2], f"{name} d/dw")
    _check_table_shaped(te, classes, got[0], want[0], f"{name} d/dparams")
    if cls[0] == CONTRIB_SR:
        real = ge._ClassScatter.apply
        with monkeypatch.context() as m:
            m.setattr(ge._ClassScatter, "apply",
                      lambda rows, contrib, size, _, *rest: real(rows, contrib, size, CONTRIB_NONE, *rest))
            unrounded = route()[0]
        F = te.n_features_per_level
        for lvl in range(te.n_levels):
            lo, hi = int(te.offset_table[lvl]) * F, int(te.offset_table[lvl + 1]) * F
            e, scale = float(np.linalg.norm(got[0][lo:hi] - unrounded[lo:hi])), float(np.linalg.norm(unrounded[lo:hi]))
            assert e >= 2.0 ** -14 * scale > 0, f"{name} d/dparams level {lvl}: {e:.3e} from unrounded {scale:.3e}"


def _check_table_shaped(te, classes, got, want, what):
    """A table-shaped third derivative level by level in its class: fp32
    as ``_assert_close``; a dropped level zero on both sides; a bf16 class
    within 2^-7 of the norm, bf16-valued where it sums in bf16."""
    F = te.n_features_per_level
    assert np.abs(want).max() > 0 or (classes[:, 1] == ACC_DROP).all()
    for lvl in range(te.n_levels):
        lo, hi = int(te.offset_table[lvl]) * F, int(te.offset_table[lvl + 1]) * F
        g, j = got[lo:hi], want[lo:hi]
        contrib, acc = classes[lvl]
        if acc == ACC_DROP:
            assert not g.any() and not j.any(), f"{what} level {lvl}: a dropped level"
        elif contrib == CONTRIB_NONE and acc == ACC_F32:
            _assert_close(g, j, f"{what} level {lvl}")
        else:
            if acc == ACC_BF16:
                assert np.array_equal(torch.from_numpy(g).bfloat16().float().numpy(), g), f"{what} level {lvl}"
            e = float(np.linalg.norm(g - j))
            assert e <= 2.0 ** -7 * float(np.linalg.norm(j)), f"{what} level {lvl}: |diff| {e:.3e}"


@pytest.mark.parametrize("cls", ["fp32", "single-bf16", "drop"])
@pytest.mark.parametrize("mode", ["fixed_point_pos", "stochastic"])
def test_cotangent_term_third_order_vs_jax(mode, cls):
    """The third order through G2's cgp term of uint32 positions and of a
    sampled corner (the lookup of cgp, the gather of its sampled corners):
    d/du of |d/dw <d<lookup, w>/dparams, u>|^2, the transpose of that term
    applied to its cotangent (the table gradient of it in the level's
    class, sampled with ``u``), against ``jax.grad``."""
    extra = {"fixed_point_pos": True} if mode == "fixed_point_pos" else {"stochastic_interpolation": True}
    extra.update({"fp32": {}, "single-bf16": {"scatter_strategy": "xla_half"}, "drop": {"scatter_strategy": "drop"}}[cls])
    je, te = _pair(2, dict(GRID, **extra))
    n, fixed = 16, mode == "fixed_point_pos"
    params = _params(te.n_params, 1)
    x = _fixed_points(n, 2, 2) if fixed else np.random.default_rng(2).uniform(0, 1, (n, 2)).astype(np.float32)
    r = np.random.default_rng(3)
    w = r.standard_normal((n, te.padded_output_width)).astype(np.float32)
    u = r.standard_normal(te.n_params).astype(np.float32)
    key = jax.random.PRNGKey(5)
    kw_j, kw_t = ({}, {}) if fixed else ({"rng": key},
                                         {"rng": torch.from_numpy(_jax_uniforms(key, n, te.n_levels))})

    def y_j(uu, ww):
        inner = jax.grad(lambda p, w2: jnp.sum(je.apply(p, jnp.asarray(x), **kw_j) * w2))
        return jax.grad(lambda w2: jnp.sum(inner(jnp.asarray(params), w2) * uu))(ww)

    want = np.asarray(jax.jit(jax.grad(lambda uu: jnp.sum(y_j(uu, jnp.asarray(w)) ** 2)))(jnp.asarray(u)))
    pt, wt, ut = (torch.from_numpy(a).requires_grad_() for a in (params, w, u))
    (gp,) = autograd.grad((te.apply(pt, _torch_x(x), **kw_t) * wt).sum(), pt, create_graph=True)
    (y,) = autograd.grad((gp * ut).sum(), wt, create_graph=True)
    (got,) = autograd.grad((y * y).sum(), ut, materialize_grads=True)
    classes = te.gradient_classes(n)
    if cls == "drop":
        assert not want.any() and not got.any()
    else:
        _check_table_shaped(te, classes, got.numpy(), want, f"{mode} {cls} d/dcgp")


def test_table_parallel_third_order_through_apply_is_the_whole_tables():
    """A curvature loss's gradients through ``TableParallelGrid.apply`` on
    one shard (the windowed G1, G2 and G3 routes, ``_WindowedThirdOrder``
    under grad mode) against the same loss through the unsharded lookup in
    the sharded lookup's classes (per_level gathers, fp32 sums), and a
    fourth order through both (autograd of the plain G3s)."""
    cfg = dict(GRID, interpolation="Smoothstep", gather_strategy="per_level", scatter_strategy="xla")
    _, te = _pair(2, cfg)
    tpg = TableParallelGrid(te, None, shard=(0, 1))
    r = np.random.default_rng(4)
    params = _params(te.n_params, 4)
    x0 = r.uniform(0, 1, (19, 2)).astype(np.float32)
    w = torch.from_numpy(r.standard_normal((19, te.n_levels * te.n_features_per_level)).astype(np.float32))
    v = torch.from_numpy(r.standard_normal((19, 2)).astype(np.float32))

    def orders(apply, p):
        x = torch.from_numpy(x0.copy()).requires_grad_(True)
        (g,) = autograd.grad((apply(p, x)[:, : w.shape[1]] * w).sum(), x, create_graph=True)
        (hv,) = autograd.grad((g * v).sum(), x, create_graph=True)
        gp, gx = autograd.grad((hv * hv).sum(), (p, x), create_graph=True)
        (fourth,) = autograd.grad((gx * v).sum(), x)
        return gp, gx, fourth

    pt = torch.from_numpy(params).requires_grad_()
    local = torch.from_numpy(tpg.local_params(params)).requires_grad_()
    want = orders(lambda p, x: te.apply(p, x, stratified=False), pt)
    got = orders(tpg.apply, local)
    _assert_close(tpg.unshard_params(got[0].detach().numpy()), want[0].detach().numpy(), "d/dparams")
    _assert_close(got[1].detach().numpy(), want[1].detach().numpy(), "d/dx")
    _assert_close(got[2].numpy(), want[2].numpy(), "fourth order d/dx")
