"""The grid extras of the PyTorch port against the JAX package: the
``"Rng"`` hash, ``fixed_point_pos`` and stochastic interpolation's table
gradient.

The same numpy inputs go through ``tcnn_tpu``'s ``GridEncoding.apply`` and
the port's, which on the CPU runs every kernel's plain torch version.

Tolerances:
- the Rng hash, the jump table and the fixed-point cell: bit for bit (the
  same integer arithmetic);
- features: rtol 1e-6 plus atol 1e-7 (test_torch_port_grid.py: the same
  operations, but the order of the d-fold weight product differs between
  the libraries); bitwise where that order cannot differ (d = 2, Linear);
- table gradients, per table entry, in units of S = the sum of
  |contribution| into the entry (``ops.grid_encode.contribution_magnitudes``;
  test_torch_port_grid_backward.py): 1e-5 S for fp32 sums (the same fp32
  contributions added in another order), 2^-5 S for bf16 sums (both sides
  round every add to bf16, in another grouping);
- input gradients: rtol 1e-4 plus atol 1e-5 of max |dL/dx| (sums over
  levels and corners in another order).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcnn_tpu.encodings as jenc
import tcnn_tpu_torch.encodings as tenc
from tcnn_tpu.common import HashType
from tcnn_tpu.encodings.grid import _grid_hash
from tcnn_tpu_torch.ops import grid_encode as ge
from tcnn_tpu_torch.ops import pcg32_jump as pj
from tcnn_tpu_torch.rng import PCG32

RTOL, ATOL = 1e-6, 1e-7
CSRC = Path(__file__).resolve().parents[1] / "tcnn_tpu_torch" / "csrc"

# Levels 0-1 dense, 2-3 hashed (2D); in 3D level 0 dense, 1-3 hashed.
GRID = {
    "otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2, "log2_hashmap_size": 8,
    "base_resolution": 4, "per_level_scale": 2.0,
}


def _pair(d, cfg):
    je = jenc.create_encoding(d, cfg, 16)
    te = tenc.create_encoding(d, cfg, alignment=16)
    je.output_dtype = jnp.float32
    te.output_dtype = torch.float32
    return je, te


def _params(n, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, n).astype(np.float32)


def _fixed_points(batch, d, seed=0):
    """uint32 positions: random, both ends of the range, and the wrap."""
    x = np.random.default_rng(seed).integers(0, 2**32, (batch, d), dtype=np.uint64).astype(np.uint32)
    x[:4] = 0
    x[4:8] = 0xFFFFFFFF
    x[8:12] = 0x7FFFFFFF
    return x


def _torch_x(x):
    return torch.from_numpy(x.astype(np.int64)).to(torch.uint32) if x.dtype == np.uint32 else torch.from_numpy(x)


def _table_grad(apply, params, x, g, **kw):
    p = torch.from_numpy(params).requires_grad_()
    (grad,) = torch.autograd.grad((apply(p, _torch_x(x), **kw) * torch.from_numpy(g)).sum(), p)
    return grad.numpy()


def _jax_table_grad(je, params, x, g, **kw):
    return np.asarray(jax.grad(lambda p: jnp.sum(je.apply(p, jnp.asarray(x), **kw) * g))(jnp.asarray(params)))


def _scale(te, x, g, u=None):
    """S: per table entry the sum of |contribution| (fixed-point weights may
    be negative, so not the table gradient of |g|)."""
    from tcnn_tpu_torch.encodings.grid import _INTERP_CODES

    return ge.contribution_magnitudes(_torch_x(x), torch.from_numpy(g), te._levels_on(torch.device("cpu")),
                                      te.n_features_per_level, _INTERP_CODES[te.interpolation_type], u).numpy()


def _assert_in_s(got, want, s, tol, what):
    err = np.abs(got - want)
    bad = err > tol * s + 1e-12
    assert not bad.any(), f"{what}: {bad.sum()} entries beyond {tol} S (max {err.max():.3e})"


@pytest.mark.parametrize("d", [1, 2, 3, 10])
def test_pcg32_jump_matches_jax_and_scalar_pcg32(d):
    c = np.random.default_rng(d).integers(0, 2**32, (257, d), dtype=np.uint64).astype(np.uint32)
    c[0] = 0
    c[1] = 0xFFFFFFFF
    want = np.asarray(_grid_hash(jnp.asarray(c), HashType.Rng)).astype(np.int64)
    got = pj.rng_hash(torch.from_numpy(c.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)
    # The scalar generator jumped by the same steps.
    hi, lo = pj.rng_step(torch.from_numpy(c[:16].astype(np.int64)))
    for h, l, out in zip(hi.tolist(), lo.tolist(), got[:16].tolist()):
        p = PCG32(pj.RNG_HASH_SEED)
        p.advance((h << 32) | l)
        assert int(p.next_uint()) == out


def test_kernel_jump_table_is_the_plain_versions():
    """csrc/grid_common.cuh's __constant__ jump table and seeded state are
    the ones ops.pcg32_jump computes."""
    src = (CSRC / "grid_common.cuh").read_text()
    body = src[src.index("kPcgJump[64] = {"):]
    body = body[: body.index("};")]
    pairs = [(int(m, 16), int(p, 16)) for m, p in re.findall(r"\{0x([0-9a-f]+)ull, 0x([0-9a-f]+)ull\}", body)]
    assert pairs == pj.PCG32_JUMP_TABLE
    state0 = re.search(r"kPcgState0 = 0x([0-9a-f]+)ull", src).group(1)
    assert int(state0, 16) == pj.PCG32_STATE0
    assert pj.PCG32_INC == 3  # pcg32 seeded with stream 1: (1 << 1) | 1


@pytest.mark.parametrize("d,interp", [(2, "Linear"), (3, "Smoothstep")])
def test_rng_hash_lookup_and_gradients_match_jax(d, interp):
    """(d = 1 and 10: the hash itself, above; the JAX package's Rng hash
    runs op by op, seconds a call, so the lookups stay few.)"""
    cfg = dict(GRID, hash="Rng", interpolation=interp)
    je, te = _pair(d, cfg)
    lt = te.level_table().view(np.uint32)
    hashed = [bool(h) for h in te._use_hash]
    assert any(hashed) and not all(hashed)
    assert [int(m) == ge.MODE_RNG for m in lt[:, 2]] == hashed
    params = _params(te.n_params)
    r = np.random.default_rng(1)
    x = r.uniform(-0.1, 1.1, (256, d)).astype(np.float32)
    g = r.standard_normal((256, te.padded_output_width)).astype(np.float32)
    # One JAX forward and backward (its Rng hash runs op by op, slowly).
    want, vjp = jax.vjp(lambda p, xx: je.apply(p, xx), jnp.asarray(params), jnp.asarray(x))
    jgp, jdx = (np.asarray(v) for v in vjp(jnp.asarray(g)))
    pt, xt = torch.from_numpy(params).requires_grad_(), torch.from_numpy(x).requires_grad_()
    got = te.apply(pt, xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    gp, dx = torch.autograd.grad((got * torch.from_numpy(g)).sum(), (pt, xt))
    _assert_in_s(gp.numpy(), jgp, _scale(te, x, g), 1e-5, "Rng table gradient")
    np.testing.assert_allclose(dx.numpy(), jdx, rtol=1e-4, atol=1e-5 * np.abs(jdx).max())


@pytest.mark.parametrize("d,extra", [(2, {}), (3, {"interpolation": "Smoothstep", "hash": "Rng"}),
                                     (2, {"type": "Dense", "n_levels": 3})])
def test_fixed_point_matches_jax(d, extra):
    cfg = dict(GRID, fixed_point_pos=True, **extra)
    je, te = _pair(d, cfg)
    params = _params(te.n_params, 2)
    x = _fixed_points(256, d, 3)
    g = np.random.default_rng(4).standard_normal((256, te.padded_output_width)).astype(np.float32)
    want, vjp = jax.vjp(lambda p: je.apply(p, jnp.asarray(x)), jnp.asarray(params))
    want, (jgp,) = np.asarray(want), vjp(jnp.asarray(g))
    got = te.apply(torch.from_numpy(params), _torch_x(x)).numpy()
    if d == 2 and not extra.get("interpolation"):
        np.testing.assert_array_equal(got, want)  # the same cell, weights and products, in the same order
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    _assert_in_s(_table_grad(te.apply, params, x, g), np.asarray(jgp), _scale(te, x, g), 1e-5,
                 "fixed-point table gradient")


def test_fixed_point_cell_columns():
    """The level table's fixed-point columns are the JAX package's cell
    (tcnn_tpu/encodings/grid.py:1583-1592), computed from the float64
    scale; without fixed_point_pos they stay zero."""
    te = tenc.create_encoding(2, dict(GRID, fixed_point_pos=True), alignment=16)
    lt = te.level_table().view(np.uint32)
    for lvl, scale in enumerate(te.scales):
        cell = max(int(0xFFFFFFFF / scale), 1)
        assert list(lt[lvl, ge._CELL_COL : ge._FACTOR_COL]) == [cell, cell // 2, int(scale)]
        assert lt[lvl, ge._FACTOR_COL].view(np.float32) == np.float32(scale / float(0xFFFFFFFF))
    plain = tenc.create_encoding(2, GRID, alignment=16).level_table()
    assert not plain[:, ge._CELL_COL :].any() and plain.shape == (4, 32)


def test_fixed_point_inputs_and_what_has_no_gradient():
    """Float positions raise TypeError, as the JAX package's; so does the
    raster, whose positions are float there too. A uint32 position has no
    gradient in either package: torch refuses ``requires_grad`` on it. The
    table gradient works, and so does a second derivative through it (the
    lookup of its cotangent at the positions: no derivative in x), as
    jax.grad of jax.grad gives it."""
    je, te = _pair(2, dict(GRID, fixed_point_pos=True))
    p = torch.from_numpy(_params(te.n_params))
    with pytest.raises(TypeError, match="uint32"):
        te.apply(p, torch.zeros((4, 2)))
    with pytest.raises(TypeError, match="uint32"):
        je.apply(jnp.asarray(p.numpy()), jnp.zeros((4, 2)))
    with pytest.raises(TypeError, match="uint32"):
        te.apply_raster(p, 8)
    with pytest.raises(TypeError, match="uint32"):
        je.apply_raster(jnp.asarray(p.numpy()), 8)
    x = _torch_x(_fixed_points(16, 2))
    with pytest.raises(RuntimeError):
        x.clone().requires_grad_()
    pp = p.clone().requires_grad_()
    (gp,) = torch.autograd.grad((te.apply(pp, x) ** 2).sum(), pp, create_graph=True)
    (got,) = torch.autograd.grad((gp * gp).sum(), pp)
    jx = jnp.asarray(_fixed_points(16, 2))

    def loss(q):
        return jnp.sum(jax.grad(lambda r: jnp.sum(je.apply(r, jx) ** 2))(q) ** 2)

    want = np.asarray(jax.grad(loss)(jnp.asarray(p.numpy())))
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


def test_fixed_point_takes_no_static_path():
    """Under fixed_point_pos the JAX package skips its stratified, separable
    and phase-locked paths (tcnn_tpu/encodings/grid.py:502, 1462, 1487), so
    with table_dtype bfloat16 every level rounds its reads, on a perfect
    square batch too."""
    cfg = dict(GRID, fixed_point_pos=True, gather_strategy="stratified", strata=16, table_dtype="bfloat16",
               phase_locked=True)
    je, te = _pair(2, cfg)
    assert te.rounded_levels(256) == [True] * 4 and not te._locked_levels(16)
    assert (te.gradient_classes(256) == te.gradient_classes(256, stratified=False)).all()
    params = _params(te.n_params, 5)
    x = _fixed_points(256, 2, 6)
    want = np.asarray(je.apply(jnp.asarray(params), jnp.asarray(x)))
    np.testing.assert_array_equal(te.apply(torch.from_numpy(params), _torch_x(x)).numpy(), want)


def _jax_uniforms(key, batch, n_levels):
    """The JAX package's draws: one uniform per (sample, level) from
    fold_in(key, level) (tcnn_tpu/encodings/grid.py:1671-1680)."""
    return np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(key, lvl), (batch, 1)))[:, 0]
                     for lvl in range(n_levels)], 1)


# (config, tolerance in S): the fp32 class (per-level gathers, auto scatter
# at this batch) and a bf16 class (quad rows, xla_half: RN contributions
# summed in bf16), Linear and Smoothstep.
STOCHASTIC = [
    (dict(GRID, stochastic_interpolation=True), 2, 1e-5),
    (dict(GRID, stochastic_interpolation=True, interpolation="Smoothstep", log2_hashmap_size=12,
          gather_strategy="quad", scatter_strategy="xla_half"), 3, 2.0**-5),
]


@pytest.mark.parametrize("cfg,d,tol", STOCHASTIC, ids=["fp32-class", "bf16-class"])
def test_stochastic_table_gradient_matches_jax_draws(cfg, d, tol):
    je, te = _pair(d, cfg)
    batch = 256
    params = _params(te.n_params, 7)
    r = np.random.default_rng(8)
    x = r.uniform(0, 1, (batch, d)).astype(np.float32)
    g = r.standard_normal((batch, te.padded_output_width)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    u = torch.from_numpy(_jax_uniforms(key, batch, te.n_levels))
    want = _jax_table_grad(je, params, x, g, rng=key)
    got = _table_grad(te.apply, params, x, g, rng=u)
    _assert_in_s(got, want, _scale(te, x, g, u), tol, "stochastic table gradient")
    assert (got != 0).sum() < (_table_grad(te.apply, params, x, g) != 0).sum()
    # The forward and the input gradient stay the deterministic ones.
    xt = torch.from_numpy(x).requires_grad_()
    pt = torch.from_numpy(params).requires_grad_()
    y = te.apply(pt, xt, rng=u)
    np.testing.assert_array_equal(y.detach().numpy(), te.apply(pt, xt).detach().numpy())
    (dx,) = torch.autograd.grad((y * torch.from_numpy(g)).sum(), xt)
    jdx = np.asarray(jax.grad(lambda xx: jnp.sum(je.apply(jnp.asarray(params), xx, rng=key) * g))(jnp.asarray(x)))
    np.testing.assert_allclose(dx.numpy(), jdx, rtol=1e-4, atol=1e-5 * np.abs(jdx).max())


def test_stochastic_gradient_is_one_corner_and_unbiased():
    """One sample: each level's gradient lands on one table row, with the
    whole dL/dy row; averaged over draws from a generator it approaches
    the deterministic gradient (as tests/test_stochastic_interp.py holds
    the JAX package's)."""
    te = tenc.create_encoding(2, dict(GRID, stochastic_interpolation=True, n_levels=2), alignment=16)
    te.output_dtype = torch.float32
    params = _params(te.n_params, 9)
    x = np.array([[0.37, 0.61]], np.float32)
    g = np.zeros((1, te.padded_output_width), np.float32)
    g[0, :4] = [0.5, -1.0, 2.0, 0.25]
    gen = torch.Generator().manual_seed(0)
    one = _table_grad(te.apply, params, x, g, rng=gen).reshape(-1, 2)
    rows = np.flatnonzero(np.abs(one).sum(1))
    assert len(rows) == 2 and sorted(map(tuple, one[rows].tolist())) == sorted([(0.5, -1.0), (2.0, 0.25)])
    # Many samples, many draws: the mean against the deterministic gradient
    # of the output's sum.
    x = np.random.default_rng(10).uniform(0.2, 0.8, (16, 2)).astype(np.float32)
    g = np.ones((16, te.padded_output_width), np.float32)
    full = _table_grad(te.apply, params, x, g)
    mean = np.mean([_table_grad(te.apply, params, x, g, rng=gen) for _ in range(300)], axis=0)
    mask = np.abs(full) > 1e-3
    assert mask.any()
    assert np.median(np.abs(mean[mask] - full[mask]) / np.abs(full[mask])) < 0.25


def test_stochastic_call_takes_the_per_sample_path():
    """A call given ``rng`` takes no static path (stratified=True raises, as
    in the JAX package), so on a perfect-square batch of a stratified bf16
    config every level rounds, as the JAX package's stochastic call does;
    without ``rng`` the static levels read fp32. Nearest ignores ``rng``.
    A second derivative through the table gradient (cgp) is the JAX
    package's (the gather of the sampled corners of the cotangent); one
    through the input gradient is the deterministic one."""
    cfg = dict(GRID, stochastic_interpolation=True, gather_strategy="stratified", strata=16,
               table_dtype="bfloat16")
    je, te = _pair(2, cfg)
    params = _params(te.n_params, 12)
    ids = np.arange(256)
    x = ((np.stack([ids % 16, ids // 16], 1) + np.random.default_rng(13).uniform(0, 1, (256, 2))) / 16).astype(
        np.float32)
    key = jax.random.PRNGKey(3)
    u = torch.from_numpy(_jax_uniforms(key, 256, te.n_levels))
    pt = torch.from_numpy(params).requires_grad_()
    got = te.apply(pt, torch.from_numpy(x), rng=u).detach().numpy()
    np.testing.assert_array_equal(got, np.asarray(je.apply(jnp.asarray(params), jnp.asarray(x), rng=key)))
    with torch.no_grad():  # the same path without a gradient
        np.testing.assert_array_equal(te.apply(pt, torch.from_numpy(x), rng=u).numpy(), got)
    det = te.apply(pt, torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(det, np.asarray(je.apply(jnp.asarray(params), jnp.asarray(x))), rtol=RTOL, atol=ATOL)
    assert not np.array_equal(det, got)
    with pytest.raises(ValueError, match="stratified=True"):
        te.apply(pt, torch.from_numpy(x), rng=u, stratified=True)
    near = tenc.create_encoding(2, dict(GRID, stochastic_interpolation=True, interpolation="Nearest"), alignment=16)
    assert near._uniforms(u, 256, torch.device("cpu")) is None
    with pytest.raises(ValueError, match="rng uniforms"):
        te.apply(pt, torch.from_numpy(x), rng=u[:8])
    # Second order: d/dx of the input gradient's norm is the deterministic one.
    xt = torch.from_numpy(x[:32]).requires_grad_()
    (gx,) = torch.autograd.grad(te.apply(pt, xt, rng=u[:32]).sum(), xt, create_graph=True)
    (gx2,) = torch.autograd.grad(te.apply(pt, xt).sum(), xt, create_graph=True)
    a = torch.autograd.grad((gx * gx).sum(), pt)[0]
    b = torch.autograd.grad((gx2 * gx2).sum(), pt)[0]
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    key2 = jax.random.PRNGKey(4)
    u2 = torch.from_numpy(_jax_uniforms(key2, 32, te.n_levels))
    (gp,) = torch.autograd.grad((te.apply(pt, xt, rng=u2) ** 2).sum(), pt, create_graph=True)
    got = torch.autograd.grad((gp * gp).sum(), (pt, xt))

    def loss(q, xx):
        return jnp.sum(jax.grad(lambda r: jnp.sum(je.apply(r, xx, rng=key2) ** 2))(q) ** 2)

    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(params), jnp.asarray(x[:32]))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5 * np.abs(w).max())
