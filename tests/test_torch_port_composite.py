"""The remaining encodings of the port against the JAX package: Empty,
Frequency, TriangleWave, SphericalHarmonics (its kernel's plain version and
the kernel's constants), Composite (Concatenation with alignment
propagation, Sum, Product, ``dims_to_encode_begin``), the NRC preset, the
grid's ``max_level``, and ``Encoding.apply_raster`` on encodings without a
raster fast path (``Trainer.inference_raster``).

Tolerances, fp32 outputs (``output_dtype`` float32 on both sides):
- forward: max |diff| <= 1e-5 max |ref| (the same fp32 operations in the
  same order; sin and the frameworks' multiply-add contraction may differ
  in the last bits);
- input gradient: max |diff| <= 1e-4 max |ref| (autodiff of the same
  function; the sums of the chain's terms are taken in another order);
- the composite's grid part, its table gradient and max_level: the grid
  tests' 1e-6 absolute / 1e-5 relative (the same lookup);
- bf16 model outputs: ``assert_bf16_close`` (p99 relative error 1e-2, max
  |diff| <= 4 bf16 ulps of max |ref|), as the serving tests.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_ffmlp import assert_bf16_close

import tcnn_tpu as tc
import tcnn_tpu.encodings as jenc
import tcnn_tpu_torch as tt
import tcnn_tpu_torch.encodings as tenc
from tcnn_tpu_torch.ops import sh_encode as sh

FWD_RTOL = 1e-5
GRAD_RTOL = 1e-4


def _close_to_max(got, want, rtol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    if got.size == 0:
        return
    scale = max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= rtol * scale, (np.abs(got - want).max(), scale)


def _pair(n_dims, cfg, alignment=16):
    je = jenc.create_encoding(n_dims, cfg, alignment=alignment)
    te = tenc.create_encoding(n_dims, cfg, alignment=alignment)
    je.output_dtype = jnp.float32
    te.output_dtype = torch.float32
    assert te.padded_output_width == je.padded_output_width and te.n_params == je.n_params
    return je, te


def _params(je, seed):
    return je.initialize_params(tc.rng.make_rng(seed), 1.0).astype(np.float32)


def _points(n, d, seed, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, (n, d)).astype(np.float32)


def _forward_and_grad(je, te, x, params=None, seed=0, **kw):
    """(port y, JAX y, port dL/dx, JAX dL/dx) for L = sum(g * y), g a
    seeded normal, both packages on the same inputs."""
    jp = None if params is None else jnp.asarray(params)
    tp = torch.zeros(0) if params is None else torch.from_numpy(params)
    g = np.random.default_rng(seed + 100).normal(size=(x.shape[0], te.padded_output_width)).astype(np.float32)
    want = np.asarray(je.apply(jp, jnp.asarray(x), **kw))
    jdx = np.asarray(jax.grad(lambda xx: jnp.sum(je.apply(jp, xx, **kw) * g))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = te.apply(tp, xt, **kw)
    if y.requires_grad:
        (tdx,) = torch.autograd.grad((y * torch.from_numpy(g)).sum(), xt)
    else:  # Empty: the output does not depend on x
        tdx = torch.zeros_like(xt)
    return y.detach().numpy(), want, tdx.numpy(), jdx


BASIC = {
    "frequency_4": {"otype": "Frequency", "n_frequencies": 4},
    "frequency_12": {"otype": "Frequency", "n_frequencies": 12},
    "triangle_wave_3": {"otype": "TriangleWave", "n_frequencies": 3},
    "triangle_wave_12": {"otype": "TriangleWave", "n_frequencies": 12},
    "empty": {"otype": "Empty"},
}


@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("name", sorted(BASIC))
def test_basic_encodings_match_jax(name, d):
    """Forward and input gradient; Frequency's [d0k0 sin, d0k0 cos, ...]
    order and TriangleWave's 2^(k-1) frequencies and k/4 phases are the
    JAX package's; the padding (1.0) is appended."""
    je, te = _pair(d, BASIC[name])
    x = _points(256, d, seed=d, lo=-0.25, hi=1.25)
    got, want, tdx, jdx = _forward_and_grad(je, te, x, seed=d)
    _close_to_max(got, want, FWD_RTOL)
    np.testing.assert_array_equal(got[:, te.n_output_dims:], 1.0)
    if name == "empty":
        assert te.n_output_dims == 0 and not tdx.any() and not jdx.any()
    else:
        _close_to_max(tdx, jdx, GRAD_RTOL)
    assert te.hyperparams() == je.hyperparams()


@pytest.mark.parametrize("degree", range(1, 9))
def test_spherical_harmonics_matches_jax(degree):
    """Forward and input gradient at degrees 1-8 with the padding (1.0)
    BEFORE the SH values, on unit directions remapped to [0, 1]^3 and on
    points of the whole cube; on the CPU ``apply`` runs the kernel's plain
    version."""
    je, te = _pair(3, {"otype": "SphericalHarmonics", "degree": degree})
    assert te.n_to_pad == je.n_to_pad and te.n_output_dims == degree * degree
    r = np.random.default_rng(degree)
    d = r.normal(size=(200, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    x = np.concatenate([(d + 1) / 2, r.uniform(0, 1, (56, 3))]).astype(np.float32)
    got, want, tdx, jdx = _forward_and_grad(je, te, x, seed=degree)
    _close_to_max(got, want, FWD_RTOL)
    np.testing.assert_array_equal(got[:, : te.n_to_pad], 1.0)
    _close_to_max(tdx, jdx, GRAD_RTOL)
    # The plain version's own input gradient (what the kernel is held to)
    # is autograd of the same function.
    g = torch.from_numpy(np.random.default_rng(degree + 100).normal(size=got.shape).astype(np.float32))
    _close_to_max(sh.sh_backward_input_plain(torch.from_numpy(x), g, degree, te.n_to_pad).numpy(), jdx, GRAD_RTOL)


def test_spherical_harmonics_second_order_and_strided_input():
    """A column slice of a wider input (what a Composite hands the SH
    encoding) gives the values of its contiguous copy; the input gradient
    is differentiable again (create_graph), as jax.grad of jax.grad."""
    je, te = _pair(3, {"otype": "SphericalHarmonics", "degree": 4})
    wide = _points(64, 6, seed=3)
    x = wide[:, 3:]
    got = te.apply(torch.zeros(0), torch.from_numpy(wide)[:, 3:])
    assert torch.equal(got, te.apply(torch.zeros(0), torch.from_numpy(np.ascontiguousarray(x))))

    def jax_g2(xx):
        return jnp.sum(jax.grad(lambda v: jnp.sum(je.apply(None, v) ** 2))(xx) ** 2)

    want = np.asarray(jax.grad(jax_g2)(jnp.asarray(x)))
    xt = torch.from_numpy(np.ascontiguousarray(x)).requires_grad_(True)
    (dx,) = torch.autograd.grad((te.apply(torch.zeros(0), xt) ** 2).sum(), xt, create_graph=True)
    (ddx,) = torch.autograd.grad((dx**2).sum(), xt)
    _close_to_max(ddx.numpy(), want, GRAD_RTOL)


def test_sh_kernel_constants_are_the_plain_versions():
    """``csrc/sh_encode.cu``'s kCoef table holds fp32(K_l0) and
    fp32(sqrt(2) K_l|m|), the constants the plain version multiplies by."""
    src = (Path(sh.__file__).resolve().parent.parent / "csrc" / "sh_encode.cu").read_text()
    body = re.search(r"kCoef\[[^\]]*\] = \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    got = np.array([float(v.strip().rstrip("f")) for v in body.split(",") if v.strip()], np.float32)
    want = [np.float32(sh.k_lm(l, 0) if m == 0 else np.sqrt(2.0) * sh.k_lm(l, m))
            for l in range(sh.MAX_DEGREE) for m in range(l + 1)]
    np.testing.assert_array_equal(got, np.array(want, np.float32))


def test_sh_wrappers_take_the_plain_version_on_the_cpu():
    x = _points(33, 3, seed=5)
    y = sh.sh_encode(torch.from_numpy(x), 3, 7, 1.0, torch.float32)
    assert y.shape == (33, 16) and torch.equal(y, sh.sh_encode_plain(torch.from_numpy(x), 3, 7, 1.0, torch.float32))
    g = torch.ones((33, 16))
    assert torch.equal(sh.sh_backward_input(torch.from_numpy(x), g, 3, 7),
                       sh.sh_backward_input_plain(torch.from_numpy(x), g, 3, 7))
    assert sh.LAUNCHES == 0 and sh.BWD_LAUNCHES == 0
    with pytest.raises(ValueError):
        tenc.create_encoding(2, {"otype": "SphericalHarmonics"})
    with pytest.raises(ValueError):
        tenc.create_encoding(3, {"otype": "SphericalHarmonics", "degree": 9})


GRID = {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2, "log2_hashmap_size": 10,
        "base_resolution": 4, "per_level_scale": 1.5, "hash": "CoherentAdditive", "gather_strategy": "quad"}

COMPOSITES = {
    # The NeRF shape: grid 16 wide, then 7 pad columns of 1.0 before 9 SH values.
    "nerf": (6, {"otype": "Composite", "nested": [
        dict(GRID, n_levels=8, n_dims_to_encode=3), {"otype": "SphericalHarmonics", "degree": 3}]}, 16),
    "frequency_oneblob_identity": (5, {"otype": "Composite", "nested": [
        {"otype": "Frequency", "n_frequencies": 3, "n_dims_to_encode": 2},
        {"otype": "OneBlob", "n_bins": 4, "n_dims_to_encode": 2},
        {"otype": "Identity"}]}, 16),
    "dims_to_encode_begin": (4, {"otype": "Composite", "nested": [
        {"otype": "TriangleWave", "n_frequencies": 4, "n_dims_to_encode": 2, "dims_to_encode_begin": 2},
        dict(GRID, n_dims_to_encode=2, dims_to_encode_begin=0)]}, 8),
    "sum": (3, {"otype": "Composite", "reduction": "Sum", "nested": [
        {"otype": "Frequency", "n_frequencies": 2, "n_dims_to_encode": 2},
        dict(GRID, n_levels=4, n_dims_to_encode=3, dims_to_encode_begin=0)]}, 8),
    "product": (3, {"otype": "Composite", "reduction": "Product", "nested": [
        {"otype": "OneBlob", "n_bins": 4, "n_dims_to_encode": 2},
        {"otype": "TriangleWave", "n_frequencies": 4, "n_dims_to_encode": 2, "dims_to_encode_begin": 1}]}, 8),
    # Empty takes the remaining dims and the padding.
    "frequency_empty": (4, {"otype": "Composite", "nested": [
        {"otype": "Frequency", "n_frequencies": 3, "n_dims_to_encode": 2}, {"otype": "Empty"}]}, 16),
}


@pytest.mark.parametrize("name", sorted(COMPOSITES))
def test_composite_matches_jax(name):
    """Widths, padding of each nested encoding, parameters (PCG32 init
    bitwise), forward, input gradient and table gradient."""
    n, cfg, align = COMPOSITES[name]
    je, te = _pair(n, cfg, align)
    assert [(e.n_output_dims, e.n_to_pad) for e in te.nested] == [(e.n_output_dims, e.n_to_pad) for e in je.nested]
    assert te.dims_to_encode_begin == je.dims_to_encode_begin and te.hyperparams() == je.hyperparams()
    assert te.layer_sizes() == je.layer_sizes() == []
    params = _params(je, seed=7) * 1e4  # grid entries of O(1)
    np.testing.assert_array_equal(te.initialize_params(tt.rng.make_rng(7)), _params(je, seed=7))
    x = _points(300, n, seed=len(name))
    got, want, tdx, jdx = _forward_and_grad(je, te, x, params=params if te.n_params else None, seed=2)
    _close_to_max(got, want, FWD_RTOL)
    _close_to_max(tdx, jdx, GRAD_RTOL)
    if te.n_params:
        g = np.random.default_rng(9).normal(size=got.shape).astype(np.float32)
        jgp = np.asarray(jax.grad(lambda p: jnp.sum(je.apply(p, jnp.asarray(x)) * g))(jnp.asarray(params)))
        tp = torch.from_numpy(params).requires_grad_(True)
        (tgp,) = torch.autograd.grad((te.apply(tp, torch.from_numpy(x)) * torch.from_numpy(g)).sum(), tp)
        np.testing.assert_allclose(tgp.numpy(), jgp, rtol=1e-5, atol=1e-5)


def test_nerf_composite_alignment_widths():
    """The NeRF config's composite at the FullyFusedMLP's alignment 16:
    nested (n_output_dims, n_to_pad) = [(16, 0), (9, 7)], width 32."""
    _, cfg, align = COMPOSITES["nerf"]
    for make in (jenc.create_encoding, tenc.create_encoding):
        enc = make(6, cfg, alignment=align)
        assert [(e.n_output_dims, e.n_to_pad) for e in enc.nested] == [(16, 0), (9, 7)]
        assert enc.padded_output_width == 32 and enc.n_nested() == 2
    te = tenc.create_encoding(6, cfg, alignment=align)
    te.output_dtype = torch.float32
    assert all(e.output_dtype == torch.float32 for e in te.nested)


@pytest.mark.parametrize("cfg,n,match", [
    ({"otype": "Composite"}, 3, "array of nested"),
    ({"otype": "Composite", "nested": [{"otype": "Identity"}, {"otype": "OneBlob"}]}, 3, "single nested"),
    ({"otype": "Composite", "nested": [{"otype": "Identity", "n_dims_to_encode": 4}]}, 3, "more dims"),
    ({"otype": "Composite", "reduction": "Sum", "nested": [
        {"otype": "Identity", "n_dims_to_encode": 1}, {"otype": "Identity", "n_dims_to_encode": 2}]}, 3, "equal"),
], ids=["no_nested", "two_unspecified", "too_many_dims", "sum_widths"])
def test_composite_config_errors_match_jax(cfg, n, match):
    with pytest.raises(ValueError, match=match):
        jenc.create_encoding(n, cfg)
    with pytest.raises(ValueError, match=match):
        tenc.create_encoding(n, cfg)


@pytest.mark.parametrize("otype", ["NRC", "OneBlobFrequency"])
def test_nrc_preset_matches_jax(otype):
    """TriangleWave(3 dims, 12) + OneBlob(5 dims, 4 bins) + Identity(rest)."""
    cfg = {"otype": otype, "n_frequencies": 6}
    je, te = _pair(10, cfg)
    assert te.hyperparams() == je.hyperparams()
    assert [e.otype for e in te.nested] == ["TriangleWave", "OneBlob", "Identity"]
    x = _points(128, 10, seed=4)
    got, want, tdx, jdx = _forward_and_grad(je, te, x, seed=4)
    _close_to_max(got, want, FWD_RTOL)
    _close_to_max(tdx, jdx, GRAD_RTOL)


def test_every_jax_encoding_is_registered():
    assert tenc.builtin_encodings() == jenc.builtin_encodings()


MAX_LEVEL_GRID = dict(GRID, n_levels=8)


@pytest.mark.parametrize("max_level", [0.0, 0.5, 1.0])
def test_max_level_matches_jax(max_level):
    """Level l outputs zeros unless l < max_level * L + 1e-3, forward and
    table gradient (the masked levels get none), batch and raster."""
    je, te = _pair(2, MAX_LEVEL_GRID)
    params = _params(je, seed=5) * 1e4
    x = _points(256, 2, seed=6)
    jp, tp = jnp.asarray(params), torch.from_numpy(params)
    want = np.asarray(je.apply(jp, jnp.asarray(x), max_level=max_level, stratified=False))
    got = te.apply(tp, torch.from_numpy(x), max_level=max_level)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert torch.equal(got, te.apply_plain(tp, torch.from_numpy(x), max_level=max_level))
    active = int(np.sum(np.arange(8) < np.float32(max_level) * 8 + np.float32(1e-3)))
    assert not got[:, active * 2:].any() and (max_level == 0 or got[:, : active * 2].any())
    g = np.random.default_rng(3).normal(size=want.shape).astype(np.float32)
    jgp = np.asarray(jax.grad(lambda p: jnp.sum(je.apply(p, jnp.asarray(x), max_level=max_level,
                                                         stratified=False) * g))(jp))
    tpg = tp.clone().requires_grad_(True)
    (tgp,) = torch.autograd.grad((te.apply(tpg, torch.from_numpy(x), max_level=max_level)
                                  * torch.from_numpy(g)).sum(), tpg)
    np.testing.assert_allclose(tgp.numpy(), jgp, rtol=1e-5, atol=1e-5)
    assert not tgp[int(te.offset_table[active]) * 2:].any()
    want_r = np.asarray(je.apply_raster(jp, 8, max_level=max_level))
    np.testing.assert_allclose(te.apply_raster(tp, 8, max_level=max_level).numpy(), want_r, rtol=1e-5, atol=1e-6)


ONEBLOB_MODEL = {
    "loss": {"otype": "L2"},
    "optimizer": {"otype": "Adam", "learning_rate": 1e-2},
    "encoding": {"otype": "OneBlob", "n_bins": 16},
    "network": {"otype": "FullyFusedMLP", "n_neurons": 32, "n_hidden_layers": 1},
}


@pytest.mark.parametrize("encoding", [
    {"otype": "OneBlob", "n_bins": 16},
    {"otype": "Composite", "nested": [{"otype": "Frequency", "n_frequencies": 2, "n_dims_to_encode": 1},
                                      dict(GRID, n_dims_to_encode=1)]},
], ids=["oneblob", "composite"])
def test_inference_raster_on_encodings_without_a_raster_path(encoding):
    """``Trainer.inference_raster`` on an encoding that has no
    ``apply_raster`` of its own: the base class builds the raster's tile
    centres and applies, as the JAX package's ``Encoding.apply_raster``."""
    cfg = dict(ONEBLOB_MODEL, encoding=encoding)
    jm = tc.create_from_config(2, 3, cfg)
    tm = tt.create_from_config(2, 3, cfg, device="cpu")
    np.testing.assert_array_equal(np.asarray(jm.trainer.params), tm.params.numpy())
    got = tm.trainer.inference_raster(8)
    assert got.shape == (64, 3)
    assert_bf16_close(got.numpy(), np.asarray(jm.trainer.inference_raster(8)))
    from tcnn_tpu_torch.utils.sampling import raster_centers

    assert torch.equal(tm.trainer.inference_raster((4, 16)), tm.trainer.inference(raster_centers((4, 16), 2)))
