"""Grid encoding: the PyTorch port's lookup against the JAX package's.

The same numpy inputs (positions from a seed, uniform +-1 tables) go
through ``tcnn_tpu`` ``GridEncoding.apply(..., stratified=False)`` (the
serving path) and through ``tcnn_tpu_torch``'s ``GridEncoding.apply``,
which on the CPU runs the lookup kernel's plain torch version. Both
instances output fp32 (the JAX instance's ``output_dtype`` is set in the
test), so the comparison sees the fp32 features.

Tolerance: rtol 1e-6 (about 8 fp32 ulps) plus atol 1e-7 for sums that
cancel near zero. Index arithmetic, weights, products and the corner sum
are the same operations in the same order; what remains is the order of
the d-fold weight product inside each library's reduction.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcnn_tpu.encodings as jenc
import tcnn_tpu_torch.encodings as tenc
from tcnn_tpu_torch.ops import grid_encode as ge

RTOL = 1e-6
ATOL = 1e-7

# Flagship-shaped geometry cut to size: levels 0-3 are dense (level sizes
# that are not powers of two), 4-5 hashed below raster_max_scale
# (raster-additive), 6-7 hashed by the additive hash.
BASE = {
    "otype": "HashGrid", "n_levels": 8, "n_features_per_level": 2,
    "log2_hashmap_size": 8, "base_resolution": 4, "per_level_scale": 1.5,
    "hash": "CoherentAdditive", "gather_strategy": "stratified", "strata": 16,
}


def _cfg(**over):
    c = dict(BASE)
    c.update(over)
    return {k: v for k, v in c.items() if v is not None}


CASES = {
    "flagship_shaped": _cfg(),
    "auto_hash": _cfg(hash="auto"),
    "prime": _cfg(hash="Prime"),
    "coherent_prime": _cfg(hash="CoherentPrime"),
    "reversed_prime": _cfg(hash="ReversedPrime"),
    "base_convert": _cfg(hash="BaseConvert"),
    "additive_per_level": _cfg(gather_strategy="per_level", strata=None),
    "additive_quad": _cfg(gather_strategy="quad", strata=None),
    "additive_fused": _cfg(gather_strategy="fused", strata=None),
    "smoothstep": _cfg(interpolation="Smoothstep"),
    "nearest": _cfg(interpolation="Nearest"),
    "smoothstep_prime": _cfg(interpolation="Smoothstep", hash="CoherentPrime", gather_strategy="per_level", strata=None),
    "table_fp16": _cfg(table_dtype="float16"),
    "table_bf16": _cfg(table_dtype="bfloat16"),
    "phase_locked": _cfg(phase_locked=True, strata=8),
    "dense_grid": _cfg(otype="DenseGrid", n_levels=4, hash=None),
    "tiled_grid": _cfg(otype="TiledGrid", n_levels=4, hash=None),
    "f4_levels4": _cfg(n_features_per_level=4, n_levels=4),
    "f1": _cfg(n_features_per_level=1),
    "strategy_keys_ignored": _cfg(quad_pack="packed", scatter_strategy="xla", level_split="off", locked_rounding="sr"),
    # The encoding's own table_dtype on an XOR-hashed config: JAX rounds it
    # inside its gathers (per-corner on the XOR levels, the quad table on
    # the dense ones), the port on every read; the same levels either way.
    "coherent_prime_table_bf16": _cfg(hash="CoherentPrime", table_dtype="bfloat16", gather_strategy="quad",
                                      strata=None),
}


def _boundary_points(scales, n_dims, rng, per_level=24):
    """Positions on cell boundaries of every level: x = (k - 0.5)/scale in
    fp32 and its two fp32 neighbours, where ``x * scale + 0.5`` lands on or
    next to an integer."""
    pts = []
    for s in scales:
        s32 = np.float32(s)
        k = rng.integers(0, int(np.ceil(s)) + 2, size=(per_level, n_dims)).astype(np.float32)
        x = (k - np.float32(0.5)) / s32
        pts += [x, np.nextafter(x, np.float32(np.inf)), np.nextafter(x, np.float32(-np.inf))]
    return np.concatenate(pts).astype(np.float32)


def _inputs(enc_np, n_dims, seed):
    rng = np.random.default_rng(seed)
    x = np.concatenate([
        rng.uniform(0, 1, (512, n_dims)).astype(np.float32),
        rng.uniform(-0.5, 1.5, (256, n_dims)).astype(np.float32),  # outside [0, 1]
        _boundary_points(enc_np.scales, n_dims, rng),
    ])
    params = rng.uniform(-1, 1, enc_np.n_params).astype(np.float32)
    return x, params


def _pair(cfg, n_dims):
    je = jenc.create_encoding(n_dims, cfg, alignment=16)
    te = tenc.create_encoding(n_dims, cfg, alignment=16)
    je.output_dtype = jnp.float32
    te.output_dtype = torch.float32
    return je, te


@pytest.mark.parametrize("n_dims", [2, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_grid_matches_jax(case, n_dims):
    je, te = _pair(CASES[case], n_dims)
    assert te.n_params == je.n_params
    np.testing.assert_array_equal(te.offset_table, je.offset_table)
    np.testing.assert_array_equal(te.scales, je.scales)
    np.testing.assert_array_equal(te.resolutions, je.resolutions)
    assert te.padded_output_width == je.padded_output_width
    x, params = _inputs(je, n_dims, seed=len(case) * 7 + n_dims)
    want = np.asarray(je.apply(jnp.asarray(params), jnp.asarray(x), stratified=False))
    got = te.apply(torch.from_numpy(params), torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_flagship_geometry_matches_jax():
    """The full flagship encoding: offsets, n_params and which levels index
    as dense rasters, raster-additive and additive-hashed (levels 0-5,
    6-10 and 11-15)."""
    import __graft_entry__ as g

    cfg = g.FLAGSHIP_CONFIG["encoding"]
    je = jenc.create_encoding(2, cfg, alignment=16)
    te = tenc.create_encoding(2, cfg, alignment=16)
    assert te.n_params == je.n_params == 708592
    np.testing.assert_array_equal(te.offset_table, je.offset_table)
    assert te.raster_max_scale == je.raster_max_scale == 1024.0
    table = te.level_table().view(np.uint32)
    dense = [not h for h in te._use_hash]
    raster = [float(s) <= te.raster_max_scale for s in te.scales]
    assert dense == [True] * 6 + [False] * 10
    assert raster == [True] * 11 + [False] * 5
    assert (table[:, 2] == ge.MODE_QUAD).all()
    # raster-additive levels fold raster strides (1, res) mod 2^15
    for lvl in range(6, 11):
        assert list(table[lvl, 4:6]) == [1, int(te.resolutions[lvl])]
    for lvl in range(11, 16):
        assert list(table[lvl, 4:6]) == [1, 2654435761]


def test_flagship_features_match_jax():
    import __graft_entry__ as g

    je, te = _pair(g.FLAGSHIP_CONFIG["encoding"], 2)
    x, params = _inputs(je, 2, seed=5)
    x = x[::4]
    want = np.asarray(je.apply(jnp.asarray(params), jnp.asarray(x), stratified=False))
    got = te.apply(torch.from_numpy(params), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_bf16_output_is_rounded_fp32():
    """The encoding's default output dtype is bf16: the fp32 features
    rounded once, with zero padding columns."""
    cfg = _cfg(n_levels=4)
    te = tenc.create_encoding(2, cfg, alignment=16)
    x, params = _inputs(te, 2, seed=3)
    p, xt = torch.from_numpy(params), torch.from_numpy(x)
    y16 = te.apply(p, xt)
    te.output_dtype = torch.float32
    y32 = te.apply(p, xt)
    assert y16.dtype == torch.bfloat16 and y16.shape == (len(x), 16)
    assert torch.equal(y16, y32.to(torch.bfloat16))
    assert not y16[:, 8:].any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mul32_is_uint32_product(seed):
    """The plain version's overflow-free uint32 multiply against numpy's
    wrapping uint32 arithmetic, over the full 32-bit range."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    for b in (1, 2654435761, 3674653429, 2531011, 0xFFFFFFFF, int(rng.integers(0, 2**32))):
        want = (a * np.uint32(b)).astype(np.int64)
        got = ge._mul32(torch.from_numpy(a.astype(np.int64)), b).numpy()
        np.testing.assert_array_equal(got, want)


def test_rng_hash_and_fixed_point_raise():
    """The grid extras these once raised on are accepted now (their parity
    with the JAX package: test_torch_port_grid_extras.py): the Rng hash on
    the hashed levels, fixed_point_pos on uint32 positions only, and a
    training call under stochastic interpolation."""
    rng = tenc.create_encoding(2, _cfg(hash="Rng"))
    # Hashed levels above raster_max_scale (6-7); the raster-additive
    # hashed levels 4-5 and the dense 0-3 keep their affine modes.
    modes = rng.level_table()[:, 2]
    assert [m == ge.MODE_RNG for m in modes] == [rng._level_strides(lvl) is None for lvl in range(8)]
    assert list(modes[6:]) == [ge.MODE_RNG] * 2
    fixed = tenc.create_encoding(2, _cfg(fixed_point_pos=True))
    assert fixed.fixed_point_pos and fixed.apply(torch.zeros(fixed.n_params), torch.zeros((4, 2), dtype=torch.uint32)).shape == (4, 16)
    with pytest.raises(TypeError, match="uint32"):
        fixed.apply(torch.zeros(fixed.n_params), torch.zeros((4, 2)))
    st = tenc.create_encoding(2, _cfg(stochastic_interpolation=True, gather_strategy="per_level"))
    p = torch.zeros(st.n_params, requires_grad=True)
    (g,) = torch.autograd.grad(st.apply(p, torch.full((4, 2), 0.3)).float().sum(), p)
    assert g.shape == p.shape and g.any()


# Serve-time table_dtype, level by level: the JAX package's FrozenServer
# stores its prebuilt quad tables (``serving_tables``) in that dtype and
# reads every other level from the fp32 parameters (rounded by the
# encoding's own table_dtype inside its gathers). Each case: (config, raster
# side or None for a batch, the levels the JAX package serves there).
SERVED = {
    # CoherentPrime: the dense coarse levels (0-3) have affine strides and
    # are served; the XOR-hashed ones are not.
    "coherent_prime_batch": (_cfg(hash="CoherentPrime", gather_strategy="quad", strata=None), None, 4),
    # Smoothstep: gather_strategy "auto" is per_level, no table is built.
    "smoothstep_per_level_batch": (_cfg(interpolation="Smoothstep", gather_strategy="auto", strata=None), None, 0),
    # The flagship shape on a batch: every level has affine strides.
    "stratified_batch": (_cfg(), None, 8),
    # ...and on a raster: levels 0-5 (scale <= raster_max_scale 32) take the
    # separable static path on fp32 parameters; 6-7 are served.
    "stratified_raster": (_cfg(), 16, 2),
    # The encoding's own fp16 first, then the served bf16 (the JAX tables
    # are built in the encoding's dtype and cast to the server's).
    "coherent_prime_fp16_then_bf16": (_cfg(hash="CoherentPrime", gather_strategy="quad", strata=None,
                                           table_dtype="float16"), None, 4),
}


@pytest.mark.parametrize("case", sorted(SERVED))
def test_serve_table_dtype_rounds_the_levels_jax_serves(case):
    """Features under a serve-time bfloat16 against the JAX package's
    lookup from its bf16 served tables (fp32 output; RTOL/ATOL as above),
    and the count of levels whose reads the port rounds."""
    cfg, side, n_served = SERVED[case]
    je, te = _pair(cfg, 2)
    x, params = _inputs(je, 2, seed=11)
    jp = jnp.asarray(params)
    tables = {k: v.astype(jnp.bfloat16) for k, v in je.serving_tables(jp).items()}
    assert sum(te.served_levels(None if side is None else (side, side))) == n_served
    if side is None:
        want = je.apply(jp, jnp.asarray(x), stratified=False, served_tables=tables)
        got = te.apply(torch.from_numpy(params), torch.from_numpy(x), table_dtype="bfloat16")
        unrounded = te.apply(torch.from_numpy(params), torch.from_numpy(x))
    else:
        want = je.apply_raster(jp, side, served_tables=tables)
        got = te.apply_raster(torch.from_numpy(params), side, table_dtype="bfloat16")
        unrounded = te.apply_raster(torch.from_numpy(params), side)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    # Exactly the served levels' features move.
    F = te.n_features_per_level
    moved = [not torch.equal(got[:, l * F:(l + 1) * F], unrounded[:, l * F:(l + 1) * F]) for l in range(te.n_levels)]
    assert moved == te.served_levels(None if side is None else (side, side))


# The JAX package's checks of its execution-strategy keys: (key, a value it
# rejects, a value it takes, whether it checks the key only under
# gather_strategy "stratified").
STRATEGY_VALUES = [
    ("quad_build", "tiles", "cf", False),
    ("level_split", "on", "barrier", False),
    ("strat_accum", "sum", "where", True),
    ("locked_fwd", "dense", "csr", True),
    ("locked_phases", 0, 4, True),
]


@pytest.mark.parametrize("key,bad,good,stratified_only", STRATEGY_VALUES, ids=[v[0] for v in STRATEGY_VALUES])
def test_strategy_keys_are_validated_as_jax_does(key, bad, good, stratified_only):
    """A value the JAX package rejects raises ValueError in the port too; a
    value it takes builds in both; the keys it checks only under
    "stratified" build with any value elsewhere in both."""
    with pytest.raises(ValueError):
        jenc.create_encoding(2, _cfg(**{key: bad}))
    with pytest.raises(ValueError, match=key):
        tenc.create_encoding(2, _cfg(**{key: bad}))
    je, te = _pair(_cfg(**{key: good}), 2)
    assert te.n_params == je.n_params
    if stratified_only:
        other = _cfg(gather_strategy="quad", strata=None, **{key: bad})
        jenc.create_encoding(2, other)
        tenc.create_encoding(2, other)


# The encoding's own table_dtype, level by level: the JAX package rounds a
# level's reads to it only inside its gathers (``forward_dtype``,
# tcnn_tpu/encodings/grid.py:_forward_dtype :572). The static levels of a
# stratified perfect-power batch, the separable levels of a stratified raster
# and the single global gathers of "fused" and "quad_fused" read the fp32
# parameters. Flagship-shaped encoding cut to a 2^12-row table and strata 64:
# levels 0-5 (scale <= 128) index with raster strides and are static on a
# 64^2 batch and separable on the 64^2 raster.
OWN_FLAG = _cfg(n_levels=16, base_resolution=16, log2_hashmap_size=12, strata=64)
OWN_CASES = {
    # (config, inputs, table_dtype, levels whose reads round)
    "stratified_batch_bf16": (OWN_FLAG, "stratified", "bfloat16", 10),
    "stratified_batch_fp16": (OWN_FLAG, "stratified", "float16", 10),
    "stratified_raster_bf16": (OWN_FLAG, "raster", "bfloat16", 10),
    "fused_bf16": (_cfg(n_levels=16, base_resolution=16, log2_hashmap_size=12, gather_strategy="fused", strata=None),
                   "uniform", "bfloat16", 0),
    "quad_fused_bf16": (_cfg(n_levels=16, base_resolution=16, log2_hashmap_size=12, gather_strategy="quad_fused",
                             strata=None), "uniform", "bfloat16", 0),
    "per_level_bf16": (_cfg(n_levels=16, base_resolution=16, log2_hashmap_size=12, gather_strategy="per_level",
                            strata=None), "uniform", "bfloat16", 16),
    # The same stratified encoding on a batch that is no perfect square:
    # no static level, every level rounds.
    "stratified_uniform_batch_bf16": (OWN_FLAG, "uniform", "bfloat16", 16),
}
OWN_SIDE = 64


def _own_inputs(kind, rng):
    import jax

    from tcnn_tpu.utils.sampling import stratified_uniform

    if kind == "stratified":
        return np.array(stratified_uniform(jax.random.PRNGKey(3), OWN_SIDE**2, 2))
    return rng.uniform(-0.1, 1.1, (3001, 2)).astype(np.float32)


@pytest.mark.parametrize("case", sorted(OWN_CASES))
def test_own_table_dtype_rounds_the_levels_jax_gathers(case):
    """Forward and input gradient under the encoding's own half table_dtype
    against the JAX package, on the CPU: features at RTOL/ATOL as above; the
    input gradient at rtol 1e-5 and atol 1e-5 of max |JAX| (the same fp32
    products, summed in another order; a half rounding that one side missed
    moves it by ~1e-3 relative). The raster has no input gradient: both
    packages build its positions inside. Then the port's count of rounded
    levels, and which levels' features move against float32."""
    import jax

    cfg, kind, table_dtype, n_rounded = OWN_CASES[case]
    je, te = _pair(dict(cfg, table_dtype=table_dtype), 2)
    rng = np.random.default_rng(len(case))
    params = rng.uniform(-1, 1, je.n_params).astype(np.float32)
    jp, tp = jnp.asarray(params), torch.from_numpy(params)
    if kind == "raster":
        want = np.asarray(je.apply_raster(jp, OWN_SIDE))
        got = te.apply_raster(tp, OWN_SIDE)
        sides, batch = (OWN_SIDE, OWN_SIDE), OWN_SIDE**2
    else:
        x = _own_inputs(kind, rng)
        cot = rng.normal(0, 1, (len(x), je.padded_output_width)).astype(np.float32)
        want = np.asarray(je.apply(jp, jnp.asarray(x)))
        want_dx = np.asarray(jax.grad(lambda xx: jnp.sum(je.apply(jp, xx) * cot))(jnp.asarray(x)))
        tx = torch.from_numpy(x).requires_grad_(True)
        got = te.apply(tp, tx)
        (got * torch.from_numpy(cot)).sum().backward()
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(tx.grad.numpy(), want_dx, rtol=1e-5, atol=1e-5 * float(np.abs(want_dx).max()))
        got = got.detach()
        sides, batch = None, len(x)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    rounded = te.rounded_levels(batch, sides)
    assert sum(rounded) == n_rounded
    te.table_dtype = "float32"
    unrounded = te.apply_raster(tp, OWN_SIDE) if kind == "raster" else te.apply(tp, torch.from_numpy(x))
    F = te.n_features_per_level
    assert [not torch.equal(got[:, l * F:(l + 1) * F], unrounded[:, l * F:(l + 1) * F])
            for l in range(te.n_levels)] == rounded


# The kernels' index arithmetic without division (csrc/grid_common.cuh:
# reduce, add_mod), reproduced in torch (uint32 values in int64, masked to
# 32 bits as the device wraps) and held to numpy's uint32 remainder and to
# the plain lookup's corner rows, on every level of the flagship encoding,
# the 3D model and CoherentPrime, and on dense levels whose sizes are no
# powers of two.
FLAGSHIP_ENC = {
    "otype": "HashGrid", "n_levels": 16, "n_features_per_level": 2, "log2_hashmap_size": 15,
    "base_resolution": 16, "per_level_scale": 1.5, "hash": "CoherentAdditive", "gather_strategy": "stratified",
}
INDEX_CASES = {
    "flagship": (2, FLAGSHIP_ENC),
    "3D model": (3, dict(FLAGSHIP_ENC, log2_hashmap_size=19, gather_strategy="auto")),
    "CoherentPrime": (2, dict(FLAGSHIP_ENC, hash="CoherentPrime")),
    "dense": (3, {"otype": "DenseGrid", "n_levels": 4, "n_features_per_level": 2, "base_resolution": 5,
                  "per_level_scale": 1.7}),
    "prime 4D": (4, _cfg(hash="Prime", gather_strategy="per_level", strata=None)),
}


def _umulhi32(a, b):
    """(a * b) >> 32 for int64 ``a`` in [0, 2^32) and ``b`` in [0, 2^32)
    (``__umulhi``), without overflowing int64."""
    return (((a * (b & 0xFFFF)) >> 16) + a * (b >> 16)) >> 16


def reduce_like_device(h, row):
    """``h`` mod the level size by csrc/grid_common.cuh:reduce from the
    level's row of the level table (uint32 values in int64, masked to 32
    bits as the device wraps)."""
    size, magic, shift = int(row[1]), int(row[26]), int(row[27])
    if magic == 0:
        return h & (size - 1)
    hi = _umulhi32(h, magic)
    q = ((((h - hi) & ge._M32) >> 1) + hi) >> shift
    return (h - ge._mul32(q, size)) & ge._M32


def _levels_of(case):
    d, cfg = INDEX_CASES[case]
    enc = tenc.create_encoding(d, cfg, alignment=16)
    return d, enc, enc.level_table().view(np.uint32).astype(np.int64)


@pytest.mark.parametrize("case", sorted(INDEX_CASES))
def test_device_reduction_equals_the_uint32_remainder(case):
    _, _, lt = _levels_of(case)
    rng = np.random.default_rng(7)
    non_power = 0
    for row in lt:
        size = int(row[1])
        non_power += size & (size - 1) != 0
        h = np.concatenate([[0, 1, size - 1, size, size + 1, 2**32 - 1, 2**32 - 2, (2**32 - 1) // size * size],
                            rng.integers(0, 2**32, 20_000)]).astype(np.int64)
        got = reduce_like_device(torch.from_numpy(h), row).numpy()
        want = (h.astype(np.uint32) % np.uint32(size)).astype(np.int64)
        np.testing.assert_array_equal(got, want)
    if case in ("flagship", "dense"):
        assert non_power > 0  # dense levels of res^d rows take the reciprocal


def _device_corner_rows(x, row, n_dims, bits):
    """The rows of csrc/grid_common.cuh:locate/corner: uint32 base reduced
    once (reduce), per-dim deltas added with add_mod; hashed modes reduced
    by reduce. (B, C) int64, level-local."""
    size, mode = int(row[1]), int(row[2])
    scale = float(np.int64(row[3]).astype(np.uint32).view(np.float32))
    pos = x * scale + 0.5
    pg = torch.floor(pos).to(torch.int32).to(torch.int64) & ge._M32
    s32 = [int(v) for v in row[4:4 + n_dims]]
    smod = [int(v) for v in row[4 + ge.MAX_DIMS:4 + ge.MAX_DIMS + n_dims]]

    def add_mod(a, b):
        s = (a + b) & ge._M32
        return torch.where((s < a) | (s >= size), (s - size) & ge._M32, s)

    cols = []
    if mode == ge.MODE_QUAD:
        base = torch.zeros_like(pg[:, 0])
        for k in range(n_dims):
            base = (base + ge._mul32(pg[:, k], s32[k])) & ge._M32
        base = reduce_like_device(base, row)
        for c in bits:
            delta = torch.zeros_like(base)
            for k in range(n_dims):
                if c[k]:
                    delta = add_mod(delta, torch.full_like(base, smod[k]))
            cols.append(add_mod(base, delta))
    else:
        for c in bits:
            h = torch.zeros_like(pg[:, 0])
            for k in range(n_dims):
                p = (pg[:, k] + int(c[k])) & ge._M32
                if mode == ge.MODE_FOLD:
                    h = (h + ge._mul32(p, s32[k])) & ge._M32
                elif mode == ge.MODE_XOR:
                    h = h ^ ge._mul32(p, s32[k])
                else:
                    h = ge._mul32((h + p) & ge._M32, 2531011)
            cols.append(reduce_like_device(h, row))
    return torch.stack(cols, dim=1)


@pytest.mark.parametrize("case", sorted(INDEX_CASES))
def test_device_corner_rows_equal_the_plain_lookups(case):
    n_dims, enc, lt = _levels_of(case)
    rng = np.random.default_rng(8)
    x = torch.from_numpy(np.concatenate([rng.uniform(0, 1, (3000, n_dims)), rng.uniform(-3, 4, (1000, n_dims)),
                                         _boundary_points(enc.scales, n_dims, rng)]).astype(np.float32))
    bits = ge._corner_bits(n_dims, ge.INTERP_LINEAR)
    for row in lt:
        idx, _ = ge._level_rows(x, row, ge.INTERP_LINEAR, bits)
        torch.testing.assert_close(_device_corner_rows(x, row, n_dims, bits) + int(row[0]), idx, rtol=0, atol=0)


@pytest.mark.parametrize("size", [1, 2, 3, 7, 256, 576, 3032, 14888, 2**15, 2**19 + 1, 2**31 - 1, 2**31, 2**32 - 1])
def test_mod_reciprocal_fields(size):
    magic, shift = ge.mod_reciprocal(size)
    if size & (size - 1) == 0:
        assert (magic, shift) == (0, 0)
    else:
        assert 1 <= magic < 2**32 and 2**shift < size < 2**(shift + 1)
    t = ge.level_table([0], [size], [ge.MODE_XOR], [1.0], [[1, 3]]).view(np.uint32)
    assert t.shape == (1, 32) and (int(t[0, 26]), int(t[0, 27])) == (magic, shift)
