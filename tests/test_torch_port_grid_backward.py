"""Scatter-add and the grid's table gradient: the PyTorch port's plain
versions against the JAX package.

- ``sr_round_bits`` (uint32 held in int64 on torch's CPU) against JAX
  ``_sr_round_bits`` on random and special bit patterns: bit-exact.
- ``scatter_rows_plain`` in the classes of the JAX Pallas scatters
  (``scatter_rows_onehot``, ``scatter_rows_serial``,
  ``scatter_rows_factored_pallas`` with pair/single/sr rounding; interpret
  mode).
- ``grid_backward_plain`` (through ``GridEncoding.apply``'s autograd
  Function) against ``jax.vjp`` of ``GridEncoding.apply`` with respect to
  the params: a per-sample batch, a stratified perfect-square batch (static
  coarse levels in the JAX package), a phase-locked batch, and the scatter
  strategies auto, factored_sr, xla_half and xla_half_sr.

Tolerances, per table entry, in units of S = sum of |contribution| into it
(the fp32-class table gradient of |dL_dy|):
- fp32 accumulation (classes none/RN/SR contributions, fp32 sums): 1e-5 S.
  The contributions are the same fp32 products (for RN/SR, then the same
  deterministic rounding); the sums run in another order, and the JAX pair
  class is fp32 to about 3e-6 relative.
- bf16 accumulation (xla_half, xla_half_sr): 2^-5 S. Both sides round to
  bf16 at every add (error up to 2^-8 of the partial sum each time), in
  another grouping and order, so they agree only to a few bf16 roundings.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcnn_tpu.encodings as jenc
import tcnn_tpu_torch.encodings as tenc
from tcnn_tpu.ops.pallas_utils import set_interpret_mode
from tcnn_tpu.ops.scatter_rows import (
    _sr_round_bits,
    _stochastic_round_bf16,
    scatter_rows_factored_pallas,
    scatter_rows_onehot,
    scatter_rows_serial,
)
from tcnn_tpu_torch.ops import grid_encode as ge
from tcnn_tpu_torch.ops import scatter_rows as sr

STRATA = 32
B_SQUARE = STRATA**2

BASE = {
    "otype": "HashGrid", "n_levels": 8, "n_features_per_level": 2,
    "log2_hashmap_size": 10, "base_resolution": 4, "per_level_scale": 1.5,
    "hash": "CoherentAdditive", "gather_strategy": "stratified", "strata": STRATA,
}


def _special_bits(rng):
    f32 = np.finfo(np.float32)
    special = np.array([
        0.0, -0.0, f32.tiny, -f32.tiny, f32.smallest_subnormal, -f32.smallest_subnormal,
        3 * f32.smallest_subnormal, f32.max, -f32.max, np.inf, -np.inf, 1.0, -1.0,
    ], np.float32).view(np.uint32)
    return np.concatenate([
        special,
        rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32),
        rng.normal(0, 1, 1024).astype(np.float32).view(np.uint32),
        (rng.normal(0, 1, 256) * 1e-40).astype(np.float32).view(np.uint32),  # subnormals
    ])


def test_sr_round_bits_is_bit_exact():
    bits = _special_bits(np.random.default_rng(0))
    want = np.asarray(_sr_round_bits(jnp.asarray(bits)))
    got = sr.sr_round_bits(torch.from_numpy(bits.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    # The rounded float: JAX's _stochastic_round_bf16 (finite inputs).
    x = bits.view(np.float32)
    x = x[np.isfinite(x)]
    want_f = np.asarray(jnp.asarray(_stochastic_round_bf16(jnp.asarray(x)), jnp.float32))
    got_f = sr.round_contributions(torch.from_numpy(x), sr.CONTRIB_SR).numpy()
    np.testing.assert_array_equal(got_f.view(np.uint32), want_f.view(np.uint32))


def _abs_sum(idx, rows, size):
    return sr.scatter_rows_plain(idx, rows.abs(), size)


def _assert_within(got, want, S, frac):
    got, want, S = (np.asarray(a, np.float64) for a in (got, want, S))
    assert got.shape == want.shape
    bad = np.abs(got - want) > frac * S + 1e-30
    assert not bad.any(), f"{bad.sum()} entries beyond {frac} S; worst {np.max(np.abs(got - want) / (S + 1e-30)):.3e}"


@pytest.mark.parametrize("heavy", [False, True], ids=["spread", "collisions"])
def test_scatter_rows_plain_matches_jax_kernels(heavy):
    rng = np.random.default_rng(int(heavy))
    n, size, r = 4096, (48 if heavy else 700), 8
    idx = rng.integers(0, size, n).astype(np.int32)
    rows = rng.normal(0, 1, (n, r)).astype(np.float32)
    ti, tr = torch.from_numpy(idx), torch.from_numpy(rows)
    S = _abs_sum(ti, tr, size).numpy()
    ji, jr = jnp.asarray(idx), jnp.asarray(rows)
    set_interpret_mode(True)
    try:
        cases = {
            "onehot": (np.asarray(scatter_rows_onehot(ji, jr, size)), sr.scatter_rows_onehot(ti, tr, size)),
            "serial": (np.asarray(scatter_rows_serial(ji, jr, size)), sr.scatter_rows_serial(ti, tr, size)),
        }
        for rounding in ("pair", "single", "sr"):
            cases[rounding] = (
                np.asarray(scatter_rows_factored_pallas(ji, jr, size, rounding=rounding, sub=512, n_sub=2)),
                sr.scatter_rows_factored(ti, tr, size, rounding),
            )
    finally:
        set_interpret_mode(None)
    for name, (want, got) in cases.items():
        assert got.dtype == torch.float32 and got.shape == (size, r), name
        _assert_within(got.numpy(), want, S, 1e-5)
    # The classes differ from each other: rounding is not a no-op.
    assert not torch.equal(cases["single"][1], cases["pair"][1])
    assert not torch.equal(cases["sr"][1], cases["single"][1])


def test_scatter_rows_plain_bf16_accumulation_is_exact_on_small_integers():
    """Integer contributions whose partial sums stay below 2^8 are exact in
    bf16 in any order: the bf16 accumulation then equals the fp32 one."""
    rng = np.random.default_rng(3)
    idx = torch.from_numpy(rng.integers(0, 512, 4096).astype(np.int32))
    rows = torch.from_numpy(rng.integers(-2, 3, (4096, 4)).astype(np.float32))
    got = sr.scatter_rows_plain(idx, rows, 512, sr.CONTRIB_RN, torch.bfloat16)
    assert torch.equal(got, sr.scatter_rows_plain(idx, rows, 512))
    assert torch.equal(sr.scatter_rows(idx, rows, 512), sr.scatter_rows_serial(idx, rows, 512))


def _pair(cfg):
    je = jenc.create_encoding(2, cfg, alignment=16)
    te = tenc.create_encoding(2, cfg, alignment=16)
    return je, te


def _square_batch(rng, phase_locked=False):
    ids = np.arange(B_SQUARE)
    base = np.stack([ids % STRATA, (ids // STRATA) % STRATA], 1).astype(np.float32)
    jitter = rng.uniform(0, 1, (1, 2) if phase_locked else (B_SQUARE, 2)).astype(np.float32)
    return ((base + jitter) / np.float32(STRATA)).astype(np.float32)


def _grads(cfg, x, seed):
    je, te = _pair(cfg)
    rng = np.random.default_rng(seed)
    params = rng.uniform(-1, 1, je.n_params).astype(np.float32)
    dy = rng.uniform(-1, 1, (len(x), je.padded_output_width)).astype(np.float32)
    dy = np.asarray(jnp.asarray(jnp.asarray(dy, jnp.bfloat16), jnp.float32))
    _, vjp = jax.vjp(lambda p: je.apply(p, jnp.asarray(x)), jnp.asarray(params))
    want = np.asarray(vjp(jnp.asarray(dy, jnp.bfloat16))[0])
    p = torch.from_numpy(params).requires_grad_(True)
    xt = torch.from_numpy(x)
    y = te.apply(p, xt)
    assert y.dtype == torch.bfloat16
    (got,) = torch.autograd.grad(y, p, torch.from_numpy(dy).bfloat16())
    classes = te.gradient_classes(len(x))
    abs_classes = torch.zeros_like(torch.from_numpy(classes))
    S = ge.grid_backward_plain(xt, torch.from_numpy(np.abs(dy)), te._levels_on(xt.device), 2,
                               ge.INTERP_LINEAR, abs_classes)
    return te, classes, got.numpy(), want, S.numpy()


CLASS_F32 = [sr.CONTRIB_NONE, sr.ACC_F32]


@pytest.mark.parametrize("strategy", ["auto", "factored_sr", "xla_half", "xla_half_sr"])
@pytest.mark.parametrize("batch", ["per_sample", "square"])
def test_grid_backward_plain_matches_jax(strategy, batch):
    rng = np.random.default_rng(len(strategy))
    if batch == "square":
        x = _square_batch(rng)
    else:
        x = rng.uniform(0, 1, (1000, 2)).astype(np.float32)
    te, classes, got, want, S = _grads(dict(BASE, scatter_strategy=strategy), x, seed=7)
    expect = {
        "auto": [sr.CONTRIB_NONE, sr.ACC_F32], "factored_sr": [sr.CONTRIB_SR, sr.ACC_F32],
        "xla_half": [sr.CONTRIB_RN, sr.ACC_BF16], "xla_half_sr": [sr.CONTRIB_SR, sr.ACC_BF16],
    }[strategy]
    # Square batches run the static path (an fp32 dense backward) on the
    # coarse levels (scale <= raster_max_scale = 64), the mode on the rest.
    static = te.scales <= te.raster_max_scale if batch == "square" else np.zeros(te.n_levels, bool)
    for lvl in range(te.n_levels):
        assert list(classes[lvl]) == (CLASS_F32 if static[lvl] else expect), (lvl, classes[lvl])
    frac = 2.0**-5 if expect[1] == sr.ACC_BF16 else 1e-5
    _assert_within(got, want, S, frac)
    # Entries that no sample touched hold an exact zero on both sides.
    np.testing.assert_array_equal(got[S == 0], 0.0)
    np.testing.assert_array_equal(want[S == 0], 0.0)


@pytest.mark.parametrize("locked_rounding", ["pair", "single", "sr"])
def test_grid_backward_plain_matches_jax_phase_locked(locked_rounding):
    cfg = dict(BASE, phase_locked=True, locked_rounding=locked_rounding, log2_hashmap_size=8, n_levels=10,
               stratified_max_variants=2)
    x = _square_batch(np.random.default_rng(2), phase_locked=True)
    te, classes, got, want, S = _grads(cfg, x, seed=9)
    locked = te._locked_levels(STRATA)
    assert locked, "no phase-locked level at this size"
    expect = {"pair": CLASS_F32, "single": [sr.CONTRIB_RN, sr.ACC_F32], "sr": [sr.CONTRIB_SR, sr.ACC_F32]}
    for lvl in locked:
        assert list(classes[lvl]) == expect[locked_rounding]
    _assert_within(got, want, S, 1e-5)


def test_scatter_strategy_changes_the_gradient():
    """The scatter strategy picks the rounding class of the table gradient,
    so it changes what a training step computes; "drop" gives none."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(0, 1, (1000, 2)).astype(np.float32))
    grads = {}
    for strategy in ("auto", "xla_half", "factored_sr", "drop"):
        te = tenc.create_encoding(2, dict(BASE, scatter_strategy=strategy), alignment=16)
        p = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, te.n_params).astype(np.float32))
        p.requires_grad_(True)
        y = te.apply(p, x)
        (grads[strategy],) = torch.autograd.grad(y, p, torch.ones_like(y) * 0.37)
    assert not torch.equal(grads["auto"], grads["xla_half"])
    assert not torch.equal(grads["auto"], grads["factored_sr"])
    assert not grads["drop"].any()
    with pytest.raises(ValueError, match="scatter_strategy"):
        tenc.create_encoding(2, dict(BASE, scatter_strategy="nope"))
    with pytest.raises(ValueError, match="locked_rounding"):
        tenc.create_encoding(2, dict(BASE, locked_rounding="nope"))


def test_flagship_classes():
    """The flagship at its training batch 2^18 = 512^2: levels 0-10 on the
    static path, 11-15 factored (fp32); with factored_sr those five are
    stochastically rounded."""
    import __graft_entry__ as g

    cfg = g.FLAGSHIP_CONFIG["encoding"]
    te = tenc.create_encoding(2, cfg, alignment=16)
    c = te.gradient_classes(2**18)
    assert (c == CLASS_F32).all()
    c = tenc.create_encoding(2, dict(cfg, scatter_strategy="factored_sr"), alignment=16).gradient_classes(2**18)
    assert (c[:11] == CLASS_F32).all() and (c[11:] == [sr.CONTRIB_SR, sr.ACC_F32]).all()
    # A batch that is not a perfect square takes the auto mode everywhere.
    c = te.gradient_classes(2**18 + 1)
    assert (c == CLASS_F32).all()
    # auto: large tables at large batch accumulate in bf16 (xla_half).
    big = tenc.create_encoding(2, dict(cfg, log2_hashmap_size=19), alignment=16)
    c = big.gradient_classes(2**18 + 1)
    assert (c[-1] == [sr.CONTRIB_RN, sr.ACC_BF16]).all()


def test_inputs_needing_gradients_and_stochastic_interpolation_raise():
    """Inputs that need a gradient are differentiated (the input-gradient
    kernel's plain version); training with stochastic interpolation still
    raises, while its input gradients, exact in the JAX package, work."""
    te = tenc.create_encoding(2, BASE, alignment=16)
    p = torch.zeros(te.n_params, requires_grad=True)
    x = torch.full((4, 2), 0.3, requires_grad=True)
    y = te.apply(p, x)
    dx, dp = torch.autograd.grad(y.float().sum(), (x, p))
    assert dx.shape == (4, 2) and dp.shape == p.shape and not dx.any()
    st = tenc.create_encoding(2, dict(BASE, stochastic_interpolation=True, gather_strategy="per_level"), alignment=16)
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        st.apply(torch.zeros(st.n_params, requires_grad=True), torch.zeros((4, 2)))
    with torch.no_grad():
        assert st.apply(torch.zeros(st.n_params), torch.zeros((4, 2))).shape == (4, 16)
    x = torch.full((4, 2), 0.3, requires_grad=True)
    (dx,) = torch.autograd.grad(st.apply(torch.ones(st.n_params), x).float().sum(), x)
    assert dx.shape == (4, 2)
