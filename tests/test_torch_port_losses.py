"""Losses: the PyTorch port against the JAX package.

The same numpy predictions (bf16, with padding lanes), targets and
importance-sampling pdfs go through ``tcnn_tpu.losses`` and
``tcnn_tpu_torch.losses``: ``evaluate`` (values and gradients) and
``evaluate_sum_and_gradient`` (the trainer's path), with loss scales 1 and
128.

Tolerance: fp32 values and sums to rtol 1e-6 (the same elementwise
operations in the same order; sums reduce in another order); the bf16
gradients within one bf16 ulp (the fp32 gradient before the cast may differ
in its last bit, which can flip the rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcnn_tpu.losses as jlosses
import tcnn_tpu_torch.losses as tlosses
from tcnn_tpu_torch.common import default_loss_scale

BATCH, DIMS, STRIDE = 257, 3, 16


# Losses that take log(pred) or divide by pred see positive predictions.
POSITIVE = ("CrossEntropy", "Variance")
OTYPES = ["L2", "RelativeL2", "RelativeL2Luminance", "L1", "RelativeL1", "Mape", "Smape", "CrossEntropy", "Variance"]


def _inputs(seed, with_pdf, low=-1.0):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(low, 2, (BATCH, STRIDE)).astype(np.float32)
    pred = np.asarray(jnp.asarray(jnp.asarray(pred, jnp.bfloat16), jnp.float32))  # bf16 values
    target = rng.uniform(0, 1, (BATCH, DIMS)).astype(np.float32)
    pdf = rng.uniform(0.2, 2.0, (BATCH, DIMS)).astype(np.float32) if with_pdf else None
    return pred, target, pdf


def _both(otype):
    return jlosses.create_loss({"otype": otype}), tlosses.create_loss({"otype": otype})


def _assert_bf16_within_one_ulp(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    ulp = np.where(want == 0, 0.0, 2.0 ** (np.floor(np.log2(np.abs(want) + (want == 0))) - 7))
    assert np.all(np.abs(got - want) <= ulp + 1e-38)


@pytest.mark.parametrize("scale", [1.0, 128.0])
@pytest.mark.parametrize("with_pdf", [False, True])
@pytest.mark.parametrize("otype", OTYPES)
def test_evaluate_matches_jax(otype, with_pdf, scale):
    jl, tl = _both(otype)
    pred, target, pdf = _inputs(len(otype) * 2 + with_pdf, with_pdf, 0.1 if otype in POSITIVE else -1.0)
    jv, jg = jl.evaluate(
        scale, jnp.asarray(pred, jnp.bfloat16), jnp.asarray(target), None if pdf is None else jnp.asarray(pdf)
    )
    tv, tg = tl.evaluate(
        scale, torch.from_numpy(pred).bfloat16(), torch.from_numpy(target),
        None if pdf is None else torch.from_numpy(pdf),
    )
    assert tv.dtype == torch.float32 and tv.shape == (BATCH, STRIDE)
    assert tg.dtype == torch.bfloat16 and tg.shape == (BATCH, STRIDE)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=0)
    _assert_bf16_within_one_ulp(tg.float().numpy(), np.asarray(jnp.asarray(jg, jnp.float32)))
    # Padding lanes: zero values and zero gradients.
    assert not tv[:, DIMS:].any() and not tg[:, DIMS:].float().any()


@pytest.mark.parametrize("scale", [1.0, 128.0])
@pytest.mark.parametrize("with_pdf", [False, True])
@pytest.mark.parametrize("otype", OTYPES)
def test_sum_and_gradient_matches_jax(otype, with_pdf, scale):
    jl, tl = _both(otype)
    pred, target, pdf = _inputs(100 + len(otype) * 2 + with_pdf, with_pdf, 0.1 if otype in POSITIVE else -1.0)
    js, jg = jl.evaluate_sum_and_gradient(
        scale, jnp.asarray(pred, jnp.bfloat16), jnp.asarray(target), None if pdf is None else jnp.asarray(pdf)
    )
    ts, tg = tl.evaluate_sum_and_gradient(
        scale, torch.from_numpy(pred).bfloat16(), torch.from_numpy(target),
        None if pdf is None else torch.from_numpy(pdf),
    )
    assert ts.dim() == 0 and ts.dtype == torch.float32
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-6)
    _assert_bf16_within_one_ulp(tg.float().numpy(), np.asarray(jnp.asarray(jg, jnp.float32)))
    # The trainer's path and evaluate agree.
    tv, tg2 = tl.evaluate(scale, torch.from_numpy(pred).bfloat16(), torch.from_numpy(target),
                          None if pdf is None else torch.from_numpy(pdf))
    assert torch.equal(tg, tg2)
    np.testing.assert_allclose(float(ts), float(tv.sum()), rtol=1e-6)


def test_relative_l2_gradient_is_not_autograd():
    """The reference's RelativeL2 gradient treats the normaliser as a
    constant: it is not the derivative of the value."""
    pred, target, _ = _inputs(3, False)
    p = torch.from_numpy(pred[:, :DIMS]).requires_grad_(True)
    loss = tlosses.create_loss({"otype": "RelativeL2"})
    values, grads = loss.evaluate(1.0, p.detach().bfloat16(), torch.from_numpy(target))
    auto = torch.autograd.grad(((p - torch.from_numpy(target)) ** 2 / (p * p + 0.01)).sum() / p.numel(), p)[0]
    assert not torch.allclose(grads[:, :DIMS].float(), auto, rtol=1e-2, atol=0)


def test_factory_and_loss_scale():
    assert isinstance(tlosses.create_loss(None), tlosses.RelativeL2Loss)
    assert isinstance(tlosses.create_loss({"otype": "l2"}), tlosses.L2Loss)
    assert isinstance(tlosses.create_loss({"otype": "l1"}), tlosses.L1Loss)
    assert tlosses.builtin_losses() == sorted(OTYPES)
    # Constant is a class only, as in the JAX package and the reference.
    with pytest.raises(ValueError, match="not found"):
        tlosses.create_loss({"otype": "Constant"})
    with pytest.raises(ValueError, match="not found"):
        tlosses.create_loss({"otype": "NoSuchLoss"})
    loss = tlosses.create_loss({"otype": "L2"})
    with pytest.raises(ValueError, match="exceed"):
        loss.evaluate(1.0, torch.zeros((4, 2)), torch.zeros((4, 3)))
    with pytest.raises(ValueError, match="batch mismatch"):
        loss.evaluate(1.0, torch.zeros((4, 16)), torch.zeros((5, 3)))
    assert default_loss_scale(torch.bfloat16) == 128.0
    assert default_loss_scale("fp16") == 128.0
    assert default_loss_scale(torch.float32) == 1.0
    assert default_loss_scale(None) == 128.0


@pytest.mark.parametrize("with_pdf", [False, True])
@pytest.mark.parametrize("otype", OTYPES + ["Constant"])
def test_fp32_values_and_gradients_match_jax(otype, with_pdf):
    """fp32 predictions: values, sums and the explicit gradients (no bf16
    cast) to rtol 1e-6; Constant, unregistered, through its class."""
    if otype == "Constant":
        jl, tl = jlosses.ConstantLoss(), tlosses.ConstantLoss()
    else:
        jl, tl = _both(otype)
    pred, target, pdf = _inputs(300 + len(otype) + with_pdf, with_pdf, 0.1 if otype in POSITIVE else -1.0)
    jpdf, tpdf = (None, None) if pdf is None else (jnp.asarray(pdf), torch.from_numpy(pdf))
    jv, jg = jl.evaluate(128.0, jnp.asarray(pred), jnp.asarray(target), jpdf)
    tv, tg = tl.evaluate(128.0, torch.from_numpy(pred), torch.from_numpy(target), tpdf)
    assert tg.dtype == torch.float32
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=0)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6, atol=0)
    js, _ = jl.evaluate_sum_and_gradient(128.0, jnp.asarray(pred), jnp.asarray(target), jpdf)
    ts, _ = tl.evaluate_sum_and_gradient(128.0, torch.from_numpy(pred), torch.from_numpy(target), tpdf)
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-6)


def test_relative_l2_luminance_sums_two_triplets():
    """With six or more dims the luminance adds the first two RGB triplets
    (relative_l2_luminance.h); fewer than three dims raise."""
    rng = np.random.default_rng(7)
    pred = rng.uniform(-1, 2, (64, 8)).astype(np.float32)
    target = rng.uniform(0, 1, (64, 6)).astype(np.float32)
    jv, jg = jlosses.create_loss({"otype": "RelativeL2Luminance"}).evaluate(1.0, jnp.asarray(pred), jnp.asarray(target))
    tl = tlosses.create_loss({"otype": "RelativeL2Luminance"})
    tv, tg = tl.evaluate(1.0, torch.from_numpy(pred), torch.from_numpy(target))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=0)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="at least 3"):
        tl.evaluate(1.0, torch.zeros((4, 8)), torch.zeros((4, 2)))
