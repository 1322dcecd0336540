"""Losses (port of ``tcnn_tpu.losses``; reference: src/loss.cu).

A loss gives per-element values of shape ``(batch, stride)``, normalised by
``n_total = batch * dims`` and an optional importance-sampling
``data_pdf``, and the loss-scaled gradients ``dL_dprediction`` of the same
shape, cast to the prediction's dtype. ``stride`` is the network's padded
output width; lanes ``>= dims`` get zero values and gradients (reference:
l2.h:56-60). The gradients are the reference's explicit ones, not autograd
of the value: relative losses treat their normaliser as a constant. Plain
torch: the JAX package computes the losses in XLA, not in a kernel.

``create_loss(config)`` (case-insensitive ``otype``, default RelativeL2)
builds every loss the JAX package registers; ``ConstantLoss`` is a class
only, unregistered there as in the reference.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..common import CIDict, json_value


class Loss:
    """Base class; subclasses implement the elementwise
    ``_value_and_gradient`` (reference: loss.h:41-60)."""

    otype = "Loss"

    def _check_shapes(self, prediction, target, data_pdf):
        if prediction.dim() != 2 or target.dim() != 2:
            raise ValueError("prediction/target must be (batch, dim) matrices")
        batch, stride = prediction.shape
        tbatch, dims = target.shape
        if tbatch != batch:
            raise ValueError(f"batch mismatch: {batch} vs {tbatch}")
        if dims > stride:
            raise ValueError(f"target dims {dims} exceed prediction stride {stride}")
        if data_pdf is not None and data_pdf.shape != target.shape:
            raise ValueError("data_pdf must have the target's shape")
        return batch, stride, dims

    def _prepare(self, prediction, target, data_pdf):
        """Shape checks, the padding slice, fp32 casts and the all-ones pdf
        default, shared by ``evaluate`` and ``evaluate_sum_and_gradient``."""
        batch, stride, dims = self._check_shapes(prediction, target, data_pdf)
        pred = prediction[:, :dims].to(torch.float32)
        tgt = target.to(torch.float32)
        pdf = torch.ones_like(tgt) if data_pdf is None else data_pdf.to(torch.float32)
        return batch, stride, dims, pred, tgt, pdf

    @staticmethod
    def _scale_pad_cast(gradient, loss_scale, pad, dtype):
        """Loss-scale multiply, zero padding lanes, cast to the prediction
        dtype."""
        gradient = loss_scale * gradient
        if pad > 0:
            gradient = torch.cat([gradient, gradient.new_zeros((gradient.shape[0], pad))], dim=1)
        return gradient.to(dtype)

    def evaluate(self, loss_scale: float, prediction, target, data_pdf=None):
        """``(values, gradients)``, both ``(batch, stride)``."""
        batch, stride, dims, pred, tgt, pdf = self._prepare(prediction, target, data_pdf)
        values, gradient = self._value_and_gradient(pred, tgt, pdf, batch * dims)
        pad = stride - dims
        if pad > 0:
            values = torch.cat([values, values.new_zeros((batch, pad))], dim=1)
        return values, self._scale_pad_cast(gradient, loss_scale, pad, prediction.dtype)

    def evaluate_sum_and_gradient(self, loss_scale: float, prediction, target, data_pdf=None):
        """The trainer's path: ``(sum(values), gradients)`` with the sum a
        0-d fp32 tensor on the prediction's device (no host sync)."""
        batch, stride, dims, pred, tgt, pdf = self._prepare(prediction, target, data_pdf)
        values, gradient = self._value_and_gradient(pred, tgt, pdf, batch * dims)
        return torch.sum(values), self._scale_pad_cast(gradient, loss_scale, stride - dims, prediction.dtype)

    def _value_and_gradient(self, pred, target, pdf, n_total):
        raise NotImplementedError

    def update_hyperparams(self, params):
        pass

    def hyperparams(self):
        return {"otype": self.otype}


class L2Loss(Loss):
    """(reference: losses/l2.h:40-75)"""

    otype = "L2"

    def _value_and_gradient(self, pred, target, pdf, n_total):
        diff = pred - target
        values = diff * diff / pdf / n_total
        gradient = 2.0 * diff / pdf / n_total
        return values, gradient


class RelativeL2Loss(Loss):
    """L2 normalised by prediction^2 + 0.01 (reference:
    losses/relative_l2.h:40-78)."""

    otype = "RelativeL2"

    def _value_and_gradient(self, pred, target, pdf, n_total):
        norm = pred * pred + 0.01
        diff = pred - target
        values = diff * diff / norm / pdf / n_total
        gradient = 2.0 * diff / norm / pdf / n_total
        return values, gradient


class RelativeL2LuminanceLoss(Loss):
    """RelativeL2 normalised by the predicted RGB luminance (reference:
    losses/relative_l2_luminance.h:40-88). Needs dims >= 3; with dims >= 6
    the first two RGB triplets are summed before the luminance."""

    otype = "RelativeL2Luminance"

    def _value_and_gradient(self, pred, target, pdf, n_total):
        dims = pred.shape[1]
        if dims < 3:
            raise ValueError("RelativeL2Luminance requires at least 3 output dims")
        r, g, b = pred[:, 0], pred[:, 1], pred[:, 2]
        if dims >= 6:
            r, g, b = r + pred[:, 3], g + pred[:, 4], b + pred[:, 5]
        luminance = 0.299 * r + 0.587 * g + 0.114 * b
        norm = (luminance * luminance + 0.01)[:, None]
        diff = pred - target
        values = diff * diff / norm / pdf / n_total
        gradient = 2.0 * diff / norm / pdf / n_total
        return values, gradient


def _signed(diff, scale):
    """``scale`` where ``diff >= 0``, else ``-scale`` (the L1 family's
    gradient sign, 1 at 0 as in the reference)."""
    return torch.where(diff >= 0, scale, -scale)


class L1Loss(Loss):
    """(reference: losses/l1.h)"""

    otype = "L1"

    def _value_and_gradient(self, pred, target, pdf, n_total):
        diff = pred - target
        values = torch.abs(diff) / pdf / n_total
        gradient = _signed(diff, torch.ones_like(diff)) / pdf / n_total
        return values, gradient


class RelativeL1Loss(Loss):
    """L1 normalised by |prediction| + 0.01 (reference: losses/relative_l1.h)."""

    otype = "RelativeL1"

    def _value_and_gradient(self, pred, target, pdf, n_total):
        diff = pred - target
        scale = 1.0 / (torch.abs(pred) + 1e-2) / pdf
        return torch.abs(diff) * scale / n_total, _signed(diff, scale) / n_total


class MapeLoss(Loss):
    """Mean absolute percentage error (reference: losses/mape.h)."""

    otype = "Mape"

    def _value_and_gradient(self, pred, target, pdf, n_total):
        diff = pred - target
        scale = 1.0 / (torch.abs(target) + 1e-2) / pdf
        return torch.abs(diff) * scale / n_total, _signed(diff, scale) / n_total


class SmapeLoss(Loss):
    """Symmetric MAPE (reference: losses/smape.h)."""

    otype = "Smape"

    def _value_and_gradient(self, pred, target, pdf, n_total):
        diff = pred - target
        scale = 1.0 / (0.5 * (torch.abs(target) + torch.abs(pred)) + 1e-2) / pdf
        return torch.abs(diff) * scale / n_total, _signed(diff, scale) / n_total


class CrossEntropyLoss(Loss):
    """-target * log(pred) (reference: losses/cross_entropy.h); the 1/n_total
    normalisation is folded into ``factor``, so it scales the value and the
    gradient alike."""

    otype = "CrossEntropy"

    def _value_and_gradient(self, pred, target, pdf, n_total):
        factor = -target / pdf / n_total
        return factor * torch.log(pred), factor / pred


class VarianceIsLoss(Loss):
    """Variance of an importance sampler (reference: losses/variance_is.h)."""

    otype = "Variance"

    def _value_and_gradient(self, pred, target, pdf, n_total):
        factor = target * target / pdf / n_total
        return factor / pred - factor / pdf, -factor / (pred * pred)


class ConstantLoss(Loss):
    """Constant-gradient debugging loss (reference: losses/constant.h); not
    registered in the factory, there or in the JAX package."""

    otype = "Constant"

    def _value_and_gradient(self, pred, target, pdf, n_total):
        return pred / n_total, torch.ones_like(pred) / n_total


_LOSSES: CIDict = CIDict({
    cls.otype: cls
    for cls in (
        L2Loss, RelativeL2Loss, RelativeL2LuminanceLoss, L1Loss, RelativeL1Loss, MapeLoss, SmapeLoss,
        CrossEntropyLoss, VarianceIsLoss,
    )
})


def create_loss(config: Optional[Dict] = None) -> Loss:
    """Factory (reference: src/loss.cu:81-90; default otype RelativeL2)."""
    name = json_value(config, "otype", "RelativeL2")
    if name not in _LOSSES:
        raise ValueError(f"Loss '{name}' not found")
    loss = _LOSSES[name]()
    loss.update_hyperparams(config or {})
    return loss


def builtin_losses():
    return sorted(_LOSSES.keys())


__all__ = [
    "ConstantLoss", "CrossEntropyLoss", "L1Loss", "L2Loss", "Loss", "MapeLoss", "RelativeL1Loss", "RelativeL2Loss",
    "RelativeL2LuminanceLoss", "SmapeLoss", "VarianceIsLoss", "builtin_losses", "create_loss",
]
