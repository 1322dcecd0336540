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
builds L2 and RelativeL2; the JAX package's other losses raise
``NotImplementedError``.
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


_LOSSES: CIDict = CIDict({"L2": L2Loss, "RelativeL2": RelativeL2Loss})
_NOT_PORTED = ("RelativeL2Luminance", "L1", "RelativeL1", "Mape", "Smape", "CrossEntropy", "Variance")


def create_loss(config: Optional[Dict] = None) -> Loss:
    """Factory (reference: src/loss.cu:81-90; default otype RelativeL2)."""
    name = json_value(config, "otype", "RelativeL2")
    if name not in _LOSSES:
        if name.lower() in (n.lower() for n in _NOT_PORTED):
            raise NotImplementedError(
                f"Loss '{name}' is not ported yet (ROADMAP.md, Queue 1 item 6: other losses and optimizers)"
            )
        raise ValueError(f"Loss '{name}' not found")
    loss = _LOSSES[name]()
    loss.update_hyperparams(config or {})
    return loss


__all__ = ["L2Loss", "Loss", "RelativeL2Loss", "create_loss"]
