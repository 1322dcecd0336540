"""Trainer (port of ``tcnn_tpu.trainer``; reference: trainer.h).

The trainer owns the model's flat fp32 parameters (the model's
``nn.Parameter``), the loss, the optimizer and its state. One training step
is: the forward through the grid and MLP kernels, the loss and its explicit
gradient scaled by ``loss_scale`` (trainer.h:137), the backward through the
MLP and grid backward kernels (torch autograd over the kernels' Functions),
and the optimizer step, which divides the scale back out and, on the card,
updates the parameters and its state in place. ``training_step`` returns
the summed loss as a 0-d device tensor without a host synchronisation.
``training_step_plain`` runs the same step through every kernel's plain
version, on any device: the reference the kernel path is checked against.

The serving half: ``inference`` for arbitrary batches, ``inference_raster``
for the full tile-center raster and ``freeze_serving`` for a snapshot, all
over ``inference_params()`` (the EMA weights when the optimizer keeps them).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .common import default_loss_scale
from .losses import create_loss
from .optimizers import create_optimizer
from .rng import make_rng


class Trainer:
    def __init__(
        self,
        model,
        loss_config: Optional[Dict] = None,
        optimizer_config: Optional[Dict] = None,
        seed: int = 1337,
        loss_scale: Optional[float] = None,
        perturbation_sigma: Optional[float] = None,
        split_grid_state: bool = False,
    ):
        if perturbation_sigma is not None:
            raise NotImplementedError(
                "Trainer: perturbation_sigma is not ported yet (ROADMAP.md, Queue 1 item 6: other losses and optimizers)"
            )
        if split_grid_state:
            raise NotImplementedError(
                "Trainer: split_grid_state is a TPU layout of the JAX package and is not ported "
                "(ROADMAP.md, not to port)"
            )
        self.model = model
        self.loss_config = dict(loss_config or {})
        self.optimizer_config = dict(optimizer_config or {})
        self.loss = create_loss(self.loss_config)
        self.optimizer = create_optimizer(self.optimizer_config)
        self.loss_scale = float(loss_scale) if loss_scale is not None else default_loss_scale(model.compute_dtype)
        self.optimizer.allocate(model.n_params, model.layer_sizes())
        self.initialize_params(seed)

    @property
    def device(self) -> torch.device:
        return self.model.params.device

    def initialize_params(self, seed: int = 1337):
        """PCG32 init, bit-identical to the JAX package's (reference:
        trainer.h:69-87), and a fresh optimizer state."""
        params = self.model.initialize_params(make_rng(seed))
        if params.shape != (self.model.n_params,):
            raise RuntimeError(f"initialize_params: got {params.shape}, expected ({self.model.n_params},)")
        self.params = params
        self.opt_state = self.optimizer.init_state(self.device)

    @property
    def params(self) -> torch.Tensor:
        """The flat fp32 parameter vector (the model's ``nn.Parameter`` data)."""
        return self.model.params.data

    @params.setter
    def params(self, value):
        value = torch.as_tensor(value, dtype=torch.float32)
        if value.shape != (self.model.n_params,):
            raise ValueError(f"params: got shape {tuple(value.shape)}, model has {self.model.n_params} params")
        with torch.no_grad():
            self.model.params.copy_(value)

    @property
    def n_params(self) -> int:
        return self.model.n_params

    def inference_params(self) -> torch.Tensor:
        """Custom (EMA) weights if the optimizer keeps them, else the
        training params (reference: trainer.h:496-500)."""
        cw = self.optimizer.custom_weights(self.opt_state)
        return self.params if cw is None else cw

    # -- training ------------------------------------------------------------
    def _as_input(self, inputs) -> torch.Tensor:
        return torch.as_tensor(inputs, dtype=torch.float32, device=self.device)

    def _backward(self, inputs, plain: bool, output_gradient):
        """Forward with autograd, then the parameter gradient for the output
        gradient ``output_gradient(output)`` -> (dL_doutput, aux)."""
        x = self._as_input(inputs)
        params = self.model.params
        apply = self.model.apply_plain if plain else self.model.apply
        with torch.enable_grad():
            out = apply(params, x)
        dL_dy, aux = output_gradient(out.detach())
        (grads,) = torch.autograd.grad(out, params, dL_dy.to(out.dtype))
        return grads, aux

    def _optimizer_step(self, grads, plain: bool):
        with torch.no_grad():
            self.opt_state, new_params = self.optimizer.step(
                self.opt_state, self.model.params.data, grads, self.loss_scale, plain=plain
            )
            if new_params is not self.model.params.data:
                self.model.params.data.copy_(new_params)

    def _step(self, inputs, targets, data_pdf, plain: bool) -> torch.Tensor:
        y = torch.as_tensor(targets, dtype=torch.float32, device=self.device)
        pdf = None if data_pdf is None else torch.as_tensor(data_pdf, dtype=torch.float32, device=self.device)

        def loss_gradient(out):
            loss_sum, dL_dy = self.loss.evaluate_sum_and_gradient(self.loss_scale, out, y, pdf)
            return dL_dy, loss_sum

        grads, loss_sum = self._backward(inputs, plain, loss_gradient)
        self._optimizer_step(grads, plain)
        return loss_sum

    def training_step(self, inputs, targets, data_pdf=None) -> torch.Tensor:
        """One training iteration (trainer.h:97-141); returns the summed loss
        as a 0-d tensor on the device, without synchronising."""
        return self._step(inputs, targets, data_pdf, plain=False)

    def training_step_plain(self, inputs, targets, data_pdf=None) -> torch.Tensor:
        """``training_step`` through every kernel's plain torch version, on
        any device (on the CPU the two are the same)."""
        return self._step(inputs, targets, data_pdf, plain=True)

    def training_step_with_gradients(self, inputs, dL_doutput):
        """One optimizer step from external output gradients, shape (batch,
        padded_output_width), pre-scaled by ``loss_scale`` (trainer.h:127-138)."""
        dL = torch.as_tensor(dL_doutput, device=self.device)
        grads, _ = self._backward(inputs, False, lambda out: (dL, None))
        self._optimizer_step(grads, plain=False)

    @torch.no_grad()
    def forward(self, inputs) -> torch.Tensor:
        """Training-params forward, padded output in the compute dtype."""
        return self.model.apply(self.params, self._as_input(inputs))

    def evaluate_loss(self, inputs, targets, data_pdf=None):
        """Per-element loss values (batch, padded width) and their sum,
        without stepping."""
        out = self.forward(inputs)
        y = torch.as_tensor(targets, dtype=torch.float32, device=self.device)
        pdf = None if data_pdf is None else torch.as_tensor(data_pdf, dtype=torch.float32, device=self.device)
        values, _ = self.loss.evaluate(self.loss_scale, out, y, pdf)
        return values, torch.sum(values)

    @property
    def learning_rate(self) -> float:
        return self.optimizer.learning_rate

    @learning_rate.setter
    def learning_rate(self, value: float):
        self.optimizer.learning_rate = value

    # -- serving -------------------------------------------------------------
    @torch.no_grad()
    def inference(self, inputs) -> torch.Tensor:
        """Serving path: inference params, trimmed fp32 output of shape
        (batch, n_output_dims) (reference: object.h:214-271)."""
        out = self.model.apply(self.inference_params(), self._as_input(inputs))
        return out[:, : self.model.n_output_dims].to(torch.float32)

    @torch.no_grad()
    def inference_raster(self, side) -> torch.Tensor:
        """Full-raster evaluation: trimmed fp32 output of shape
        (prod(sides), n_output_dims) in raster order (dim 0 fastest,
        ``utils.sampling.raster_centers``). ``side`` is an int or a per-dim
        tuple, e.g. ``(w, h)`` for an image."""
        side = int(side) if np.isscalar(side) else tuple(int(s) for s in side)
        out = self.model.apply_raster(self.inference_params(), side)
        return out[:, : self.model.n_output_dims].to(torch.float32)

    def freeze_serving(self, mesh=None, table_dtype: Optional[str] = None):
        """Production serving handle over a snapshot of the inference params
        (see ``serving.FrozenServer``)."""
        from .serving import FrozenServer

        return FrozenServer(self, mesh=mesh, table_dtype=table_dtype)
