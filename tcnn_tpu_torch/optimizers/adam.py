"""Adam with tiny-cuda-nn's exact semantics (port of
``tcnn_tpu.optimizers.adam``; reference: optimizers/adam.h:47-127).

Deviations from textbook Adam, reproduced as the JAX package has them:

- gradients are descaled by ``loss_scale`` on entry;
- the first ``n_matrix_weights`` entries (the network's weight matrices)
  and the rest (hash-grid tables etc.) have separate l2 regularization,
  learning-rate factor and enable flags;
- non-matrix params whose descaled gradient is exactly zero are skipped
  entirely (no moment update, no step count) when
  ``skip_zero_grad_non_matrix_params``: grid entries no sample touched keep
  their state;
- each parameter debiases with its own step count (adam.h:111-113);
- optional AdaBound bounds, relative/absolute weight decay and gradient /
  weight clipping.

On CUDA tensors ``step`` launches the fused kernel (``ops.fused_adam``,
``csrc/adam_step.cu``) and updates params and state in place; on CPU
tensors, or with ``plain=True``, it runs ``_step_plain``, the kernel's plain
torch version (tcnn_tpu/optimizers/adam.py:_step_xla).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..common import json_value, resolve_device
from ..ops import fused_adam
from ..utils.log import log_info
from .base import Optimizer


class AdamOptimizer(Optimizer):
    otype = "Adam"

    def __init__(self, params: Dict = None):
        super().__init__()
        self.base_learning_rate = 1e-3
        self.beta1 = 0.9
        self.beta2 = 0.999
        self.epsilon = 1e-8
        self.l2_reg = 1e-8
        self.non_matrix_learning_rate_factor = 1.0
        self.non_matrix_l2_reg = 0.0
        self.relative_weight_decay = 0.0
        self.absolute_weight_decay = 0.0
        self.weight_clipping_magnitude = 0.0
        self.gradient_clipping_magnitude = 0.0
        self.adabound = False
        self.optimize_matrix_params = True
        self.optimize_non_matrix_params = True
        self.skip_zero_grad_non_matrix_params = True
        self.update_hyperparams(params or {})

    def init_state(self, device=None):
        n = self.n_weights
        device = resolve_device(device)
        return {
            "step": torch.zeros((), dtype=torch.int32, device=device),
            "first_moments": torch.zeros((n,), dtype=torch.float32, device=device),
            "second_moments": torch.zeros((n,), dtype=torch.float32, device=device),
            "param_steps": torch.zeros((n,), dtype=torch.int32, device=device),
        }

    def step(self, state, params, grads, loss_scale: float, plain: bool = False):
        if plain or params.device.type == "cpu":
            return self._step_plain(state, params, grads, loss_scale)
        if params.device.type != "cuda":
            raise ValueError(f"AdamOptimizer.step: unsupported device {params.device}")
        if params.shape != (self.n_weights,):
            raise ValueError(f"AdamOptimizer.step: params {tuple(params.shape)}, allocated for {self.n_weights}")
        state["step"].add_(1)
        fused_adam.adam_step(
            params, grads.to(torch.float32).contiguous(), state["first_moments"], state["second_moments"],
            state["param_steps"], state["step"], self.kernel_hyperparams(loss_scale),
        )
        return state, params

    def __setattr__(self, name, value):
        if name in AdamOptimizer._STRUCT_ATTRS:
            self.__dict__["_struct"] = None
        super().__setattr__(name, value)

    def kernel_hyperparams(self, loss_scale: float) -> fused_adam.AdamHyperparams:
        """The kernel's struct (``fused_adam.hyperparams_of``), built again
        only when a hyperparameter, the allocation or the loss scale has
        changed since the last call."""
        cached = self.__dict__.get("_struct")
        if cached is None or cached[0] != loss_scale:
            cached = (loss_scale, fused_adam.hyperparams_of(self, self.n_weights, self.n_matrix_weights, loss_scale))
            self.__dict__["_struct"] = cached
        return cached[1]

    def _step_plain(self, state, params, grads, loss_scale: float):
        """The update in plain torch ops, fp32, as _step_xla writes it;
        returns new tensors and leaves its inputs as they were."""
        n = self.n_weights
        dev = params.device
        is_matrix = torch.arange(n, device=dev) < self.n_matrix_weights
        current_step = state["step"] + 1

        gradient = grads.to(torch.float32) / loss_scale

        active = torch.where(
            is_matrix, bool(self.optimize_matrix_params), bool(self.optimize_non_matrix_params)
        )
        if self.skip_zero_grad_non_matrix_params:
            active = active & (is_matrix | (gradient != 0.0))

        weight = params.to(torch.float32)
        gradient = gradient + torch.where(is_matrix, self.l2_reg, self.non_matrix_l2_reg) * weight
        if self.gradient_clipping_magnitude != 0.0:
            gradient = torch.clamp(gradient, -self.gradient_clipping_magnitude, self.gradient_clipping_magnitude)

        first = self.beta1 * state["first_moments"] + (1 - self.beta1) * gradient
        second = self.beta2 * state["second_moments"] + (1 - self.beta2) * gradient * gradient

        lr = torch.where(
            is_matrix, self.base_learning_rate, self.base_learning_rate * self.non_matrix_learning_rate_factor
        ).to(torch.float32)

        param_steps = state["param_steps"] + active.to(torch.int32)
        ps = torch.clamp_min(param_steps, 1).to(torch.float32)
        beta1 = torch.tensor(self.beta1, dtype=torch.float32, device=dev)
        beta2 = torch.tensor(self.beta2, dtype=torch.float32, device=dev)
        lr = lr * torch.sqrt(1 - torch.pow(beta2, ps)) / (1 - torch.pow(beta1, ps))

        if self.adabound:
            t = current_step.to(torch.float32)
            lower = 0.1 - 0.1 / ((1 - self.beta2) * t + 1)
            upper = 0.1 + 0.1 / ((1 - self.beta2) * t)
        else:
            lower = torch.tensor(0.0, dtype=torch.float32, device=dev)
            upper = torch.tensor(np.finfo(np.float32).max, dtype=torch.float32, device=dev)

        effective_lr = torch.clamp(lr / (torch.sqrt(second) + self.epsilon), lower, upper)

        decayed = (1 - self.relative_weight_decay * lr) * weight - torch.sign(weight) * (
            self.absolute_weight_decay * lr
        )
        new_weight = decayed - effective_lr * first
        if self.weight_clipping_magnitude != 0.0:
            new_weight = torch.clamp(new_weight, -self.weight_clipping_magnitude, self.weight_clipping_magnitude)

        new_params = torch.where(active, new_weight, weight)
        new_state = {
            "step": current_step,
            "first_moments": torch.where(active, first, state["first_moments"]),
            "second_moments": torch.where(active, second, state["second_moments"]),
            "param_steps": param_steps,
        }
        return new_state, new_params

    @property
    def learning_rate(self) -> float:
        return self.base_learning_rate

    @learning_rate.setter
    def learning_rate(self, value: float):
        self.base_learning_rate = float(value)

    _KEYS = (
        ("beta1", "beta1"),
        ("beta2", "beta2"),
        ("epsilon", "epsilon"),
        ("learning_rate", "base_learning_rate"),
        ("l2_reg", "l2_reg"),
        ("adabound", "adabound"),
        ("relative_decay", "relative_weight_decay"),
        ("absolute_decay", "absolute_weight_decay"),
        ("clipping_magnitude", "weight_clipping_magnitude"),
        ("gradient_clipping_magnitude", "gradient_clipping_magnitude"),
        ("non_matrix_learning_rate_factor", "non_matrix_learning_rate_factor"),
        ("non_matrix_l2_reg", "non_matrix_l2_reg"),
        ("optimize_matrix_params", "optimize_matrix_params"),
        ("optimize_non_matrix_params", "optimize_non_matrix_params"),
        ("skip_zero_grad_non_matrix_params", "skip_zero_grad_non_matrix_params"),
    )

    # What the kernel's struct is made of: assigning any of these drops the
    # cached struct (``kernel_hyperparams``).
    _STRUCT_ATTRS = frozenset([attr for _, attr in _KEYS] + ["n_weights", "layer_sizes"])

    def update_hyperparams(self, params: Dict):
        for key, attr in self._KEYS:
            v = json_value(params, key, None)
            if v is not None:
                setattr(self, attr, v)
        if json_value(params, "fused", None) is not None:
            # The JAX package's switch between its Pallas kernel and the XLA
            # chain; on the card the fused kernel always runs.
            log_info("Adam: the 'fused' key is ignored; the fused CUDA kernel always runs on the card")

    def hyperparams(self) -> Dict:
        return {"otype": self.otype, **{key: getattr(self, attr) for key, attr in self._KEYS}}
