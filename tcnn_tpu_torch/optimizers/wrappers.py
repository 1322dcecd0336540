"""Wrapper optimizers (port of ``tcnn_tpu.optimizers.wrappers``): the
``WrapperOptimizer`` base and EMA. State is namespaced as ``{"nested": ...,
<wrapper fields>}``.

The EMA update is a few elementwise torch operations (an XLA fusion in the
JAX package, not a kernel).
"""

from __future__ import annotations

from typing import Dict

import torch

from ..common import json_value, resolve_device
from .base import Optimizer


class WrapperOptimizer(Optimizer):
    def __init__(self, params: Dict = None):
        super().__init__()
        from . import create_optimizer  # late import, avoids a cycle

        params = params or {}
        self._nested = create_optimizer(json_value(params, "nested", {}) or {})

    def allocate(self, n_weights, layer_sizes):
        super().allocate(n_weights, layer_sizes)
        self._nested.allocate(n_weights, layer_sizes)

    def n_nested(self) -> int:
        return 1

    def nested(self, idx: int = 0) -> Optimizer:
        if idx != 0:
            raise IndexError(idx)
        return self._nested

    @property
    def learning_rate(self) -> float:
        return self._nested.learning_rate

    @learning_rate.setter
    def learning_rate(self, value: float):
        self._nested.learning_rate = value

    def custom_weights(self, state):
        return self._nested.custom_weights(state["nested"])

    def update_hyperparams(self, params: Dict):
        nested_cfg = json_value(params, "nested", None)
        if nested_cfg is not None:
            self._nested.update_hyperparams(nested_cfg)

    def hyperparams(self) -> Dict:
        return {"otype": self.otype, "nested": self._nested.hyperparams()}


class EmaOptimizer(WrapperOptimizer):
    """Decay-corrected EMA of the post-step weights, served as the custom
    (inference) weights (reference: optimizers/ema.h:45-120); fp32
    accumulator, as in the JAX package."""

    otype = "EMA"

    def __init__(self, params: Dict = None):
        super().__init__(params)
        self.ema_decay = json_value(params or {}, "decay", 0.99)

    def init_state(self, device=None):
        device = resolve_device(device)
        return {
            "nested": self._nested.init_state(device),
            "weights_ema": torch.zeros((self.n_weights,), dtype=torch.float32, device=device),
        }

    def step(self, state, params, grads, loss_scale: float, plain: bool = False):
        nested_state, new_params = self._nested.step(state["nested"], params, grads, loss_scale, plain=plain)
        current_step = nested_state["step"].to(torch.float32)
        decay = self.ema_decay
        debias_old = 1.0 - torch.pow(decay, current_step - 1.0)
        debias_new = 1.0 / (1.0 - torch.pow(decay, current_step))
        source = self._nested.custom_weights(nested_state)
        if source is None:
            source = new_params
        ema = (state["weights_ema"] * decay * debias_old + source.to(torch.float32) * (1.0 - decay)) * debias_new
        return {"nested": nested_state, "weights_ema": ema}, new_params

    def custom_weights(self, state):
        return state["weights_ema"]

    def update_hyperparams(self, params: Dict):
        super().update_hyperparams(params)
        v = json_value(params, "decay", None)
        if v is not None:
            self.ema_decay = v

    def hyperparams(self) -> Dict:
        return {"otype": self.otype, "decay": self.ema_decay, "nested": self._nested.hyperparams()}
