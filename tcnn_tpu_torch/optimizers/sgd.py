"""SGD (port of ``tcnn_tpu.optimizers.sgd``; reference: optimizers/sgd.h):
descale, l2 and the step in a few elementwise torch operations (an XLA
fusion in the JAX package, not a kernel)."""

from __future__ import annotations

from typing import Dict

import torch

from ..common import json_value
from .base import Optimizer


class SGDOptimizer(Optimizer):
    otype = "SGD"

    def __init__(self, params: Dict = None):
        super().__init__()
        self.base_learning_rate = 1e-3
        self.l2_reg = 1e-8
        self.update_hyperparams(params or {})

    def step(self, state, params, grads, loss_scale: float, plain: bool = False):
        weight = params.to(torch.float32)
        gradient = grads.to(torch.float32) / loss_scale + self.l2_reg * weight
        return {"step": state["step"] + 1}, weight - self.base_learning_rate * gradient

    @property
    def learning_rate(self) -> float:
        return self.base_learning_rate

    @learning_rate.setter
    def learning_rate(self, value: float):
        self.base_learning_rate = float(value)

    def update_hyperparams(self, params: Dict):
        v = json_value(params, "learning_rate", None)
        if v is not None:
            self.base_learning_rate = v
        v = json_value(params, "l2_reg", None)
        if v is not None:
            self.l2_reg = v

    def hyperparams(self) -> Dict:
        return {"otype": self.otype, "learning_rate": self.base_learning_rate, "l2_reg": self.l2_reg}
