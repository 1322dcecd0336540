"""Novograd (port of ``tcnn_tpu.optimizers.novograd``; reference:
optimizers/novograd.h).

A per-layer second moment: each weight matrix's squared gradient norm feeds
an EMA whose square root normalises that layer's first-moment update. Only
the params that ``layer_sizes`` cover are optimized (novograd.h:131-168).
On the first step both EMAs are seeded with the exact value (beta := 0,
novograd.h:147-150), chosen on the device with ``torch.where`` so that a
captured step replays it right. Plain torch operations (an XLA fusion in
the JAX package, not a kernel).
"""

from __future__ import annotations

from typing import Dict

import torch

from ..common import json_value, resolve_device
from .base import Optimizer


class NovogradOptimizer(Optimizer):
    otype = "Novograd"

    _KEYS = (
        ("learning_rate", "base_learning_rate"),
        ("beta1", "beta1"),
        ("beta2", "beta2"),
        ("epsilon", "epsilon"),
        ("relative_decay", "relative_weight_decay"),
        ("absolute_decay", "absolute_weight_decay"),
    )

    def __init__(self, params: Dict = None):
        super().__init__()
        self.base_learning_rate = 1e-3
        self.beta1 = 0.9
        self.beta2 = 0.999
        self.epsilon = 1e-8
        self.relative_weight_decay = 0.0
        self.absolute_weight_decay = 0.0
        self.update_hyperparams(params or {})

    def init_state(self, device=None):
        device = resolve_device(device)
        return {
            "step": torch.zeros((), dtype=torch.int32, device=device),
            "first_moments": torch.zeros((self.n_matrix_weights,), dtype=torch.float32, device=device),
            "per_layer_second_moments": torch.zeros((len(self.layer_sizes),), dtype=torch.float32, device=device),
        }

    def step(self, state, params, grads, loss_scale: float, plain: bool = False):
        current_step = state["step"] + 1
        first_step = current_step == 1
        beta1 = torch.where(first_step, 0.0, self.beta1)
        beta2 = torch.where(first_step, 0.0, self.beta2)
        weight = params.to(torch.float32)
        g_all = grads.to(torch.float32)
        lr = self.base_learning_rate
        new_first, new_second, new_weights = [], [], []
        offset = 0
        for li, (rows, cols) in enumerate(self.layer_sizes):
            size = rows * cols
            g_layer = g_all[offset : offset + size]
            g = g_layer / loss_scale
            norm_sq = torch.sum(g_layer**2) / (loss_scale * loss_scale)
            second = beta2 * state["per_layer_second_moments"][li] + (1 - beta2) * norm_sq
            first = beta1 * state["first_moments"][offset : offset + size] + (1 - beta1) * g / (
                torch.sqrt(second) + self.epsilon
            )
            w = weight[offset : offset + size]
            decayed = (1 - self.relative_weight_decay * lr) * w - torch.sign(w) * (self.absolute_weight_decay * lr)
            new_weights.append(decayed - lr * first)
            new_first.append(first)
            new_second.append(second)
            offset += size
        if offset < self.n_weights:
            new_weights.append(weight[offset:])
        new_state = {
            "step": current_step,
            "first_moments": torch.cat(new_first) if new_first else state["first_moments"],
            "per_layer_second_moments": torch.stack(new_second) if new_second else state["per_layer_second_moments"],
        }
        return new_state, torch.cat(new_weights) if new_weights else weight

    @property
    def learning_rate(self) -> float:
        return self.base_learning_rate

    @learning_rate.setter
    def learning_rate(self, value: float):
        self.base_learning_rate = float(value)

    def update_hyperparams(self, params: Dict):
        for key, attr in self._KEYS:
            v = json_value(params, key, None)
            if v is not None:
                setattr(self, attr, v)

    def hyperparams(self) -> Dict:
        return {"otype": self.otype, **{key: getattr(self, attr) for key, attr in self._KEYS}}
