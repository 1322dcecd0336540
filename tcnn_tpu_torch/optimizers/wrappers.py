"""Wrapper optimizers (port of ``tcnn_tpu.optimizers.wrappers``): EMA,
Average, Batched, Lookahead and ExponentialDecay around a nested optimizer
(reference: optimizers/{ema,average,batched,lookahead,exponential_decay}.h).
State is namespaced as ``{"nested": ..., <wrapper fields>}``.

Each update is a few elementwise torch operations (an XLA fusion in the JAX
package, not a kernel). What depends on a step count is chosen on the
device with ``torch.where``, never by a host ``if``. On the card the nested
Adam updates the params and its state in place, so a wrapper that needs the
params from before the nested step (Batched, ExponentialDecay) copies them
first.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..common import json_value, resolve_device
from .base import Optimizer, tree_map


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


class AverageOptimizer(WrapperOptimizer):
    """Sliding-window mean of the last ``n_samples`` weight snapshots
    (reference: optimizers/average.h:45-130), served as the custom weights.
    The ring slot is the nested step count mod ``n_samples``, read and
    written with index ops on the device; the ring (``n_samples`` copies of
    the weights) is written in place, one row a step."""

    otype = "Average"

    def __init__(self, params: Dict = None):
        super().__init__(params)
        self.n_samples = int(json_value(params or {}, "n_samples", 128))

    def init_state(self, device=None):
        device = resolve_device(device)
        return {
            "nested": self._nested.init_state(device),
            "weights_samples": torch.zeros((self.n_samples, self.n_weights), dtype=torch.float32, device=device),
            "weights_average": torch.zeros((self.n_weights,), dtype=torch.float32, device=device),
        }

    def step(self, state, params, grads, loss_scale: float, plain: bool = False):
        nested_state, new_params = self._nested.step(state["nested"], params, grads, loss_scale, plain=plain)
        idx = torch.remainder(nested_state["step"], self.n_samples).to(torch.int64).reshape(1)
        w = new_params.to(torch.float32)
        old_sample = torch.index_select(state["weights_samples"], 0, idx)[0]
        average = state["weights_average"] + (w - old_sample) / self.n_samples
        samples = state["weights_samples"].index_copy_(0, idx, w.reshape(1, -1))
        return {"nested": nested_state, "weights_samples": samples, "weights_average": average}, new_params

    def custom_weights(self, state):
        return state["weights_average"]

    def update_hyperparams(self, params: Dict):
        super().update_hyperparams(params)
        v = json_value(params, "n_samples", None)
        if v is not None:
            self.n_samples = int(v)

    def hyperparams(self) -> Dict:
        return {"otype": self.otype, "n_samples": self.n_samples, "nested": self._nested.hyperparams()}


class BatchedOptimizer(WrapperOptimizer):
    """Gradient accumulation: averages ``batch_size_multiplier`` gradients
    and steps the nested optimizer on every such call (reference:
    optimizers/batched.h:46-90). The JAX package's ``lax.cond`` becomes:
    run the nested step, then keep its result only where this call steps
    (``torch.where`` over params and nested state, copied beforehand since
    the nested step may update them in place)."""

    otype = "Batched"

    def __init__(self, params: Dict = None):
        super().__init__(params)
        self.batch_size_multiplier = int(json_value(params or {}, "batch_size_multiplier", 16))

    def init_state(self, device=None):
        device = resolve_device(device)
        return {
            "nested": self._nested.init_state(device),
            "step": torch.zeros((), dtype=torch.int32, device=device),
            "averaged_gradients": torch.zeros((self.n_weights,), dtype=torch.float32, device=device),
        }

    def step(self, state, params, grads, loss_scale: float, plain: bool = False):
        mult = self.batch_size_multiplier
        first = torch.remainder(state["step"], mult) == 0
        pool = torch.where(first, 0.0, state["averaged_gradients"]) + grads.to(torch.float32) / mult
        current_step = state["step"] + 1
        do_step = torch.remainder(current_step, mult) == 0
        kept_params = params.to(torch.float32).clone()
        kept_nested = tree_map(torch.clone, state["nested"])
        nested_state, stepped = self._nested.step(state["nested"], params, pool, loss_scale, plain=plain)
        nested_state = tree_map(lambda new, old: torch.where(do_step, new, old), nested_state, kept_nested)
        new_params = torch.where(do_step, stepped.to(torch.float32), kept_params)
        return {"nested": nested_state, "step": current_step, "averaged_gradients": pool}, new_params

    def update_hyperparams(self, params: Dict):
        super().update_hyperparams(params)
        v = json_value(params, "batch_size_multiplier", None)
        if v is not None:
            self.batch_size_multiplier = int(v)

    def hyperparams(self) -> Dict:
        return {
            "otype": self.otype, "batch_size_multiplier": self.batch_size_multiplier,
            "nested": self._nested.hyperparams(),
        }


class LookaheadOptimizer(WrapperOptimizer):
    """Lookahead (slow and fast weights): every ``n_steps``, pulls the fast
    weights toward the slow copy by ``alpha`` before the nested step
    (reference: optimizers/lookahead.h:45-97)."""

    otype = "Lookahead"

    def __init__(self, params: Dict = None):
        super().__init__(params)
        self.alpha = json_value(params or {}, "alpha", 0.5)
        self.n_steps = int(json_value(params or {}, "n_steps", 16))

    def init_state(self, device=None):
        device = resolve_device(device)
        return {
            "nested": self._nested.init_state(device),
            "weights_lookahead": torch.zeros((self.n_weights,), dtype=torch.float32, device=device),
        }

    def step(self, state, params, grads, loss_scale: float, plain: bool = False):
        current_step = state["nested"]["step"]
        w = params.to(torch.float32)
        lookahead = torch.where(current_step == 0, w, state["weights_lookahead"])
        sync = torch.remainder(current_step, self.n_steps) == 0
        synced = lookahead * (1.0 - self.alpha) + w * self.alpha
        # Fresh tensors: the nested step may update ``w`` in place.
        w = torch.where(sync, synced, w)
        lookahead = torch.where(sync, synced, lookahead)
        nested_state, new_params = self._nested.step(state["nested"], w, grads, loss_scale, plain=plain)
        return {"nested": nested_state, "weights_lookahead": lookahead}, new_params

    def custom_weights(self, state):
        return state["weights_lookahead"]

    def update_hyperparams(self, params: Dict):
        super().update_hyperparams(params)
        v = json_value(params, "alpha", None)
        if v is not None:
            self.alpha = v
        v = json_value(params, "n_steps", None)
        if v is not None:
            self.n_steps = int(v)

    def hyperparams(self) -> Dict:
        return {"otype": self.otype, "alpha": self.alpha, "n_steps": self.n_steps,
                "nested": self._nested.hyperparams()}


class ExponentialDecayOptimizer(WrapperOptimizer):
    """Piecewise-exponential learning-rate decay (reference:
    optimizers/exponential_decay.h:44-110): every ``decay_interval`` steps
    in ``[decay_start, decay_end]`` the learning rate is multiplied by
    ``decay_base``. As in the JAX package the factor lives in the state, on
    the device, and scales the nested update: w' = w + factor (step(w) - w)."""

    otype = "ExponentialDecay"

    _KEYS = (("decay_base", "decay_base"), ("decay_interval", "decay_interval"),
             ("decay_start", "decay_start"), ("decay_end", "decay_end"))

    def __init__(self, params: Dict = None):
        super().__init__(params)
        params = params or {}
        self.decay_base = json_value(params, "decay_base", 0.1)
        self.decay_interval = int(json_value(params, "decay_interval", 10000))
        self.decay_start = int(json_value(params, "decay_start", 10000))
        self.decay_end = int(json_value(params, "decay_end", 10000000))
        self._base_learning_rate = self._nested.learning_rate

    def init_state(self, device=None):
        device = resolve_device(device)
        return {"nested": self._nested.init_state(device), "lr_factor": torch.ones((), dtype=torch.float32, device=device)}

    def step(self, state, params, grads, loss_scale: float, plain: bool = False):
        current_step = state["nested"]["step"]
        decay_now = (
            (current_step >= self.decay_start)
            & (current_step <= self.decay_end)
            & (torch.remainder(current_step - self.decay_start, self.decay_interval) == 0)
        )
        factor = torch.where(
            current_step == 0, 1.0, state["lr_factor"] * torch.where(decay_now, self.decay_base, 1.0)
        )
        w = params.to(torch.float32).clone()
        nested_state, stepped = self._nested.step(state["nested"], params, grads, loss_scale, plain=plain)
        return {"nested": nested_state, "lr_factor": factor}, w + factor * (stepped - w)

    @property
    def learning_rate(self) -> float:
        return self._base_learning_rate

    @learning_rate.setter
    def learning_rate(self, value: float):
        self._base_learning_rate = float(value)
        self._nested.learning_rate = value

    def update_hyperparams(self, params: Dict):
        super().update_hyperparams(params)
        for key, attr in self._KEYS:
            v = json_value(params, key, None)
            if v is not None:
                setattr(self, attr, type(getattr(self, attr))(v))

    def hyperparams(self) -> Dict:
        return {"otype": self.otype, **{key: getattr(self, attr) for key, attr in self._KEYS},
                "nested": self._nested.hyperparams()}
