"""Composite optimizer: a nested optimizer for each contiguous range of the
params (port of ``tcnn_tpu.optimizers.composite``; reference:
optimizers/composite.h). Each nested config declares
``n_params_to_optimize``; the last may omit it and takes the remainder, as
in the JAX package. Each range is a view of the flat vector, so a nested
Adam on the card updates its range in place. ``custom_weights`` returns a
function of the live params that stitches the nested custom weights
together, with the live weights for ranges that have none
(composite.h:75-88)."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..common import json_value
from .base import Optimizer


def slice_layer_sizes(layer_sizes: List[Tuple[int, int]], offset: int, size: int) -> List[Tuple[int, int]]:
    """The layers inside [offset, offset + size); a boundary may not split
    a matrix (reference: composite.h:20-42)."""
    out = []
    pos = 0
    for rows, cols in layer_sizes:
        n = rows * cols
        if pos >= offset + size:
            break
        if pos >= offset:
            if pos + n > offset + size:
                raise ValueError("Invalid slice. Can't slice within a layer.")
            out.append((rows, cols))
        elif pos + n > offset:
            raise ValueError("Invalid slice. Can't slice within a layer.")
        pos += n
    return out


class CompositeOptimizer(Optimizer):
    otype = "Composite"

    def __init__(self, params: Dict = None):
        super().__init__()
        from . import create_optimizer  # late import, avoids a cycle

        nested_cfgs = json_value(params or {}, "nested", None)
        if not nested_cfgs:
            raise ValueError("Must provide an array of nested optimizers to CompositeOptimizer.")
        self._nested: List[Optimizer] = []
        self._declared_sizes: List[Optional[int]] = []
        for cfg in nested_cfgs:
            self._nested.append(create_optimizer(cfg))
            n = json_value(cfg, "n_params_to_optimize", None)
            self._declared_sizes.append(None if n is None else int(n))
        if sum(1 for s in self._declared_sizes if s is None) > 1:
            raise ValueError("CompositeOptimizer: only one nested optimizer may omit n_params_to_optimize")
        self.offsets: List[int] = []

    def allocate(self, n_weights, layer_sizes):
        super().allocate(n_weights, layer_sizes)
        declared = sum(s for s in self._declared_sizes if s is not None)
        remainder = n_weights - declared
        if remainder < 0:
            raise ValueError(f"CompositeOptimizer: declared {declared} params > total {n_weights}")
        sizes = [s if s is not None else remainder for s in self._declared_sizes]
        self.offsets = [0]
        for s in sizes:
            self.offsets.append(self.offsets[-1] + s)
        if self.offsets[-1] != n_weights:
            raise ValueError(f"CompositeOptimizer: ranges cover {self.offsets[-1]} of {n_weights} params")
        for opt, off, end in zip(self._nested, self.offsets[:-1], self.offsets[1:]):
            opt.allocate(end - off, slice_layer_sizes(layer_sizes, off, end - off))

    def _ranges(self):
        return zip(self._nested, self.offsets[:-1], self.offsets[1:])

    def init_state(self, device=None):
        return {"nested": [opt.init_state(device) for opt in self._nested]}

    def step(self, state, params, grads, loss_scale: float, plain: bool = False):
        new_states, new_parts = [], []
        for (opt, off, end), st in zip(self._ranges(), state["nested"]):
            ns, part = opt.step(st, params[off:end], grads[off:end], loss_scale, plain=plain)
            new_states.append(ns)
            new_parts.append(part.to(torch.float32))
        return {"nested": new_states}, torch.cat(new_parts)

    def custom_weights(self, state):
        customs = [opt.custom_weights(st) for opt, st in zip(self._nested, state["nested"])]
        if all(c is None for c in customs):
            return None

        def stitched(params):
            return torch.cat([
                c if c is not None else params[off:end] for c, (_, off, end) in zip(customs, self._ranges())
            ])

        return stitched

    def n_nested(self) -> int:
        return len(self._nested)

    def nested(self, idx: int = 0) -> Optimizer:
        return self._nested[idx]

    @property
    def learning_rate(self) -> float:
        return self._nested[0].learning_rate

    @learning_rate.setter
    def learning_rate(self, value: float):
        for opt in self._nested:
            opt.learning_rate = value

    def update_hyperparams(self, params: Dict):
        nested_cfgs = json_value(params, "nested", None)
        if nested_cfgs:
            for opt, cfg in zip(self._nested, nested_cfgs):
                opt.update_hyperparams(cfg)

    def hyperparams(self) -> Dict:
        return {"otype": self.otype, "nested": [opt.hyperparams() for opt in self._nested]}
