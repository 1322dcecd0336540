"""Optimizer factory (port of ``tcnn_tpu.optimizers``; reference:
src/optimizer.cu:49-80; default Adam)."""

from __future__ import annotations

from typing import Dict, Optional

from ..common import json_value
from .adam import AdamOptimizer
from .base import Optimizer
from .composite import CompositeOptimizer
from .novograd import NovogradOptimizer
from .sgd import SGDOptimizer
from .shampoo import ShampooOptimizer
from .wrappers import (
    AverageOptimizer,
    BatchedOptimizer,
    EmaOptimizer,
    ExponentialDecayOptimizer,
    LookaheadOptimizer,
    WrapperOptimizer,
)

_OPTIMIZERS = {
    "adam": AdamOptimizer,
    "average": AverageOptimizer,
    "batched": BatchedOptimizer,
    "composite": CompositeOptimizer,
    "ema": EmaOptimizer,
    "exponentialdecay": ExponentialDecayOptimizer,
    "lookahead": LookaheadOptimizer,
    "novograd": NovogradOptimizer,
    "sgd": SGDOptimizer,
    "shampoo": ShampooOptimizer,
}


def create_optimizer(optimizer: Optional[Dict] = None) -> Optimizer:
    optimizer = optimizer or {}
    otype = json_value(optimizer, "otype", "Adam")
    cls = _OPTIMIZERS.get(otype.lower())
    if cls is not None:
        return cls(optimizer)
    raise ValueError(f"Invalid optimizer type: {otype}")


__all__ = [
    "AdamOptimizer", "AverageOptimizer", "BatchedOptimizer", "CompositeOptimizer", "EmaOptimizer",
    "ExponentialDecayOptimizer", "LookaheadOptimizer", "NovogradOptimizer", "Optimizer", "SGDOptimizer",
    "ShampooOptimizer", "WrapperOptimizer", "create_optimizer",
]
