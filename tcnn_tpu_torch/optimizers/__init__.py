"""Optimizer factory (port of ``tcnn_tpu.optimizers``; reference:
src/optimizer.cu:49-80; default Adam). Adam and the EMA wrapper are
ported; the JAX package's other optimizers raise ``NotImplementedError``."""

from __future__ import annotations

from typing import Dict, Optional

from ..common import json_value
from .adam import AdamOptimizer
from .base import Optimizer
from .wrappers import EmaOptimizer, WrapperOptimizer

_NOT_PORTED = ("average", "batched", "composite", "exponentialdecay", "lookahead", "novograd", "sgd", "shampoo")


def create_optimizer(optimizer: Optional[Dict] = None) -> Optimizer:
    optimizer = optimizer or {}
    otype = json_value(optimizer, "otype", "Adam")
    kind = otype.lower()
    if kind == "adam":
        return AdamOptimizer(optimizer)
    if kind == "ema":
        return EmaOptimizer(optimizer)
    if kind in _NOT_PORTED:
        raise NotImplementedError(
            f"Optimizer '{otype}' is not ported yet (ROADMAP.md, Queue 1 item 6: other losses and optimizers)"
        )
    raise ValueError(f"Invalid optimizer type: {otype}")


__all__ = ["AdamOptimizer", "EmaOptimizer", "Optimizer", "WrapperOptimizer", "create_optimizer"]
