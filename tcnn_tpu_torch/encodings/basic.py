"""Parameterless encodings (port of ``tcnn_tpu.encodings.basic``). So far
Identity, which ``modules.Network`` builds on; the others stay in ROADMAP.md
Queue 1 item 5."""

from __future__ import annotations

import torch

from .base import Encoding


class IdentityEncoding(Encoding):
    """y = x * scale + offset, padded with 1.0 (reference:
    encodings/identity.h:46-85; tcnn_tpu/encodings/basic.py:16-32).
    Elementwise fp32 torch, differentiable to any order."""

    otype = "Identity"
    pad_value = 1.0

    def __init__(self, n_dims_to_encode: int, scale: float = 1.0, offset: float = 0.0):
        super().__init__(n_dims_to_encode)
        self.scale = float(scale)
        self.offset = float(offset)
        self.n_output_dims = self.n_dims_to_encode

    def apply(self, params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return self._pad(x.to(torch.float32) * self.scale + self.offset)
