"""MLP — the plain matmul chain (port of ``tcnn_tpu.networks.mlp``).

This is the numerics oracle of the port and the plain version of the fused
MLP kernel (``ops.ffmlp``): every layer multiplies bf16-valued operands in
fp32 (exact products, fp32 sums), applies the activation in fp32 and then
rounds to the compute dtype, as the JAX package's chain and Pallas kernel do
(tcnn_tpu/ops/ffmlp.py:977-988).

Parameter layout parity (reference: fully_fused_mlp.cu:658-677): flat vector
of row-major matrices ``[W_in (W x in), W_h^(n-1) (W x W), W_out (out_p x
W)]``; ``y = x @ W^T`` in the batch-leading convention.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..common import Activation, next_multiple
from ..ops.ffmlp import ffmlp_forward_plain
from .base import Network


def xavier_init(rng, rows: int, cols: int, scale: float = 1.0) -> np.ndarray:
    """Xavier-uniform (reference: gpu_matrix.h:292-307)."""
    s = scale * np.sqrt(6.0 / (rows + cols))
    return (rng.next_float(rows * cols) * 2.0 * s - s).astype(np.float32)


def siren_init(rng, rows: int, cols: int, scale: float = 1.0, first: bool = False):
    """SIREN init (reference: gpu_matrix.h:343-374); fan_in = cols."""
    s = scale * (30.0 / cols if first else np.sqrt(6.0 / cols))
    return (rng.next_float(rows * cols) * 2.0 * s - s).astype(np.float32)


class MLP(Network):
    """Arbitrary-width MLP (any width/depth, including 0 hidden layers)."""

    otype = "CutlassMLP"

    def __init__(
        self,
        input_width: int,
        output_width: int,
        n_neurons: int = 128,
        n_hidden_layers: int = 5,
        activation: Activation = Activation.ReLU,
        output_activation: Activation = Activation.NONE,
        output_alignment: int = 16,
    ):
        super().__init__(input_width, output_width)
        self.width = int(n_neurons)
        self.n_hidden_layers = int(n_hidden_layers)
        self.activation = activation
        self.output_activation = output_activation
        self._padded_output_width = next_multiple(max(int(output_width), 1), output_alignment)

        # Matrix shapes (rows=fan_out, cols=fan_in), in flat-param order.
        shapes: List[Tuple[int, int]] = []
        if self.n_hidden_layers == 0:
            shapes.append((self._padded_output_width, self.input_width))
        else:
            shapes.append((self.width, self.input_width))
            for _ in range(self.n_hidden_layers - 1):
                shapes.append((self.width, self.width))
            shapes.append((self._padded_output_width, self.width))
        self._shapes = shapes
        self._offsets = np.cumsum([0] + [r * c for r, c in shapes]).tolist()

    @property
    def padded_output_width(self) -> int:
        return self._padded_output_width

    @property
    def n_params(self) -> int:
        return self._offsets[-1]

    def layer_sizes(self) -> List[Tuple[int, int]]:
        return list(self._shapes)

    def initialize_params(self, rng, scale: float = 1.0) -> np.ndarray:
        parts = []
        for i, (rows, cols) in enumerate(self._shapes):
            if self.activation == Activation.Sine:
                parts.append(siren_init(rng, rows, cols, scale, first=(i == 0)))
            else:
                parts.append(xavier_init(rng, rows, cols, scale))
        return np.concatenate(parts) if parts else np.zeros((0,), np.float32)

    def _weights(self, params: torch.Tensor) -> List[torch.Tensor]:
        """Row-major (fan_out, fan_in) views of the flat parameter slice."""
        return [
            params[off : off + rows * cols].view(rows, cols)
            for (rows, cols), off in zip(self._shapes, self._offsets)
        ]

    def hyperparams(self):
        return {
            "otype": self.otype,
            "activation": self.activation.value,
            "output_activation": self.output_activation.value,
            "n_neurons": self.width,
            "n_hidden_layers": self.n_hidden_layers,
        }

    def apply(self, params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        ws = [w.to(dt) for w in self._weights(params)]
        return ffmlp_forward_plain(x.to(dt), ws, self.activation, self.output_activation)
