"""FullyFusedMLP — the flagship network, backed by the fused CUDA kernel.

(reference: networks/fully_fused_mlp.h; JAX counterpart
``tcnn_tpu.networks.fully_fused``). Widths are {16, 32, 64, 128} like the
reference; parameter layout, init and JSON surface are those of ``MLP``.
On the card ``apply`` always runs the fused kernels (``ops.ffmlp``: the
forward, and the backward through ``FfmlpFunction``); on the CPU the
kernels' wrappers compute their plain versions. ``apply_plain`` takes the
plain versions on every device. ``use_kernel=False`` selects the chain,
differentiated by torch autograd, on every device. ``apply_packed`` is the
packed-I/O path of narrow-uniform MLPs (``ops.ffmlp`` K7/K8). A backward
that must itself be differentiable (second order) runs through the chain on
every path, as in the JAX package (``ops.ffmlp._chain_backward``).
"""

from __future__ import annotations

import torch

from ..common import Activation
from ..ops.ffmlp import FFMLP_WIDTHS, FfmlpFunction, FfmlpPackedFunction
from .mlp import MLP


class FullyFusedMLP(MLP):
    otype = "FullyFusedMLP"

    def __init__(
        self,
        input_width: int,
        output_width: int,
        n_neurons: int = 64,
        n_hidden_layers: int = 5,
        activation: Activation = Activation.ReLU,
        output_activation: Activation = Activation.NONE,
        output_alignment: int = 16,
        use_kernel: bool = True,
    ):
        if n_neurons not in FFMLP_WIDTHS:
            raise ValueError(f"FullyFusedMLP only supports widths {FFMLP_WIDTHS}, got {n_neurons}")
        if input_width % 16 != 0:
            raise ValueError(f"FullyFusedMLP requires input width aligned to 16, got {input_width}")
        super().__init__(
            input_width=input_width,
            output_width=output_width,
            n_neurons=n_neurons,
            n_hidden_layers=n_hidden_layers,
            activation=activation,
            output_activation=output_activation,
            output_alignment=output_alignment,
        )
        self.use_kernel = bool(use_kernel)

    def apply(self, params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        if not self.use_kernel:
            return super().apply(params, x)
        return self._fused(params, x, plain=False)

    def apply_plain(self, params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """``apply`` through the kernels' plain versions, on any device (the
        reference the kernels are checked against)."""
        if not self.use_kernel:
            return super().apply(params, x)
        return self._fused(params, x, plain=True)

    def _cast_weights(self, params):
        """The layers as views of one cast of the network's parameter slice:
        consecutive in one buffer, which the kernels take as it is."""
        return self._weights(params[: self.n_params].to(self.compute_dtype))

    def _fused(self, params, x, plain: bool):
        ws = self._cast_weights(params)
        return FfmlpFunction.apply(x.to(self.compute_dtype).contiguous(), self.activation, self.output_activation,
                                   plain, *ws)

    def apply_packed(self, params: torch.Tensor, x_packed: torch.Tensor) -> torch.Tensor:
        """Packed-I/O path (tcnn_tpu/networks/fully_fused.py:apply_packed):
        ``x_packed`` is (batch/G, 128) with G = 128/input_width samples per
        row, the compact row-major (batch, input_width) batch reshaped.
        Returns (batch/G, G*padded_output_width); reshape to (batch,
        padded_output_width) to unpack. Needs a narrow-uniform MLP
        (n_neurons == input_width < 128), else ValueError. Differentiable
        (K7 forward, K8 backward)."""
        return self._packed(params, x_packed, plain=False)

    def apply_packed_plain(self, params: torch.Tensor, x_packed: torch.Tensor) -> torch.Tensor:
        """``apply_packed`` through the block-diagonal plain versions, on any
        device."""
        return self._packed(params, x_packed, plain=True)

    def _packed(self, params, x_packed, plain: bool):
        ws = self._cast_weights(params)
        return FfmlpPackedFunction.apply(
            x_packed.to(self.compute_dtype).contiguous(), self.activation, self.output_activation, plain, *ws
        )
