"""FullyFusedMLP — the flagship network, backed by the fused CUDA kernel.

(reference: networks/fully_fused_mlp.h; JAX counterpart
``tcnn_tpu.networks.fully_fused``). Widths are {16, 32, 64, 128} like the
reference; parameter layout, init and JSON surface are those of ``MLP``.
On the card ``apply`` always runs the fused kernels (``ops.ffmlp``: the
forward, and the backward through ``FfmlpFunction``); on the CPU the
kernels' wrappers compute their plain versions. ``apply_plain`` takes the
plain versions on every device. ``use_kernel=False`` selects the chain,
differentiated by torch autograd, on every device.
"""

from __future__ import annotations

import torch

from ..common import Activation
from ..ops.ffmlp import FFMLP_WIDTHS, FfmlpFunction
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

    def _fused(self, params, x, plain: bool):
        dt = self.compute_dtype
        ws = [w.to(dt) for w in self._weights(params)]
        return FfmlpFunction.apply(x.to(dt).contiguous(), self.activation, self.output_activation, plain, *ws)
