"""Network protocol (port of ``tcnn_tpu.networks.base``).

A network is an ``nn.Module`` with no parameters of its own: ``apply(params,
x)`` reads its weights from a slice of the model's flat parameter vector,
which ``NetworkWithInputEncoding`` holds as one ``nn.Parameter``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
from torch import nn

from ..common import default_network_precision


class Network(nn.Module):
    otype = "Network"

    def __init__(self, input_width: int, output_width: int):
        super().__init__()
        self.input_width = int(input_width)
        self.output_width = int(output_width)
        self.compute_dtype = default_network_precision

    @property
    def padded_output_width(self) -> int:
        raise NotImplementedError

    @property
    def n_params(self) -> int:
        raise NotImplementedError

    def layer_sizes(self) -> List[Tuple[int, int]]:
        raise NotImplementedError

    def initialize_params(self, rng, scale: float = 1.0) -> np.ndarray:
        raise NotImplementedError

    def apply(self, params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """(batch, input_width) -> (batch, padded_output_width)."""
        raise NotImplementedError

    def apply_plain(self, params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """``apply`` through plain torch versions only, on any device; the
        same as ``apply`` for networks without kernels."""
        return self.apply(params, x)

    def forward(self, params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return self.apply(params, x)

    # Config surface (reference: object.h:50-55).
    def update_hyperparams(self, params):
        pass

    def hyperparams(self):
        return {"otype": self.otype}
