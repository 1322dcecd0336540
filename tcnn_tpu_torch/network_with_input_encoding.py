"""NetworkWithInputEncoding: encoding -> network composition (port of
``tcnn_tpu.network_with_input_encoding``; reference:
network_with_input_encoding.h).

The model holds all its parameters as ONE flat fp32 ``nn.Parameter`` in the
JAX package's layout, ``[network params | encoding params]``
(network_with_input_encoding.h:115-130); the network and the encoding read
views of it. The encoding's output is padded to the network's input
alignment (:46-53). The parameter lives on the CUDA card unless the
caller names another device (``device="cpu"``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .common import as_dtype, resolve_device
from .encodings import Encoding, create_encoding
from .networks import Network, create_network, minimum_alignment


class NetworkWithInputEncoding(nn.Module):
    def __init__(
        self,
        n_input_dims: int,
        n_output_dims: int,
        encoding_config: Optional[Dict] = None,
        network_config: Optional[Dict] = None,
        encoding: Optional[Encoding] = None,
        precision=None,
        device=None,
    ):
        super().__init__()
        self.n_input_dims = int(n_input_dims)
        self.n_output_dims = int(n_output_dims)
        self.compute_dtype = as_dtype(precision)

        if encoding is None:
            encoding = create_encoding(n_input_dims, encoding_config, alignment=minimum_alignment(network_config))
        else:
            encoding.set_alignment(minimum_alignment(network_config))
        self.encoding = encoding
        self.encoding.output_dtype = self.compute_dtype

        self.network: Network = create_network(self.encoding.padded_output_width, n_output_dims, network_config)
        self.network.compute_dtype = self.compute_dtype
        self.params = nn.Parameter(torch.zeros(self.n_params, dtype=torch.float32, device=resolve_device(device)))

    @property
    def input_width(self) -> int:
        return self.n_input_dims

    @property
    def padded_output_width(self) -> int:
        return self.network.padded_output_width

    @property
    def output_width(self) -> int:
        return self.padded_output_width

    @property
    def n_params(self) -> int:
        return self.network.n_params + self.encoding.n_params

    def layer_sizes(self) -> List[Tuple[int, int]]:
        # Network weight matrices are the "matrix params"; the encoding's
        # are not (adam.h:78-95).
        return self.network.layer_sizes()

    def initialize_params(self, rng, scale: float = 1.0) -> np.ndarray:
        return np.concatenate([self.network.initialize_params(rng, scale), self.encoding.initialize_params(rng, scale)])

    def _split(self, params: torch.Tensor):
        n_net = self.network.n_params
        return params[:n_net], params[n_net:]

    def apply(self, params: torch.Tensor, x: torch.Tensor, **encoding_kwargs) -> torch.Tensor:
        net_params, enc_params = self._split(params)
        encoded = self.encoding.apply(enc_params, x, **encoding_kwargs)
        return self.network.apply(net_params, encoded)

    def apply_plain(self, params: torch.Tensor, x: torch.Tensor, **encoding_kwargs) -> torch.Tensor:
        """``apply`` through every kernel's plain torch version, on any
        device (the reference the kernel path is checked against)."""
        net_params, enc_params = self._split(params)
        return self.network.apply_plain(net_params, self.encoding.apply_plain(enc_params, x, **encoding_kwargs))

    def apply_raster(self, params: torch.Tensor, side, rows=None, **encoding_kwargs) -> torch.Tensor:
        """Forward over the tile-center raster of ``side`` (int or per-dim
        tuple), built on the device of ``params``; ``rows`` = (start, stop):
        only those rows of it."""
        net_params, enc_params = self._split(params)
        if rows is not None:
            encoding_kwargs["rows"] = rows
        encoded = self.encoding.apply_raster(enc_params, side, **encoding_kwargs)
        return self.network.apply(net_params, encoded)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(self.params, x)

    def input_gradient(self, params: torch.Tensor, x: torch.Tensor, output_index: int) -> torch.Tensor:
        """d output[:, output_index] / d x, (batch, n_input_dims) in x's
        dtype: the backward of a one-hot output gradient (reference:
        object.h:592-616; tcnn_tpu/network_with_input_encoding.py:116-122),
        through the grid's input-gradient kernel on the card; ``params``
        is read detached, so no parameter gradient is computed."""
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            out = self.apply(params.detach(), x)
            onehot = torch.zeros_like(out)
            onehot[:, output_index] = 1
            (dx,) = torch.autograd.grad(out, x, onehot)
        return dx

    # Config surface (tcnn_tpu/network_with_input_encoding.py:125-133).
    def update_hyperparams(self, params):
        self.encoding.update_hyperparams(params.get("encoding", {}))
        self.network.update_hyperparams(params.get("network", {}))

    def hyperparams(self):
        return {
            "otype": "NetworkWithInputEncoding",
            "encoding": self.encoding.hyperparams(),
            "network": self.network.hyperparams(),
        }
