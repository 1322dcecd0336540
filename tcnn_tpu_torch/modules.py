"""The module API: tiny-cuda-nn's torch classes as native ``torch.nn``
modules (reference: bindings/torch/tinycudann/modules.py).

Ports both ``tcnn_tpu.modules`` (the stateful wrappers over flat params) and
``tcnn_tpu.torch_modules`` (the JAX bridge that torch users of the JAX
package program against). Each module owns one flat fp32 ``params``
``nn.Parameter`` in the JAX package's layout, initialised from ``seed`` by
the same PCG32 draws, so a seed gives bit-identical parameters in both
packages. ``forward(x)`` returns fp32 ``(B, n_output_dims)`` like the bridge
and is differentiable twice, with respect to ``params`` and ``x``: the grid's
input-gradient and double-backward kernels (``ops.grid_encode``), and
FullyFusedMLP's second order through the differentiable chain, as in the
JAX package. ``apply(params, x)`` returns the padded output width like
``tcnn_tpu.modules.Module.apply``. Bring any torch optimizer:
``torch.optim.Adam(module.parameters())``.

``forward`` makes the choices that the JAX modules make from the batch
(the grid's own ``table_dtype`` rounding, its table gradient's classes and
stratified tiles) for the batch padded to ``BATCH_SIZE_GRANULARITY``, as
``tcnn_tpu.modules.Module.__call__`` pads it, but runs the kernels on the
call's own samples (``encodings.grid.padded_batches``): no padding rows are
copied or computed, and they would change no sample's outputs or
gradients. So every sample's outputs and gradients are those of the JAX
modules' call, except where the JAX package's padded batch breaks its
stratified raster-tile contract and turns to NaN: there the port computes
each sample and stays finite. ``apply``, like the JAX modules' ``apply``,
decides on the batch as it is. Modules live on the CUDA card unless
``device`` names another.
"""

from __future__ import annotations

import warnings
from typing import Dict

import numpy as np
import torch
from torch import nn

from .common import BATCH_SIZE_GRANULARITY, resolve_device
from .encodings import create_encoding
from .encodings.grid import padded_batches
from .network_with_input_encoding import NetworkWithInputEncoding as _NWIE
from .rng import make_rng


class Module(nn.Module):
    """Shared part: the flat fp32 ``params`` and the fp32 torch surface."""

    def __init__(self, seed: int = 1337):
        super().__init__()
        self.seed = int(seed)

    def _initial_params(self, initializer, device) -> torch.Tensor:
        init = np.asarray(initializer(make_rng(self.seed)), np.float32)
        return torch.from_numpy(init).to(device)

    @property
    def n_params(self) -> int:
        return self.params.numel()

    def apply(self, params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """(params, (B, n_input_dims)) -> (B, padded width)."""
        raise NotImplementedError

    def apply_plain(self, params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """``apply`` through every kernel's plain torch version, on any
        device (the reference the kernel path is checked against)."""
        raise NotImplementedError

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.n_input_dims:
            raise ValueError(f"input has {x.shape[-1]} dims, module expects {self.n_input_dims}")
        # uint32 positions (a fixed_point_pos grid) pass as they are, as in
        # the JAX package.
        x = x if x.dtype == torch.uint32 else x.float()
        with padded_batches(BATCH_SIZE_GRANULARITY):
            y = self.apply(self.params, x)
        return y[:, : self.n_output_dims].float()

    def extra_repr(self) -> str:
        return f"n_input_dims={self.n_input_dims}, n_output_dims={self.n_output_dims}, n_params={self.n_params}"


class NetworkWithInputEncoding(Module):
    """(reference: modules.py:262-315; tcnn_tpu/modules.py:76-107)"""

    def __init__(
        self,
        n_input_dims: int,
        n_output_dims: int,
        encoding_config: Dict,
        network_config: Dict,
        seed: int = 1337,
        precision=None,
        device=None,
    ):
        super().__init__(seed)
        self.n_input_dims = int(n_input_dims)
        self.n_output_dims = int(n_output_dims)
        self.encoding_config = encoding_config
        self.network_config = network_config
        self._model = _NWIE(
            n_input_dims, n_output_dims, encoding_config=encoding_config, network_config=network_config,
            precision=precision, device=resolve_device(device),
        )
        with torch.no_grad():
            self._model.params.copy_(self._initial_params(self._model.initialize_params, self._model.params.device))
        # One Parameter, shared with the composition that reads it.
        self.params = self._model.params

    @property
    def padded_output_width(self) -> int:
        return self._model.padded_output_width

    def apply(self, params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return self._model.apply(params, x)

    def apply_plain(self, params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return self._model.apply_plain(params, x)


class Network(NetworkWithInputEncoding):
    """Network without an encoding (reference: modules.py:317-349; the C++
    side, and the JAX package, realise it as Identity encoding + network,
    cpp_api.cu:160-162, tcnn_tpu/modules.py:110-140)."""

    def __init__(
        self,
        n_input_dims: int,
        n_output_dims: int,
        network_config: Dict,
        seed: int = 1337,
        precision=None,
        device=None,
    ):
        super().__init__(
            n_input_dims, n_output_dims, {"otype": "Identity"}, network_config, seed=seed, precision=precision,
            device=device,
        )


class Encoding(Module):
    """Standalone encoding (reference: modules.py:351-382;
    tcnn_tpu/modules.py:143-167): no output alignment, fp32 outputs;
    ``n_output_dims`` is the encoding's output width. ``dtype`` is accepted
    for parity and, like the JAX bridge, only fp32 is kept."""

    def __init__(
        self,
        n_input_dims: int,
        encoding_config: Dict,
        seed: int = 1337,
        dtype=None,
        device=None,
    ):
        super().__init__(seed)
        if dtype is not None and dtype != torch.float32:
            warnings.warn(
                f"tcnn_tpu_torch.modules.Encoding ignores dtype={dtype}: outputs are always float32 "
                "(table precision is the encoding's table_dtype)"
            )
        self.n_input_dims = int(n_input_dims)
        self.encoding_config = encoding_config
        self._encoding = create_encoding(n_input_dims, encoding_config, alignment=1)
        self._encoding.output_dtype = torch.float32
        self.n_output_dims = self._encoding.padded_output_width
        self.params = nn.Parameter(self._initial_params(self._encoding.initialize_params, resolve_device(device)))

    def apply(self, params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return self._encoding.apply(params, x)

    def apply_plain(self, params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return self._encoding.apply_plain(params, x)


def free_temporary_memory() -> None:
    """Releases the blocks PyTorch's CUDA allocator caches (the kernels
    allocate through it and keep no arena of their own; reference:
    tinycudann.free_temporary_memory). Nothing to do without a card."""
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


__all__ = ["Encoding", "Module", "Network", "NetworkWithInputEncoding", "free_temporary_memory"]
