"""Encoding protocol (port of ``tcnn_tpu.encodings.base``).

An encoding is an ``nn.Module`` with no parameters of its own: ``apply(params,
x)`` encodes (batch, n_dims_to_encode) positions with a slice of the model's
flat parameter vector. Layout is batch-leading row-major ``(batch, dim)``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
from torch import nn

from ..common import default_network_precision, next_multiple
from ..utils.log import log_info
from ..utils.sampling import raster_centers_torch

# The (call, argument) pairs already logged by ignore_tpu_arguments.
_IGNORED_LOGGED: set = set()


def ignore_tpu_arguments(where: str, **arguments) -> None:
    """Log once per call site and name that an argument of the JAX
    package's signature that picks a TPU path of the same function (a
    prebuilt serving table, a raster hint) was given and is ignored, as the
    TPU execution-strategy keys of a config are."""
    for name, value in arguments.items():
        if value is not None and (where, name) not in _IGNORED_LOGGED:
            _IGNORED_LOGGED.add((where, name))
            log_info(f"{where}: the TPU path argument {name!r} is ignored by the port (the same function)")


class Encoding(nn.Module):
    """Base encoding.

    Attributes:
      n_dims_to_encode: input width consumed.
      n_output_dims: natural (unpadded) output width.
      n_to_pad: extra output columns appended (or, for SphericalHarmonics,
        prepended) so the output width matches the network's required input
        alignment.
      pad_value: value written into padding columns.
      output_dtype: dtype of the encoded output fed to the network.
    """

    otype = "Encoding"
    pad_value = 1.0

    def __init__(self, n_dims_to_encode: int):
        super().__init__()
        self.n_dims_to_encode = int(n_dims_to_encode)
        self.n_output_dims = 0
        self.n_to_pad = 0
        self.output_dtype = default_network_precision
        # Constant tensors of elementwise encodings, by device (basic._cached).
        self._consts = {}

    @property
    def input_width(self) -> int:
        return self.n_dims_to_encode

    @property
    def output_width(self) -> int:
        return self.padded_output_width

    @property
    def padded_output_width(self) -> int:
        return self.n_output_dims + self.n_to_pad

    def set_padded_output_width(self, padded_output_width: int):
        if padded_output_width < self.n_output_dims:
            raise ValueError(
                f"{self.otype}: padded output width {padded_output_width} < natural width {self.n_output_dims}"
            )
        self.n_to_pad = padded_output_width - self.n_output_dims

    def required_output_alignment(self) -> int:
        return 1

    def set_alignment(self, alignment: int):
        self.set_padded_output_width(next_multiple(self.padded_output_width, alignment))

    @property
    def n_params(self) -> int:
        return 0

    def layer_sizes(self) -> List[Tuple[int, int]]:
        """Encodings report no weight matrices: their params are non-matrix
        params for the optimizer (reference: grid.h:1101-1105)."""
        return []

    def initialize_params(self, rng, scale: float = 1.0) -> np.ndarray:
        return np.zeros((0,), dtype=np.float32)

    def apply(self, params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Encode ``x`` (batch, n_dims_to_encode) to (batch,
        padded_output_width) in ``output_dtype``."""
        raise NotImplementedError

    def apply_plain(self, params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """``apply`` through plain torch versions only, on any device; the
        same as ``apply`` for encodings without kernels."""
        return self.apply(params, x)

    def apply_raster(self, params: torch.Tensor, side, rows=None, **kwargs) -> torch.Tensor:
        """Encode the tile-centre raster (``utils.sampling.raster_centers``
        layout: sample ``j`` at the centre of raster tile ``j``, dim 0
        fastest; ``side`` an int or a per-dim tuple), built on the device of
        ``params``; ``rows`` = (start, stop): only those rows of it.
        Encodings with a raster fast path override this
        (``GridEncoding.apply_raster``); the default builds the positions and
        applies normally (tcnn_tpu/encodings/base.py:106-118)."""
        x = raster_centers_torch(side, self.n_dims_to_encode, params.device, rows)
        return self.apply(params, x, **kwargs)

    def forward(self, params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return self.apply(params, x)

    # Config surface (reference: object.h:50-55).
    def update_hyperparams(self, params):
        pass

    def hyperparams(self):
        return {"otype": self.otype}

    @property
    def name(self) -> str:
        return type(self).__name__

    def _pad(self, y: torch.Tensor) -> torch.Tensor:
        """Append padding columns and cast to the output dtype."""
        if self.n_to_pad > 0:
            pad = torch.full((y.shape[0], self.n_to_pad), self.pad_value, dtype=y.dtype, device=y.device)
            y = torch.cat([y, pad], dim=1)
        return y.to(self.output_dtype)
