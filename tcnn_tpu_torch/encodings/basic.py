"""Parameterless encodings (port of ``tcnn_tpu.encodings.basic``). So far
Identity, which ``modules.Network`` builds on, and OneBlob, which the image
benchmark's config uses; the others stay in ROADMAP.md Queue 1 item 5."""

from __future__ import annotations

import numpy as np
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

    def hyperparams(self):
        return {"otype": self.otype, "scale": self.scale, "offset": self.offset}


def _quartic_cdf(x: torch.Tensor, inv_radius: float) -> torch.Tensor:
    """CDF of the quartic kernel (reference: common_device.h:1080-1095;
    tcnn_tpu/encodings/basic.py:_quartic_cdf)."""
    u = x * inv_radius
    u2 = u * u
    u4 = u2 * u2
    return torch.clamp((15.0 / 16.0) * u * (1.0 - (2.0 / 3.0) * u2 + (1.0 / 5.0) * u4) + 0.5, 0.0, 1.0)


class OneBlobEncoding(Encoding):
    """OneBlob with wraparound (reference: encodings/oneblob.h:47-127;
    tcnn_tpu/encodings/basic.py:127-165): per input dim, ``n_bins`` outputs,
    the integral of a quartic kernel centred at x over each bin [k/n,
    (k+1)/n), with the contributions of x - 1 and x + 1, so the encoding is
    periodic on [0, 1). Padded with 1.0. Elementwise fp32 torch,
    differentiable to any order."""

    otype = "OneBlob"
    pad_value = 1.0

    def __init__(self, n_bins: int, n_dims_to_encode: int):
        super().__init__(n_dims_to_encode)
        if n_bins <= 0 or (n_bins & (n_bins - 1)) != 0:
            raise ValueError("OneBlob: n_bins must be a power of two")
        self.n_bins = int(n_bins)
        self.n_output_dims = self.n_dims_to_encode * self.n_bins

    def hyperparams(self):
        return {"otype": self.otype, "n_bins": self.n_bins}

    def apply(self, params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        n = self.n_bins
        boundaries = torch.from_numpy(np.arange(n + 1) / n).to(device=x.device, dtype=torch.float32)
        # (B, D, n+1): the wrapped CDF at every bin boundary.
        arg = boundaries[None, None, :] - x[:, :, None]
        cdf = _quartic_cdf(arg, n) + _quartic_cdf(arg - 1.0, n) + _quartic_cdf(arg + 1.0, n)
        y = cdf[:, :, 1:] - cdf[:, :, :-1]
        return self._pad(y.reshape(x.shape[0], self.n_output_dims))
