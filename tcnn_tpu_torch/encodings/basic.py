"""Parameterless encodings (port of ``tcnn_tpu.encodings.basic``): Identity,
Empty, Frequency, TriangleWave and OneBlob. The JAX package computes them in
XLA, outside any kernel; here they are elementwise fp32 torch,
differentiable to any order."""

from __future__ import annotations

import numpy as np
import torch

from .base import Encoding

PI = 3.14159265358979323846


def _cached(enc, device, make) -> tuple:
    """The encoding's constant tensors on ``device``, made once per device,
    so that a captured CUDA graph (``Trainer.training_steps``) copies
    nothing from the host: the warm-up step fills the cache."""
    key = (device.type, device.index)
    hit = enc._consts.get(key)
    if hit is None:
        hit = enc._consts[key] = tuple(torch.from_numpy(a).to(device) for a in make())
    return hit


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


class EmptyEncoding(Encoding):
    """Swallows its inputs and emits only padding (reference:
    encodings/empty.h:46-92; tcnn_tpu/encodings/basic.py:35-49). The
    gradient with respect to x is zero: x is unused."""

    otype = "Empty"
    pad_value = 1.0

    def __init__(self, n_dims_to_encode: int):
        super().__init__(n_dims_to_encode)
        self.n_output_dims = 0

    def apply(self, params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return self._pad(torch.zeros((x.shape[0], 0), dtype=torch.float32, device=x.device))


class FrequencyEncoding(Encoding):
    """NeRF's sin/cos frequency encoding (reference: encodings/frequency.h:
    46-103; tcnn_tpu/encodings/basic.py:52-86): per input dim d and
    frequency k, ``sin(2^k pi x_d)`` and ``cos(2^k pi x_d)``, the cosine as
    a pi/2 phase shift, in the order [d0k0 sin, d0k0 cos, d0k1 sin, ...]."""

    otype = "Frequency"
    pad_value = 1.0

    def __init__(self, n_frequencies: int, n_dims_to_encode: int):
        super().__init__(n_dims_to_encode)
        self.n_frequencies = int(n_frequencies)
        self.n_output_dims = self.n_dims_to_encode * self.n_frequencies * 2

    def apply(self, params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        (freq_scale,) = _cached(self, x.device, lambda: (2.0 ** np.arange(self.n_frequencies, dtype=np.float32),))
        scaled = x[:, :, None] * freq_scale[None, None, :] * PI  # (B, D, F)
        phased = torch.stack([torch.sin(scaled), torch.sin(scaled + PI / 2)], dim=-1)  # (B, D, F, [sin, cos])
        return self._pad(phased.reshape(x.shape[0], self.n_output_dims))

    def hyperparams(self):
        return {"otype": self.otype, "n_frequencies": self.n_frequencies}


class TriangleWaveEncoding(Encoding):
    """The triangle-wave counterpart of Frequency that NRC uses (reference:
    encodings/triangle_wave.h:46-81; tcnn_tpu/encodings/basic.py:89-124):
    per dim d and frequency k, ``tri(x_d 2^(k-1) + k/4)`` with
    ``tri(v) = |v - floor(v) - 0.5| * 4 - 1``."""

    otype = "TriangleWave"
    pad_value = 1.0

    def __init__(self, n_frequencies: int, n_dims_to_encode: int):
        super().__init__(n_dims_to_encode)
        self.n_frequencies = int(n_frequencies)
        self.n_output_dims = self.n_dims_to_encode * self.n_frequencies

    def apply(self, params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        ks = np.arange(self.n_frequencies)
        freq_scale, phase = _cached(
            self, x.device, lambda: ((2.0 ** (ks - 1.0)).astype(np.float32), (ks * 0.25).astype(np.float32))
        )
        val = x[:, :, None] * freq_scale[None, None, :] + phase[None, None, :]
        result = torch.abs(val - torch.floor(val) - 0.5) * 4.0 - 1.0
        return self._pad(result.reshape(x.shape[0], self.n_output_dims))

    def hyperparams(self):
        return {"otype": self.otype, "n_frequencies": self.n_frequencies}


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
        (boundaries,) = _cached(self, x.device, lambda: ((np.arange(n + 1) / n).astype(np.float32),))
        # (B, D, n+1): the wrapped CDF at every bin boundary.
        arg = boundaries[None, None, :] - x[:, :, None]
        cdf = _quartic_cdf(arg, n) + _quartic_cdf(arg - 1.0, n) + _quartic_cdf(arg + 1.0, n)
        y = cdf[:, :, 1:] - cdf[:, :, :-1]
        return self._pad(y.reshape(x.shape[0], self.n_output_dims))
