"""Spherical-harmonics direction encoding (port of
``tcnn_tpu.encodings.spherical_harmonics``; reference:
encodings/spherical_harmonics.h).

The real SH basis of degree 1-8, with the Condon-Shortley sign the
reference bakes in, evaluated from the JAX package's recurrences
(``sh_enc``, the plain version in ``ops.sh_encode``). Inputs in [0, 1]^3 are
remapped to [-1, 1]^3. The padding columns come BEFORE the SH values, as
the reference writes them (spherical_harmonics.h:53-63). On the card
``apply`` launches the SH kernel (``csrc/sh_encode.cu``) and its input
gradient; on the CPU it runs the plain version.
"""

from __future__ import annotations

import torch

from ..ops.sh_encode import MAX_DEGREE, ShEncodeFunction, sh_enc
from .base import Encoding


class SphericalHarmonicsEncoding(Encoding):
    """(tcnn_tpu/encodings/spherical_harmonics.py:91-121)"""

    otype = "SphericalHarmonics"
    pad_value = 1.0

    def __init__(self, degree: int, n_dims_to_encode: int):
        super().__init__(n_dims_to_encode)
        if n_dims_to_encode != 3:
            raise ValueError("SphericalHarmonics requires 3 input dims")
        if degree < 1 or degree > MAX_DEGREE:
            raise ValueError(f"SphericalHarmonics degree must be in [1, {MAX_DEGREE}]")
        self.degree = int(degree)
        self.n_output_dims = self.degree * self.degree

    def _encode(self, x: torch.Tensor, plain: bool) -> torch.Tensor:
        return ShEncodeFunction.apply(x.to(torch.float32), self.degree, self.n_to_pad, self.pad_value,
                                      self.output_dtype, plain)

    def apply(self, params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return self._encode(x, plain=False)

    def apply_plain(self, params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return self._encode(x, plain=True)

    def hyperparams(self):
        return {"otype": self.otype, "degree": self.degree}


__all__ = ["SphericalHarmonicsEncoding", "sh_enc"]
