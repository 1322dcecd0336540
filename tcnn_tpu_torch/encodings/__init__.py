"""Encoding factory and registry (port of ``tcnn_tpu.encodings``; reference:
src/encoding.cu:44-159): every encoding the JAX package registers. The
``NRC`` / ``OneBlobFrequency`` preset expands to the Composite of Neural
Radiance Caching (encoding.cu:93-115)."""

from __future__ import annotations

from typing import Callable, Dict, Optional

from ..common import CIDict, json_value
from .base import Encoding
from .basic import EmptyEncoding, FrequencyEncoding, IdentityEncoding, OneBlobEncoding, TriangleWaveEncoding
from .composite import CompositeEncoding
from .grid import GridEncoding, create_grid_encoding
from .spherical_harmonics import SphericalHarmonicsEncoding

_ENCODING_FACTORIES: CIDict = CIDict()


def register_encoding(name: str, factory: Callable[[int, Dict], Encoding]):
    if name in _ENCODING_FACTORIES:
        raise RuntimeError(f"Can not register encoding '{name}' twice.")
    _ENCODING_FACTORIES[name] = factory


def _nrc_factory(n_dims_to_encode: int, encoding: Dict) -> Encoding:
    """TriangleWave(3 dims) + OneBlob(5 dims) + Identity(the rest)
    (tcnn_tpu/encodings/__init__.py:36-56)."""
    return CompositeEncoding(
        {
            "otype": "Composite",
            "nested": [
                {"n_dims_to_encode": 3, "otype": "TriangleWave",
                 "n_frequencies": json_value(encoding, "n_frequencies", 12)},
                {"n_dims_to_encode": 5, "otype": "OneBlob", "n_bins": json_value(encoding, "n_bins", 4)},
                {"otype": "Identity"},
            ],
        },
        n_dims_to_encode,
    )


register_encoding("Composite", lambda n, cfg: CompositeEncoding(cfg, n))
register_encoding("Empty", lambda n, cfg: EmptyEncoding(n))
register_encoding("Frequency", lambda n, cfg: FrequencyEncoding(json_value(cfg, "n_frequencies", 12), n))
for _name in ("Grid", "HashGrid", "TiledGrid", "DenseGrid"):
    register_encoding(_name, create_grid_encoding)
register_encoding(
    "Identity",
    lambda n, cfg: IdentityEncoding(n, json_value(cfg, "scale", 1.0), json_value(cfg, "offset", 0.0)),
)
register_encoding("OneBlob", lambda n, cfg: OneBlobEncoding(json_value(cfg, "n_bins", 16), n))
register_encoding("SphericalHarmonics", lambda n, cfg: SphericalHarmonicsEncoding(json_value(cfg, "degree", 4), n))
register_encoding("TriangleWave", lambda n, cfg: TriangleWaveEncoding(json_value(cfg, "n_frequencies", 12), n))
register_encoding("OneBlobFrequency", _nrc_factory)
register_encoding("NRC", _nrc_factory)


def create_encoding(n_dims_to_encode: int, encoding: Optional[Dict] = None, alignment: int = 8) -> Encoding:
    """Factory (reference: src/encoding.cu:131-150; default otype OneBlob)."""
    encoding = encoding or {}
    name = json_value(encoding, "otype", "OneBlob")
    if name not in _ENCODING_FACTORIES:
        raise ValueError(f"Encoding '{name}' not found")
    result = _ENCODING_FACTORIES[name](n_dims_to_encode, encoding)
    if alignment > 0:
        result.set_alignment(alignment)
    return result


def builtin_encodings():
    return sorted(_ENCODING_FACTORIES.keys())


__all__ = [
    "CompositeEncoding", "EmptyEncoding", "Encoding", "FrequencyEncoding", "GridEncoding", "IdentityEncoding",
    "OneBlobEncoding", "SphericalHarmonicsEncoding", "TriangleWaveEncoding", "builtin_encodings", "create_encoding",
    "register_encoding",
]
