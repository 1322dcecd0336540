"""Encoding factory and registry (port of ``tcnn_tpu.encodings``; reference:
src/encoding.cu:44-159). The grid family and Identity are ported; the
other encodings of the JAX package raise ``NotImplementedError`` until their
port lands."""

from __future__ import annotations

from typing import Callable, Dict, Optional

from ..common import CIDict, json_value
from .base import Encoding
from .basic import IdentityEncoding
from .grid import GridEncoding, create_grid_encoding

_ENCODING_FACTORIES: CIDict = CIDict()

# Encodings of the JAX package that the port does not have yet.
_NOT_PORTED = (
    "Composite", "Empty", "Frequency", "OneBlob",
    "SphericalHarmonics", "TriangleWave", "OneBlobFrequency", "NRC",
)


def register_encoding(name: str, factory: Callable[[int, Dict], Encoding]):
    if name in _ENCODING_FACTORIES:
        raise RuntimeError(f"Can not register encoding '{name}' twice.")
    _ENCODING_FACTORIES[name] = factory


for _name in ("Grid", "HashGrid", "TiledGrid", "DenseGrid"):
    register_encoding(_name, create_grid_encoding)
register_encoding(
    "Identity",
    lambda n, cfg: IdentityEncoding(n, json_value(cfg, "scale", 1.0), json_value(cfg, "offset", 0.0)),
)


def create_encoding(n_dims_to_encode: int, encoding: Optional[Dict] = None, alignment: int = 8) -> Encoding:
    """Factory (reference: src/encoding.cu:131-150; default otype OneBlob)."""
    encoding = encoding or {}
    name = json_value(encoding, "otype", "OneBlob")
    if name not in _ENCODING_FACTORIES:
        if name.lower() in (n.lower() for n in _NOT_PORTED):
            raise NotImplementedError(
                f"Encoding '{name}' is not ported yet (ROADMAP.md, Queue 1: other encodings and grid extras)"
            )
        raise ValueError(f"Encoding '{name}' not found")
    result = _ENCODING_FACTORIES[name](n_dims_to_encode, encoding)
    if alignment > 0:
        result.set_alignment(alignment)
    return result


def builtin_encodings():
    return sorted(_ENCODING_FACTORIES.keys())


__all__ = ["Encoding", "GridEncoding", "IdentityEncoding", "builtin_encodings", "create_encoding", "register_encoding"]
