"""Core enums, constants and helpers (PyTorch port of ``tcnn_tpu.common``).

The enums, parsers and config helpers are the same as the JAX package's so
that one JSON config drives both; ``as_dtype`` resolves to torch dtypes.
"""

from __future__ import annotations

import enum
from typing import Dict, Mapping, Optional

import torch


class Activation(str, enum.Enum):
    """Activation functions (reference: common.h:133-144)."""

    ReLU = "ReLU"
    LeakyReLU = "LeakyReLU"
    SiLU = "SiLU"
    Exponential = "Exponential"
    Sine = "Sine"
    Sigmoid = "Sigmoid"
    Squareplus = "Squareplus"
    Softplus = "Softplus"
    Tanh = "Tanh"
    NONE = "None"


class GridType(str, enum.Enum):
    """Grid encoding storage types (reference: common.h:146-150)."""

    Hash = "Hash"
    Dense = "Dense"
    Tiled = "Tiled"


class HashType(str, enum.Enum):
    """Spatial hash families (reference: common.h:152-158), plus
    ``CoherentAdditive``: ``idx = sum_d pos_d * f_d`` (uint32 wrap) with
    ``f_0 = 1``, whose corner indices are affine in the corner bits."""

    Prime = "Prime"
    CoherentPrime = "CoherentPrime"
    ReversedPrime = "ReversedPrime"
    Rng = "Rng"
    BaseConvert = "BaseConvert"
    CoherentAdditive = "CoherentAdditive"


class InterpolationType(str, enum.Enum):
    """Grid interpolation (reference: common.h:160-164)."""

    Nearest = "Nearest"
    Linear = "Linear"
    Smoothstep = "Smoothstep"


# Squareplus / Softplus sharpness (reference: common_device.h:108).
K_ACT = 10.0

# Maximum number of multi-resolution grid levels
# (reference: encodings/multi_level_interface.h:84-88).
MAX_N_LEVELS = 128

# Default compute precision of networks: bf16 operands with fp32
# accumulation, the numerics the JAX package is checked against.
default_network_precision = torch.bfloat16


def default_loss_scale(dtype) -> float:
    """Loss scale that keeps small gradients representable: 128 for the
    half types, 1 for fp32 (reference: common.h:240-244; the JAX package's
    ``default_loss_scale``). Every optimizer divides it back out."""
    if as_dtype(dtype) == torch.float32:
        return 1.0
    return 128.0


def div_round_up(val: int, divisor: int) -> int:
    return (val + divisor - 1) // divisor


def next_multiple(val: int, divisor: int) -> int:
    return div_round_up(val, divisor) * divisor


class CIDict(dict):
    """Case-insensitive string-keyed dict (reference: common_host.h:316-320)."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        self._canon: Dict[str, str] = {}
        if args:
            for k, v in dict(args[0]).items():
                self[k] = v
        for k, v in kwargs.items():
            self[k] = v

    def _k(self, key: str) -> str:
        return self._canon.get(key.lower(), key)

    def __setitem__(self, key, value):
        existing = self._canon.get(key.lower())
        if existing is not None:
            key = existing
        else:
            self._canon[key.lower()] = key
        super().__setitem__(key, value)

    def __getitem__(self, key):
        return super().__getitem__(self._k(key))

    def __contains__(self, key):
        return super().__contains__(self._k(key))

    def get(self, key, default=None):
        return super().get(self._k(key), default)


def _make_enum_parser(enum_cls):
    table = CIDict({m.value: m for m in enum_cls})
    name = enum_cls.__name__

    def parse(value):
        if isinstance(value, enum_cls):
            return value
        if value in table:
            return table[value]
        raise ValueError(f"Invalid {name}: {value!r}")

    return parse


string_to_activation = _make_enum_parser(Activation)
string_to_grid_type = _make_enum_parser(GridType)
string_to_hash_type = _make_enum_parser(HashType)
string_to_interpolation_type = _make_enum_parser(InterpolationType)


def json_value(config: Optional[Mapping], key: str, default):
    """Case-insensitive ``json.value(key, default)`` analogue."""
    if not config:
        return default
    if key in config:
        return config[key]
    lower = key.lower()
    for k, v in config.items():
        if isinstance(k, str) and k.lower() == lower:
            return v
    return default


_PRECISIONS = CIDict({
    "bf16": torch.bfloat16,
    "bfloat16": torch.bfloat16,
    "f32": torch.float32,
    "fp32": torch.float32,
    "float32": torch.float32,
    "float": torch.float32,
    "f16": torch.float16,
    "fp16": torch.float16,
    "half": torch.float16,
    "float16": torch.float16,
})


def as_dtype(precision) -> torch.dtype:
    """Resolve a config 'precision' entry to a torch dtype."""
    if precision is None:
        return default_network_precision
    if isinstance(precision, torch.dtype):
        return precision
    if isinstance(precision, str):
        if precision in _PRECISIONS:
            return _PRECISIONS[precision]
        raise ValueError(f"Unknown precision: {precision}")
    raise ValueError(f"Unknown precision: {precision!r}")
