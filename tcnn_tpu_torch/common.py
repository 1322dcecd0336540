"""Core enums, constants and helpers (PyTorch port of ``tcnn_tpu.common``).

The enums, parsers and config helpers are the same as the JAX package's so
that one JSON config drives both; ``as_dtype`` resolves to torch dtypes.
"""

from __future__ import annotations

import enum
import math
from typing import Dict, Mapping, Optional

import numpy as np
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


class ReductionType(str, enum.Enum):
    """Composite-encoding reduction (reference: common.h:178-182)."""

    Concatenation = "Concatenation"
    Sum = "Sum"
    Product = "Product"


class GradientMode(str, enum.Enum):
    """Parameter-gradient write mode (reference: object.h:116-120)."""

    Ignore = "Ignore"
    Overwrite = "Overwrite"
    Accumulate = "Accumulate"


PI = 3.14159265358979323846

# The JAX package's batch granularity (the TPU's 128-wide lanes; the
# reference pads to 256, common.h:246). A constant only: the port pads no
# batch to it.
BATCH_SIZE_GRANULARITY = 128

# Squareplus / Softplus sharpness (reference: common_device.h:108).
K_ACT = 10.0

# Maximum number of multi-resolution grid levels
# (reference: encodings/multi_level_interface.h:84-88).
MAX_N_LEVELS = 128

# Default compute precision of networks: bf16 operands with fp32
# accumulation, the numerics the JAX package is checked against.
default_network_precision = torch.bfloat16


def default_device() -> torch.device:
    """The device of the port's entry points when the caller names none:
    the CUDA card. Raises when there is none; the CPU is used only when the
    caller asks for it (``device="cpu"``)."""
    if not torch.cuda.is_available():
        raise RuntimeError('tcnn_tpu_torch: no CUDA device; pass device="cpu" to run on the CPU')
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means ``default_device()``."""
    return default_device() if device is None else torch.device(device)


def default_loss_scale(dtype) -> float:
    """Loss scale that keeps small gradients representable: 128 for the
    half types, 1 for fp32 (reference: common.h:240-244; the JAX package's
    ``default_loss_scale``). Every optimizer divides it back out."""
    if as_dtype(dtype) == torch.float32:
        return 1.0
    return 128.0


def div_round_up(val: int, divisor: int) -> int:
    return (val + divisor - 1) // divisor


def lcm_list(values) -> int:
    out = 1
    for v in values:
        out = math.lcm(out, int(v))
    return out


def next_multiple(val: int, divisor: int) -> int:
    return div_round_up(val, divisor) * divisor


def previous_multiple(val: int, divisor: int) -> int:
    return (val // divisor) * divisor


def is_pot(val: int) -> bool:
    return val > 0 and (val & (val - 1)) == 0


def next_pot(v: int) -> int:
    v = int(v) - 1
    for shift in (1, 2, 4, 8, 16):
        v |= v >> shift
    return v + 1


def powi(base: int, exp: int) -> int:
    return int(base) ** int(exp)


# Morton codes (reference: common_device.h:934-974): host-side helpers for
# spatially coherent sample ordering, on numpy uint64.


def _expand_bits_2d(w):
    w = w & np.uint64(0xFFFFFFFF)
    w = (w | (w << np.uint64(16))) & np.uint64(0x0000FFFF0000FFFF)
    w = (w | (w << np.uint64(8))) & np.uint64(0x00FF00FF00FF00FF)
    w = (w | (w << np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    w = (w | (w << np.uint64(2))) & np.uint64(0x3333333333333333)
    w = (w | (w << np.uint64(1))) & np.uint64(0x5555555555555555)
    return w


def _expand_bits_3d(w):
    w = w & np.uint64(0x1FFFFF)
    w = (w | (w << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    w = (w | (w << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    w = (w | (w << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    w = (w | (w << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    w = (w | (w << np.uint64(2))) & np.uint64(0x1249249249249249)
    return w


def morton2d(x, y):
    """Interleave the bits of (x, y) uint arrays (32 bits each) into 2D
    Morton codes, uint64."""
    x = np.asarray(x, np.uint64)
    y = np.asarray(y, np.uint64)
    return _expand_bits_2d(x) | (_expand_bits_2d(y) << np.uint64(1))


def morton3d(x, y, z):
    """Interleave the bits of (x, y, z) uint arrays into 3D Morton codes
    (uint64, up to 21 bits per axis)."""
    x = np.asarray(x, np.uint64)
    y = np.asarray(y, np.uint64)
    z = np.asarray(z, np.uint64)
    return _expand_bits_3d(x) | (_expand_bits_3d(y) << np.uint64(1)) | (_expand_bits_3d(z) << np.uint64(2))


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


def equals_case_insensitive(a: str, b: str) -> bool:
    return a.lower() == b.lower()


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
string_to_reduction_type = _make_enum_parser(ReductionType)


def to_string(value) -> str:
    """An enum member's value, else ``str(value)``."""
    if isinstance(value, enum.Enum):
        return value.value
    return str(value)


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


def check_throw(cond: bool, msg: str = "check failed"):
    if not cond:
        raise RuntimeError(msg)


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
