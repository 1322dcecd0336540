"""Multiresolution grid encoding (port of ``tcnn_tpu.encodings.grid``).

Parameter layout parity: one flat vector of ``offset_table[n_levels] *
n_features_per_level`` floats; level ``l`` owns rows
``offset_table[l]:offset_table[l+1]`` of the ``(n_vertices, F)`` table
(reference: grid.h:673-737).

Everything that changes the function computed is reproduced exactly: the
hash type (``"auto"`` -> CoherentAdditive; ``"Rng"`` through
``ops.pcg32_jump``), uint32 positions under ``fixed_point_pos``, the
one-corner table gradient of ``stochastic_interpolation`` when ``apply`` is
given ``rng`` (as the JAX package's, which its trainer never gives it), the
raster strides that
``gather_strategy: "stratified"`` gives coarse levels (``raster_max_scale``),
the phase-locked scale snapping, the interpolation, ``table_dtype`` rounding
on read on exactly the levels the JAX package reads through a rounding
gather (``rounded_levels``), the serve-time ``table_dtype`` of
``FrozenServer`` on exactly the levels the JAX package serves from its
prebuilt quad tables (``served_levels``), and in training the rounding class of each level's table gradient
(``gradient_classes``), which ``scatter_strategy``, ``locked_rounding``,
``gather_strategy``, ``phase_locked`` and the batch select in the JAX
package. Its other TPU execution strategies (quad tables, packed layouts,
level splits) are accepted as config keys, validated as the JAX package
validates them, and ignored: they change how the TPU computes, not what. Per level, all of this is compiled into one row of
the level table (``ops.grid_encode.level_table``) and one row of the class
table that the kernels and their plain versions read.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from ..common import (
    MAX_N_LEVELS,
    GridType,
    HashType,
    InterpolationType,
    json_value,
    next_multiple,
    string_to_grid_type,
    string_to_hash_type,
    string_to_interpolation_type,
)
from ..ops import grid_encode as ge
from ..ops import scatter_rows as sr
from ..utils.log import log_info
from ..utils.sampling import raster_centers_torch
from .base import Encoding

# Hash factors (reference: common_device.h:782-795).
_PRIME_FACTORS = (1958374283, 2654435761, 805459861, 3674653429, 2097192037, 1434869437, 2165219737)
_COHERENT_PRIME_FACTORS = (1,) + _PRIME_FACTORS[1:]
_REVERSED_PRIME_FACTORS = tuple(reversed(_PRIME_FACTORS))

# Max grid resolution per n_dims that avoids uint32 overflow of the dense
# index (reference: common_device.h:855-870).
_MAX_BASES = [0x0, 0xFFFFFFFF, 0xFFFF, 0x659, 0xFF, 0x54, 0x28, 0x17, 0xF, 0xB, 0x9]

_INTERP_CODES = {
    InterpolationType.Nearest: ge.INTERP_NEAREST,
    InterpolationType.Linear: ge.INTERP_LINEAR,
    InterpolationType.Smoothstep: ge.INTERP_SMOOTHSTEP,
}
_ROUND_CODES = {"float32": ge.ROUND_NONE, "float16": ge.ROUND_FP16, "bfloat16": ge.ROUND_BF16}

# JAX-package execution-strategy keys: accepted, logged, ignored. Those the
# JAX package validates are validated here with its sets of values
# (tcnn_tpu/encodings/grid.py:2292-2296, and 2325-2347 under "stratified").
TPU_STRATEGY_KEYS = (
    "quad_build", "level_split", "strat_accum", "locked_fwd", "index_mode", "onehot_threshold",
)
_QUAD_BUILDS = ("auto", "view", "flat", "slice", "cf")
_LEVEL_SPLITS = ("auto", "off", "barrier")
_STRAT_ACCUMS = ("auto", "select_n", "where")
_LOCKED_FWDS = ("unpacked", "packed", "csr")

# Table-gradient rounding class (contribution rounding, accumulation) of each
# JAX scatter mode (tcnn_tpu/encodings/grid.py:_scatter_mode and the
# scatters of tcnn_tpu/ops/scatter_rows.py). The JAX pair class (a
# compensated bf16 pair, fp32 to about 3e-6 relative) is the fp32 class.
GRAD_F32 = (sr.CONTRIB_NONE, sr.ACC_F32)
_MODE_CLASSES = {
    **{m: GRAD_F32 for m in (
        "xla", "xla_pib", "xla_f32_b", "factored", "factored_f32", "factored_kernel", "factored_fused",
    )},
    "factored_sr": (sr.CONTRIB_SR, sr.ACC_F32),
    "factored_kernel_sr": (sr.CONTRIB_SR, sr.ACC_F32),
    **{m: (sr.CONTRIB_RN, sr.ACC_BF16) for m in ("xla_half", "xla_half_b", "xla_half_ob", "xla_half_bb")},
    "xla_half_sr": (sr.CONTRIB_SR, sr.ACC_BF16),
    "drop": (sr.CONTRIB_NONE, sr.ACC_DROP),
}
SCATTER_STRATEGIES = ("auto",) + tuple(_MODE_CLASSES)
# The "auto" scatter strategy's gate: the factored form for batches of at
# least this many gradient rows into per-level tables of at most this size.
_FACTORED_MIN_ROWS = 65536
_FACTORED_MAX_SIZE = 65536
# Classes of the phase-locked levels' static scatter (locked_rounding).
_LOCKED_CLASSES = {
    "pair": GRAD_F32,
    "f32": GRAD_F32,
    "single": (sr.CONTRIB_RN, sr.ACC_F32),
    "sr": (sr.CONTRIB_SR, sr.ACC_F32),
}


def grid_scale(level: int, log2_per_level_scale: float, base_resolution: int) -> float:
    """(reference: common_device.h:886-891)"""
    return 2.0 ** (level * log2_per_level_scale) * base_resolution - 1.0


def grid_resolution(scale: float) -> int:
    """(reference: common_device.h:893-895)"""
    return int(math.ceil(scale)) + 1


def _hash_factors(hash_type: HashType, n_dims: int):
    if hash_type == HashType.Prime:
        return _PRIME_FACTORS[:n_dims]
    if hash_type in (HashType.CoherentPrime, HashType.CoherentAdditive):
        return _COHERENT_PRIME_FACTORS[:n_dims]
    if hash_type == HashType.ReversedPrime:
        return _REVERSED_PRIME_FACTORS[:n_dims]
    raise NotImplementedError(f"hash type {hash_type} has no LCG factors")


class GridEncoding(Encoding):
    """Hash/Dense/Tiled multiresolution grid (reference: encodings/grid.h)."""

    otype = "Grid"
    pad_value = 0.0  # grid pads with zeros (grid.h:757-767)

    def __init__(
        self,
        n_dims_to_encode: int,
        n_features: int = 32,
        log2_hashmap_size: int = 19,
        base_resolution: int = 16,
        per_level_scale: float = 2.0,
        interpolation_type: InterpolationType = InterpolationType.Linear,
        grid_type: GridType = GridType.Hash,
        hash_type: HashType = HashType.CoherentPrime,
        n_features_per_level: int = 2,
    ):
        super().__init__(n_dims_to_encode)
        if n_dims_to_encode < 1 or n_dims_to_encode > 10:
            raise ValueError("GridEncoding supports 1..10 input dims")
        if n_features % n_features_per_level != 0:
            raise ValueError(
                f"GridEncoding: n_features={n_features} must be a multiple of "
                f"n_features_per_level={n_features_per_level}"
            )
        self.n_features = int(n_features)
        self.n_features_per_level = int(n_features_per_level)
        self.n_levels = self.n_features // self.n_features_per_level
        if self.n_levels > MAX_N_LEVELS:
            raise ValueError(f"GridEncoding: n_levels={self.n_levels} must be at most {MAX_N_LEVELS}")
        self.log2_hashmap_size = int(log2_hashmap_size)
        self.base_resolution = int(base_resolution)
        self.per_level_scale = float(per_level_scale)
        self.interpolation_type = interpolation_type
        self.grid_type = grid_type
        self.hash_type = hash_type
        # "quad" | "quad_fused" | "stratified" select base-plus-delta corner
        # indexing on affine levels under Linear interpolation (the JAX
        # package's quad-table gather); other strategies fold every corner.
        # The two agree except where uint32 wrap-around meets a level size
        # that is not a power of two.
        self.gather_strategy = "per_level"
        # Levels with scale <= raster_max_scale index with raster strides
        # (1, res, res^2, ...): part of the encoding function, set by the
        # "stratified" strategy (see create_grid_encoding).
        self.raster_max_scale: Optional[float] = None
        self.locked_snap_tol = 1.0
        self.stratified_max_variants = 3
        # Phase lock: set by _apply_phase_lock ("phase_locked" config key).
        self.phase_locked = False
        self.strata: Optional[int] = None
        # Storage dtype the table is rounded to on read: "float32" (none),
        # "float16" or "bfloat16". Parameters stay fp32.
        self.table_dtype = "float32"
        # Table-gradient rounding, as the JAX package selects it (see
        # gradient_classes): the scatter strategy, the phase-locked levels'
        # rounding, and the quad packing that gates the phase-locked path.
        self.scatter_strategy = "auto"
        self.locked_rounding = "pair"
        self.quad_pack = "auto"
        # TPU execution-strategy keys: validated, kept for hyperparams(),
        # otherwise ignored.
        self.quad_build = "auto"
        self.level_split = "auto"
        self.strat_accum = "auto"
        self.locked_phases = 1
        self.locked_fwd = "unpacked"
        # Whether the hash came from "auto" (deserialize warns then: a
        # reference checkpoint needs the reference's CoherentPrime).
        self.hash_auto_resolved = False
        # Stochastic interpolation: the table gradient of a call given
        # ``rng`` goes to one sampled corner per (sample, level); the
        # forward and the input gradient stay the deterministic ones.
        self.stochastic_interpolation = False
        # Positions given as uint32 fixed point spanning [0, 1) (reference:
        # grid.h:1143-1151).
        self.fixed_point_pos = False
        self._level_tables: Dict[tuple, torch.Tensor] = {}
        self._class_tables: Dict[tuple, tuple] = {}

        d = self.n_dims_to_encode
        log2_scale = math.log2(self.per_level_scale)
        max_params = 2**31

        # Per-level offset table (reference: grid.h:695-737).
        offsets: List[int] = []
        resolutions: List[int] = []
        scales: List[float] = []
        offset = 0
        for lvl in range(self.n_levels):
            scale = grid_scale(lvl, log2_scale, self.base_resolution)
            resolution = grid_resolution(scale)
            params_in_level = max_params if float(resolution) ** d > max_params else resolution**d
            params_in_level = next_multiple(params_in_level, 8)
            if grid_type == GridType.Dense:
                pass
            elif grid_type == GridType.Tiled:
                params_in_level = min(params_in_level, self.base_resolution**d)
            elif grid_type == GridType.Hash:
                params_in_level = min(params_in_level, 1 << self.log2_hashmap_size)
            else:
                raise ValueError(f"invalid grid type {grid_type}")
            offsets.append(offset)
            resolutions.append(resolution)
            scales.append(scale)
            offset += params_in_level
        offsets.append(offset)
        if offset > 2**31 - 1:
            raise ValueError(
                f"GridEncoding: total table rows {offset} exceed int32 "
                "indexing range; reduce n_levels/resolution or use Hash "
                "type with a log2_hashmap_size cap"
            )
        self.offset_table = np.asarray(offsets, np.int64)
        self.resolutions = np.asarray(resolutions, np.int64)
        self.scales = np.asarray(scales, np.float64)
        self._n_params = int(offset) * self.n_features_per_level
        self.n_output_dims = self.n_features

        # Per-level: does the dense index fit, or do we hash?
        # (reference: common_device.h:847-884)
        self._use_hash: List[bool] = []
        for lvl in range(self.n_levels):
            res = int(self.resolutions[lvl])
            level_size = int(self.offset_table[lvl + 1] - self.offset_table[lvl])
            stride = res**d if res <= _MAX_BASES[d] else 0xFFFFFFFF
            self._use_hash.append(grid_type == GridType.Hash and level_size < stride)

        # Per-level affine corner strides: dense/tiled raster strides or the
        # additive hash factors; None for the XOR and base-convert hashes.
        self._corner_strides: List[Optional[List[int]]] = []
        for lvl in range(self.n_levels):
            res = int(self.resolutions[lvl])
            if not self._use_hash[lvl]:
                self._corner_strides.append([res**k for k in range(d)])
            elif hash_type == HashType.CoherentAdditive:
                self._corner_strides.append([int(f) for f in _hash_factors(hash_type, d)])
            else:
                self._corner_strides.append(None)

    @property
    def n_params(self) -> int:
        return self._n_params

    def initialize_params(self, rng, scale: float = 1.0) -> np.ndarray:
        """U(-1e-4, 1e-4), like the reference (grid.h:1076-1079)."""
        return (rng.next_float(self._n_params) * 2e-4 - 1e-4).astype(np.float32) * scale

    def _apply_phase_lock(self, strata: int) -> None:
        """Snap fine hashed levels' scales to multiples of ``strata``
        (tcnn_tpu/encodings/grid.py:_apply_phase_lock): only power-of-two
        hashed levels above ``raster_max_scale`` whose param count and
        hashed classification survive the snap, within ``locked_snap_tol``."""
        self.phase_locked = True
        self.strata = int(strata)
        d = self.n_dims_to_encode
        for lvl in range(self.n_levels):
            scale = float(self.scales[lvl])
            if self.raster_max_scale is not None and scale <= self.raster_max_scale:
                continue
            if not self._use_hash[lvl]:
                continue
            size = int(self.offset_table[lvl + 1] - self.offset_table[lvl])
            if size & (size - 1):
                continue
            snapped = max(int(round(scale / strata)), 1) * int(strata)
            if abs(snapped - scale) / scale > self.locked_snap_tol:
                continue
            res = snapped + 1
            if res**d <= size:
                continue
            self.scales[lvl] = float(snapped)
            self.resolutions[lvl] = res
        self._level_tables.clear()
        self._class_tables.clear()

    def _level_strides(self, lvl: int) -> Optional[List[int]]:
        """Raster strides below ``raster_max_scale``, else the level's
        affine corner strides (None for XOR/base-convert hashed levels)."""
        if self.raster_max_scale is not None and float(self.scales[lvl]) <= self.raster_max_scale:
            res = int(self.resolutions[lvl])
            return [res**k for k in range(self.n_dims_to_encode)]
        return self._corner_strides[lvl]

    def _static_levels(self, batch: Optional[int], raster_sides=None, stratified: Optional[bool] = None) -> List[bool]:
        """Per level, whether the JAX package reads it from the fp32
        parameters without a per-sample gather (tcnn_tpu/encodings/grid.py:
        GridEncoding.apply), where ``_stratified_path`` holds: on the raster
        of ``raster_sides``, the prefix of raster-stride levels takes the
        separable static lerp (:1564-1578, :1866-1871; ``apply_raster``
        routes there unless the encoding interpolates stochastically,
        :2107-2125); on a batch of ``batch`` samples that is a perfect d-th
        power (unless ``stratified`` is False, as ``FrozenServer`` asks for
        batches), and on a raster that is one, the levels whose scale is at
        most ``raster_max_scale`` and whose cell window is at most
        ``stratified_max_variants`` take the stratified static path
        (:1683-1712, :1872-1876)."""
        static = [False] * self.n_levels
        if raster_sides is not None:
            if self.stochastic_interpolation:
                return static
            batch, prefix = int(np.prod(raster_sides)), True
        elif stratified is False or batch is None:
            return static
        else:
            prefix = False
        if not self._stratified_path():
            return static
        strata = self._batch_strata(batch)
        for lvl in range(self.n_levels):
            scale = float(self.scales[lvl])
            if scale > self.raster_max_scale:
                prefix = False
                continue
            if prefix or (strata and math.ceil(scale / strata) + 1 <= self.stratified_max_variants):
                static[lvl] = True
            else:
                prefix = False
        return static

    def _stratified_path(self) -> bool:
        """Whether the JAX package's stratified static path can run for this
        encoding (tcnn_tpu/encodings/grid.py:1457-1470, 1482-1493): not
        under ``fixed_point_pos``; a call that interpolates stochastically
        takes it as ``stratified=False`` (``_encode``)."""
        return (
            self.gather_strategy == "stratified"
            and not self.fixed_point_pos
            and self.raster_max_scale is not None
            and self.interpolation_type in (InterpolationType.Linear, InterpolationType.Smoothstep)
            and self.n_dims_to_encode in (2, 3)
        )

    def _batch_strata(self, batch: int) -> int:
        """Tiles per dim of a stratified batch of ``batch`` samples (a
        perfect d-th power of at least 2), or 0 where the static path does
        not run for it."""
        d = self.n_dims_to_encode
        s = round(int(batch) ** (1.0 / d))
        return s if self._stratified_path() and s**d == batch and s >= 2 else 0

    def _quad_level(self, lvl: int) -> bool:
        """Whether the JAX package reads the level through a quad-row
        gather (tcnn_tpu/encodings/grid.py:1713-1717)."""
        return (
            self.gather_strategy in ("quad", "quad_fused", "stratified")
            and self.interpolation_type == InterpolationType.Linear
            and self._level_strides(lvl) is not None
        )

    def served_levels(self, raster_sides=None) -> List[bool]:
        """Per level, whether the JAX package's ``FrozenServer`` reads it
        from a prebuilt quad table, which it stores in the serve-time
        ``table_dtype``: on a batch, or on the raster of ``raster_sides``.
        Tables are built only under gather_strategy "quad" or "stratified"
        for levels with affine strides (tcnn_tpu/encodings/grid.py:
        serving_tables, _level_strides) and read only on the quad-row path,
        which needs Linear interpolation (:1713-1717, :1892). Batches are
        served with ``stratified=False`` (tcnn_tpu/serving.py); on a raster
        the static levels of ``_static_levels`` read the fp32 parameters."""
        if self.gather_strategy not in ("quad", "stratified"):
            return [False] * self.n_levels
        static = self._static_levels(None, raster_sides, stratified=False)
        return [self._quad_level(lvl) and not static[lvl] for lvl in range(self.n_levels)]

    def rounded_levels(self, batch: Optional[int] = None, raster_sides=None,
                       stratified: Optional[bool] = None) -> List[bool]:
        """Per level, whether the JAX package reads it through a gather that
        rounds to the encoding's own ``table_dtype`` (``forward_dtype``,
        tcnn_tpu/encodings/grid.py:_forward_dtype :572) for a call on
        ``batch`` samples, or on the raster of ``raster_sides``
        (``stratified`` as ``GridEncoding.apply`` takes it). Path by path
        through ``GridEncoding.apply`` (:1354-2024):

        - "fused": one gather of the fp32 table for all levels (:1804-1828);
          "quad_fused" when every level is a quad level: one gather of the
          fp32 quad supertable (:1765-1803). No level rounds.
        - the separable and stratified static levels (``_static_levels``)
          read the fp32 parameters (:1866-1876, ``_stratified_feats``
          :1262, ``_raster_separable_feats`` :1183). They do not round.
        - every other level rounds: the quad-row gathers of the prebuilt
          serving tables (stored in the forward dtype, :2054-2061), of the
          phase-locked levels (:1000-1118, every ``locked_fwd``), of the
          hybrid and packed layouts (:892-905, :1918-1929) and of the plain
          quad table (:1943-1947; the one-hot and ``index_mode`` branches
          need attributes the config never sets), and the per-corner
          vertex gathers (:1953-1982), flat or level-split."""
        L = self.n_levels
        if self.gather_strategy == "fused" or (
            self.gather_strategy == "quad_fused" and all(self._quad_level(lvl) for lvl in range(L))
        ):
            return [False] * L
        return [not s for s in self._static_levels(batch, raster_sides, stratified)]

    def level_table(self, table_dtype: Optional[str] = None, raster_sides=None, batch: Optional[int] = None,
                    stratified: Optional[bool] = None) -> np.ndarray:
        """The (n_levels, 32) int32 level table of this encoding for a call
        on ``batch`` samples or on the raster of ``raster_sides``: the
        levels ``rounded_levels`` names round their reads to the encoding's
        ``table_dtype``; with a serve-time ``table_dtype``, the levels
        ``served_levels`` names then round them to that."""
        quad = (
            self.gather_strategy in ("quad", "quad_fused", "stratified")
            and self.interpolation_type == InterpolationType.Linear
        )
        modes, strides = [], []
        for lvl in range(self.n_levels):
            st = self._level_strides(lvl)
            if st is not None:
                modes.append(ge.MODE_QUAD if quad else ge.MODE_FOLD)
                strides.append(st)
            elif self.hash_type in (HashType.BaseConvert, HashType.Rng):
                modes.append(ge.MODE_BASECONVERT if self.hash_type == HashType.BaseConvert else ge.MODE_RNG)
                strides.append([0] * self.n_dims_to_encode)
            else:
                modes.append(ge.MODE_XOR)
                strides.append(_hash_factors(self.hash_type, self.n_dims_to_encode))
        off = self.offset_table
        serve, own = self._round_codes(table_dtype, raster_sides, batch, stratified)
        return ge.level_table(off[:-1], off[1:] - off[:-1], modes, self.scales, strides, serve, own,
                              fixed_point=self.fixed_point_pos)

    def _round_codes(self, table_dtype, raster_sides, batch, stratified):
        """Per level, the (serve-time, own) ROUND_* codes of its reads."""
        code = _ROUND_CODES[table_dtype or "float32"]
        serve = [code if s else ge.ROUND_NONE for s in self.served_levels(raster_sides)] if code else [0] * self.n_levels
        code = _ROUND_CODES[self.table_dtype]
        rounded = self.rounded_levels(batch, raster_sides, stratified) if code else [False] * self.n_levels
        return serve, [code if r else ge.ROUND_NONE for r in rounded]

    def _levels_on(self, device: torch.device, table_dtype: Optional[str] = None, raster_sides=None,
                   batch: Optional[int] = None, stratified: Optional[bool] = None) -> torch.Tensor:
        serve, own = self._round_codes(table_dtype, raster_sides, batch, stratified)
        key = (device.type, device.index, tuple(serve), tuple(own))
        t = self._level_tables.get(key)
        if t is None:
            table = self.level_table(table_dtype, raster_sides, batch, stratified)
            t = self._level_tables[key] = ge.level_table_on(table, device)
        return t

    def _pack_k(self) -> int:
        """Cells per packed quad row, 128 / (2^d * F), or 0 (the JAX
        package's ``_pack_k``; it gates the phase-locked path)."""
        slot = (2**self.n_dims_to_encode) * self.n_features_per_level
        if slot > 128 or 128 % slot:
            return 0
        return 128 // slot

    def _locked_levels(self, strat_strata: int) -> set:
        """Levels the JAX package runs on its phase-locked path for a
        stratified batch of ``strat_strata`` tiles per dim
        (tcnn_tpu/encodings/grid.py:_locked_levels)."""
        if (
            not self.phase_locked
            or self.strata != strat_strata
            or self.gather_strategy != "stratified"
            or self.interpolation_type != InterpolationType.Linear
            or self.fixed_point_pos
            or self.quad_pack == "off"
        ):
            return set()
        K = self._pack_k()
        if K < 2:
            return set()
        out = set()
        for lvl in range(self.n_levels):
            scale = float(self.scales[lvl])
            size = int(self.offset_table[lvl + 1] - self.offset_table[lvl])
            if (
                scale > (self.raster_max_scale or 0.0)
                and self._use_hash[lvl]
                and size & (size - 1) == 0
                and size % K == 0
                and scale == int(scale)
                and int(scale) % strat_strata == 0
                and self._level_strides(lvl) is not None
            ):
                out.add(lvl)
        return out

    def _scatter_mode(self, n_rows: int, size: int) -> str:
        """(tcnn_tpu/encodings/grid.py:_scatter_mode)"""
        if self.scatter_strategy != "auto":
            return self.scatter_strategy
        if n_rows >= _FACTORED_MIN_ROWS:
            if size <= _FACTORED_MAX_SIZE:
                return "factored"
            if self.n_features_per_level >= 2:
                return "xla_half"
        return "xla"

    def gradient_classes(self, batch: int, stratified: Optional[bool] = None) -> np.ndarray:
        """Per level, the (contribution rounding, accumulation) class of the
        table gradient (``ops.scatter_rows`` codes) that the JAX package
        gives a training batch of ``batch`` samples, as (L, 2) int32;
        ``stratified=False`` as ``GridEncoding.apply`` takes it (no static
        or phase-locked level), which is also what a stochastic call gets:
        its one-hot cotangents reach the same gathers' scatters
        (tcnn_tpu/encodings/grid.py:1790-1830, 1984-1990).

        Resolved as ``GridEncoding.apply`` does there
        (tcnn_tpu/encodings/grid.py:1457-1470, 1683-1753, 1765-1982): the
        single-gather strategies ("fused", and "quad_fused" when every level
        takes the quad path) scatter in fp32; levels on the stratified
        static path (a perfect d-th power batch, scale <= raster_max_scale)
        have a dense fp32 backward; phase-locked levels take
        ``locked_rounding``; the other quad levels take the scatter mode of
        ``batch`` rows, per-corner levels that of ``batch * 2^d`` rows. The
        fp32 levels are those the forward reads without a rounding gather
        (``rounded_levels``)."""
        strat_strata = 0 if stratified is False else self._batch_strata(batch)
        locked = self._locked_levels(strat_strata) if strat_strata else set()
        n_corners = 1 if self.interpolation_type == InterpolationType.Nearest else 2**self.n_dims_to_encode
        gathered = self.rounded_levels(batch, stratified=stratified)
        out = []
        for lvl in range(self.n_levels):
            size = int(self.offset_table[lvl + 1] - self.offset_table[lvl])
            if not gathered[lvl]:
                out.append(GRAD_F32)
            elif self._quad_level(lvl):
                if lvl in locked:
                    out.append(_LOCKED_CLASSES[self.locked_rounding])
                else:
                    out.append(_MODE_CLASSES[self._scatter_mode(batch, size)])
            else:
                out.append(_MODE_CLASSES[self._scatter_mode(batch * n_corners, size)])
        return np.asarray(out, np.int32).reshape(self.n_levels, 2)

    def _classes_on(self, device: torch.device, batch: int, stratified: Optional[bool] = None):
        """(class table on ``device``, whether a level sums in bf16, the
        table gradient's ``backward_plan``)."""
        key = (
            device.type, device.index, int(batch), stratified is False, self.gather_strategy,
            self.scatter_strategy, self.locked_rounding, self.quad_pack,
        )
        hit = self._class_tables.get(key)
        if hit is None:
            classes = self.gradient_classes(batch, stratified)
            plan = ge.backward_plan(self.level_table(), self.n_features_per_level, batch, classes)
            hit = (torch.from_numpy(classes).to(device), bool((classes[:, 1] == sr.ACC_BF16).any()), plan)
            self._class_tables[key] = hit
        return hit

    def apply(self, params: torch.Tensor, x: torch.Tensor, table_dtype: Optional[str] = None,
              stratified: Optional[bool] = None, max_level: Optional[float] = None, rng=None) -> torch.Tensor:
        """Encode positions ``x`` (batch, n_dims) to (batch,
        padded_output_width) in ``output_dtype``: fp32 positions, or uint32
        ones spanning [0, 1) under ``fixed_point_pos`` (any other dtype
        raises ``TypeError`` there, as in the JAX package). The encoding's
        own ``table_dtype`` rounds the reads of ``rounded_levels``;
        ``table_dtype`` here is the serve-time precision: the levels of
        ``served_levels()`` round their reads to it after that.
        ``stratified=False`` (what ``FrozenServer`` passes for batches) says
        the batch is not the stratified layout, as in the JAX package.
        ``max_level`` (a float in [0, 1]) masks coarse to fine: level ``l``
        outputs zeros unless ``l < max_level * n_levels + 1e-3``
        (reference: grid.h:69-92; tcnn_tpu/encodings/grid.py:2012-2016), so
        the masked levels get no table gradient.
        ``rng``, for an encoding built with ``stochastic_interpolation``
        (and not Nearest), makes the table gradient stochastic (reference:
        grid.h:284-299; tcnn_tpu/encodings/grid.py:1391-1395): each
        (sample, level) adds its whole dL/dy row to the one corner whose
        bit in dim k is u < w_k, for one uniform u: a ``torch.Generator``
        on the device of ``params`` draws the (batch, n_levels) uniforms,
        or a (batch, n_levels) fp32 tensor gives them. The call then takes
        the per-sample path (``stratified=True`` raises). The forward and
        the input gradient stay exact; without ``rng`` the table gradient
        is the deterministic one.
        Differentiable twice with respect to ``params`` and ``x``
        (``ops.grid_encode``: the lookup, table-gradient, input-gradient and
        double-backward kernels on the card, their plain versions on the
        CPU)."""
        return self._encode(params, x, table_dtype, plain=False, stratified=stratified, max_level=max_level,
                            rng=rng)

    def apply_plain(self, params: torch.Tensor, x: torch.Tensor, table_dtype: Optional[str] = None,
                    stratified: Optional[bool] = None, max_level: Optional[float] = None, rng=None) -> torch.Tensor:
        """``apply`` through the kernels' plain torch versions, on any
        device (the reference the kernels are checked against)."""
        return self._encode(params, x, table_dtype, plain=True, stratified=stratified, max_level=max_level, rng=rng)

    def _positions(self, x) -> torch.Tensor:
        if self.fixed_point_pos:
            if x.dtype != torch.uint32:
                raise TypeError("fixed_point_pos expects uint32 inputs spanning [0, 1)")
            return x.contiguous()
        return x.to(torch.float32).contiguous()

    def _stochastic(self, rng) -> bool:
        """Whether a call given ``rng`` interpolates stochastically."""
        return (rng is not None and self.stochastic_interpolation
                and self.interpolation_type != InterpolationType.Nearest)

    def _uniforms(self, rng, batch: int, device: torch.device) -> Optional[torch.Tensor]:
        """Stochastic interpolation's (batch, n_levels) fp32 uniforms for a
        call given ``rng``, or None where the call is deterministic."""
        if not self._stochastic(rng):
            return None
        if isinstance(rng, torch.Generator):
            return torch.rand((batch, self.n_levels), generator=rng, device=device)
        u = torch.as_tensor(rng, dtype=torch.float32, device=device).contiguous()
        if u.shape != (batch, self.n_levels):
            raise ValueError(f"GridEncoding: rng uniforms of shape {tuple(u.shape)}, not ({batch}, {self.n_levels})")
        return u

    def _column_levels(self, device: torch.device) -> torch.Tensor:
        """(padded_output_width,) fp32: each output column's level, -1 for
        the padding; cached per device, so that a captured graph copies
        nothing from the host."""
        key = ("column_levels", device.type, device.index)
        levels = self._level_tables.get(key)
        if levels is None:
            cols = np.arange(self.padded_output_width) // self.n_features_per_level
            cols = np.where(cols < self.n_levels, cols, -1).astype(np.float32)
            levels = self._level_tables[key] = torch.from_numpy(cols).to(device)
        return levels

    def _encode(self, params, x, table_dtype, plain: bool, raster_sides=None, stratified=None, max_level=None,
                rng=None):
        x = self._positions(x)
        training = torch.is_grad_enabled() and params.requires_grad
        u = None
        if self._stochastic(rng):
            # The JAX package's stochastic call takes no static path
            # (tcnn_tpu/encodings/grid.py:1457-1505), gradient or not.
            if stratified:
                raise ValueError("stratified=True but the static path is unavailable under stochastic interpolation")
            stratified = False
            if training:
                u = self._uniforms(rng, x.shape[0], x.device)
        classes, acc16, plan = None, False, None
        if training:
            classes, acc16, plan = self._classes_on(x.device, x.shape[0], stratified)
        meta = (
            self.n_features_per_level,
            self.padded_output_width,
            _INTERP_CODES[self.interpolation_type],
            self.output_dtype,
            plain,
            acc16,
            plan,
        )
        levels = self._levels_on(x.device, table_dtype, raster_sides, x.shape[0], stratified)
        y = ge.GridEncodeFunction.apply(x, params, levels, classes, u, meta)
        if max_level is not None:
            # By torch.where, not a multiply, as the JAX package masks.
            # The limit in fp32, as the JAX package compares.
            limit = float(np.float32(max_level) * np.float32(self.n_levels) + np.float32(1e-3))
            y = torch.where(self._column_levels(x.device) < limit, y, torch.zeros((), dtype=y.dtype, device=y.device))
        return y

    def hyperparams(self):
        """The JAX package's ``GridEncoding.hyperparams()``, its TPU
        strategy keys included as the config gave them."""
        hp = {
            "otype": self.otype,
            "type": self.grid_type.value,
            "n_levels": self.n_levels,
            "n_features_per_level": self.n_features_per_level,
            "log2_hashmap_size": self.log2_hashmap_size,
            "base_resolution": self.base_resolution,
            "per_level_scale": self.per_level_scale,
            "interpolation": self.interpolation_type.value,
            "hash": self.hash_type.value,
            "gather_strategy": self.gather_strategy,
            "scatter_strategy": self.scatter_strategy,
            "quad_pack": self.quad_pack,
            "quad_build": self.quad_build,
            "level_split": self.level_split,
            "strat_accum": self.strat_accum,
            "table_dtype": self.table_dtype,
        }
        if self.raster_max_scale is not None:
            hp["stratified_max_variants"] = self.stratified_max_variants
            hp["strata"] = int(self.raster_max_scale / max(self.stratified_max_variants - 1, 1))
        if self.phase_locked:
            hp.update(phase_locked=True, locked_rounding=self.locked_rounding, locked_phases=self.locked_phases,
                      locked_snap_tol=self.locked_snap_tol, locked_fwd=self.locked_fwd)
        return hp

    def apply_raster(self, params: torch.Tensor, side, table_dtype: Optional[str] = None,
                     max_level: Optional[float] = None) -> torch.Tensor:
        """Encode the tile-center raster (``utils.sampling.raster_centers``
        layout), built on the device of ``params``, by per-sample lookup; a
        serve-time ``table_dtype`` rounds the levels ``served_levels`` names
        for this raster; ``max_level`` masks as in ``apply``."""
        d = self.n_dims_to_encode
        sides = (int(side),) * d if np.isscalar(side) else tuple(int(s) for s in side)
        x = raster_centers_torch(side, d, params.device)
        if self.fixed_point_pos:
            raise TypeError("fixed_point_pos expects uint32 inputs spanning [0, 1); the raster's are float")
        return self._encode(params, x, table_dtype, plain=False, raster_sides=sides, max_level=max_level)


def _resolve_hash_type(name: str, grid_type) -> HashType:
    """``"auto"`` picks CoherentAdditive, as the JAX package does
    (tcnn_tpu/encodings/grid.py:_resolve_hash_type)."""
    if name.lower() == "auto":
        if grid_type == GridType.Hash:
            log_info('GridEncoding: no "hash" specified, using CoherentAdditive')
        return HashType.CoherentAdditive
    return string_to_hash_type(name)


def create_grid_encoding(n_dims_to_encode: int, encoding: dict) -> GridEncoding:
    """Factory reproducing the JAX package's JSON surface
    (tcnn_tpu/encodings/grid.py:create_grid_encoding)."""
    encoding = encoding or {}
    log2_hashmap_size = json_value(encoding, "log2_hashmap_size", 19)
    otype = json_value(encoding, "otype", "Grid")
    if otype.lower() == "tiledgrid":
        default_type = "Tiled"
    elif otype.lower() == "densegrid":
        default_type = "Dense"
    else:
        default_type = "Hash"

    n_features_per_level = json_value(encoding, "n_features_per_level", 2)
    has_nf = "n_features" in encoding or "n_grid_features" in encoding
    if has_nf:
        if "n_levels" in encoding:
            raise ValueError(
                "GridEncoding: may not specify n_features and n_levels "
                "simultaneously (one determines the other)"
            )
        n_features = json_value(encoding, "n_features", json_value(encoding, "n_grid_features", None))
    else:
        n_features = n_features_per_level * json_value(encoding, "n_levels", 16)

    n_levels = n_features // n_features_per_level
    grid_type = string_to_grid_type(json_value(encoding, "type", default_type))
    base_resolution = json_value(encoding, "base_resolution", 16)
    if grid_type == GridType.Dense:
        default_scale = math.exp(math.log(256.0 / base_resolution) / max(n_levels - 1, 1))
    else:
        default_scale = 2.0

    # Stochastic interpolation changes only the table gradient, and only of
    # a call given ``rng``; the forward is the deterministic lookup.
    stochastic = bool(json_value(encoding, "stochastic_interpolation", False))
    enc = GridEncoding(
        n_dims_to_encode=n_dims_to_encode,
        n_features=n_features,
        log2_hashmap_size=log2_hashmap_size,
        base_resolution=base_resolution,
        per_level_scale=json_value(encoding, "per_level_scale", default_scale),
        interpolation_type=string_to_interpolation_type(json_value(encoding, "interpolation", "Linear")),
        grid_type=grid_type,
        hash_type=_resolve_hash_type(json_value(encoding, "hash", "auto"), grid_type),
        n_features_per_level=n_features_per_level,
    )
    for key, allowed in (("quad_build", _QUAD_BUILDS), ("level_split", _LEVEL_SPLITS)):
        if json_value(encoding, key, "auto") not in allowed:
            raise ValueError(f"invalid {key} {json_value(encoding, key, None)!r}")
        setattr(enc, key, json_value(encoding, key, "auto"))
    enc.hash_auto_resolved = json_value(encoding, "hash", "auto").lower() == "auto" and grid_type == GridType.Hash
    ignored = [k for k in TPU_STRATEGY_KEYS if json_value(encoding, k, None) is not None]
    if ignored:
        log_info(f"GridEncoding: TPU execution-strategy keys {ignored} are ignored by the port")

    gs = json_value(encoding, "gather_strategy", "auto")
    if gs == "auto":
        gs = "quad" if enc.interpolation_type == InterpolationType.Linear and not stochastic else "per_level"
    if gs not in ("per_level", "fused", "quad", "quad_fused", "stratified"):
        raise ValueError(f"invalid gather_strategy {gs!r}")
    enc.gather_strategy = gs
    enc.stochastic_interpolation = stochastic
    enc.fixed_point_pos = bool(json_value(encoding, "fixed_point_pos", False))
    enc.scatter_strategy = json_value(encoding, "scatter_strategy", "auto")
    if enc.scatter_strategy not in SCATTER_STRATEGIES:
        raise ValueError(f"invalid scatter_strategy {enc.scatter_strategy!r}")
    enc.quad_pack = json_value(encoding, "quad_pack", "auto")
    enc.table_dtype = json_value(encoding, "table_dtype", "float32")
    if enc.table_dtype not in _ROUND_CODES:
        raise ValueError(f"invalid table_dtype {enc.table_dtype!r}")
    if gs == "stratified":
        strata = json_value(encoding, "strata", 512 if n_dims_to_encode == 2 else 64)
        enc.stratified_max_variants = json_value(encoding, "stratified_max_variants", 3 if n_dims_to_encode == 2 else 2)
        enc.raster_max_scale = float((enc.stratified_max_variants - 1) * strata)
        for key, default, allowed in (("strat_accum", "auto", _STRAT_ACCUMS), ("locked_fwd", "unpacked", _LOCKED_FWDS)):
            if json_value(encoding, key, default) not in allowed:
                raise ValueError(f"invalid {key} {json_value(encoding, key, default)!r}")
            setattr(enc, key, json_value(encoding, key, default))
        # Kept only for hyperparams(): the phase count shapes the JAX
        # package's locked-level transpose, not the function computed.
        enc.locked_phases = int(json_value(encoding, "locked_phases", 1))
        if enc.locked_phases < 1:
            raise ValueError(f"locked_phases must be >= 1: {enc.locked_phases}")
        enc.locked_rounding = json_value(encoding, "locked_rounding", "pair")
        if enc.locked_rounding not in _LOCKED_CLASSES:
            raise ValueError(f"invalid locked_rounding {enc.locked_rounding!r}")
        enc.locked_snap_tol = float(json_value(encoding, "locked_snap_tol", 1.0))
        if not 0.0 <= enc.locked_snap_tol:
            raise ValueError(f"locked_snap_tol must be >= 0: {enc.locked_snap_tol}")
        if json_value(encoding, "phase_locked", False):
            enc._apply_phase_lock(strata)
    elif json_value(encoding, "phase_locked", False):
        raise ValueError("phase_locked requires gather_strategy 'stratified'")
    return enc


__all__ = ["GridEncoding", "create_grid_encoding", "grid_scale", "grid_resolution"]
