"""Host-side training-data pipeline (port of ``tcnn_tpu.utils.data``).

``HostImageSampler`` streams (positions, nearest-pixel targets) batches
from an image in host memory, the host analogue of the reference sampling
its training batches from a CUDA texture inside the train loop (reference:
samples/mlp_learning_an_image.cu:259-307). A native C++ worker thread
(``runtime/host_sampler.cpp``) fills a ring of buffers, so that producing a
batch overlaps the device's steps; a numpy fallback keeps the API where no
compiler is at hand. For the same seed both paths give the JAX package's
batches bit for bit (its native and its numpy path respectively), but for
one repair: every stratified sample lies strictly inside its raster tile,
``floor(x * strata) == tile`` in exact arithmetic, where the JAX package's
fp32 ``(tile + u) / strata`` can round onto the tile's upper edge (``tile
+ u`` rounds up to ``tile + 1`` for u within an ulp of ``tile`` below 1);
such a sample moves to the nearest fp32 value inside the tile.
``sampler.native`` says which one runs.

For data that fits in device memory, drawing batches on the device is
faster still (``samples.mlp_learning_an_image``); this pipeline is for
datasets that must stay in host RAM.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from ..runtime import native
from .sampling import strata_of


def _in_tiles(v: np.ndarray, tiles: np.ndarray, strata: int) -> np.ndarray:
    """The fp32 stratified coordinates ``v`` of raster tiles ``tiles``, each
    moved by single fp32 steps to the nearest value in [tile, tile + 1) /
    strata where it lies outside (runtime/host_sampler.cpp:in_tile does the
    same); the product of an fp32 value and ``strata`` is exact in float64."""
    v = np.asarray(v, np.float32).copy()
    tiles = np.asarray(tiles, np.float64)
    while True:
        scaled = v.astype(np.float64) * strata
        up, down = scaled >= tiles + 1, scaled < tiles
        if not (up.any() or down.any()):
            return v
        v[up] = np.nextafter(v[up], np.float32(0))
        v[down] = np.nextafter(v[down], np.float32(1))


class HostImageSampler:
    """Asynchronous (xy, rgb) batch producer over a host-resident image.

    Args:
      image: (h, w, c) float32 array (kept alive by this object; the
        native worker reads it without a copy).
      batch: samples per batch.
      stratified: one jittered sample per raster tile (``batch`` must be a
        perfect square; the layout of the grid encoding's stratified path),
        else i.i.d. uniform positions.
      seed: the PCG32 seed of the native path, numpy's for the fallback.
      n_buffers: ring depth (2 = double buffering).
    """

    def __init__(self, image: np.ndarray, batch: int, stratified: bool = True, seed: int = 0, n_buffers: int = 3):
        self.image = np.ascontiguousarray(image, np.float32)
        if self.image.ndim != 3:
            raise ValueError("image must be (h, w, c)")
        self.h, self.w, self.c = self.image.shape
        self.batch = int(batch)
        self.strata = 0
        if stratified:
            s = strata_of(self.batch, 2)
            if s is None:
                raise ValueError(f"stratified sampling needs a square batch, got {batch}")
            self.strata = s
        self._handle = None
        self._rng: Optional[np.random.Generator] = None
        lib = native._load()
        if lib is not None:
            self._lib = lib
            self._handle = lib.sampler_create(
                self.image.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                self.h, self.w, self.c, self.batch, self.strata, seed, n_buffers,
            )
        if self._handle is None:
            self._rng = np.random.default_rng(seed)

    @property
    def native(self) -> bool:
        return self._handle is not None

    def next(self) -> Tuple[np.ndarray, np.ndarray]:
        """Blocking: the next (xy (B, 2) f32, rgb (B, c) f32) batch."""
        xy = np.empty((self.batch, 2), np.float32)
        rgb = np.empty((self.batch, self.c), np.float32)
        if self._handle is not None:
            self._lib.sampler_next(
                self._handle,
                xy.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            )
            return xy, rgb
        jitter = self._rng.random((self.batch, 2), np.float32)
        if self.strata:
            ids = np.arange(self.batch)
            base = np.stack([ids % self.strata, ids // self.strata], axis=1).astype(np.float32)
            xy[:] = _in_tiles((base + jitter) / self.strata, base, self.strata)
        else:
            xy[:] = jitter
        px = np.minimum((xy[:, 0] * self.w).astype(np.int64), self.w - 1)
        py = np.minimum((xy[:, 1] * self.h).astype(np.int64), self.h - 1)
        rgb[:] = self.image[py, px]
        return xy, rgb

    def close(self):
        if self._handle is not None:
            self._lib.sampler_destroy(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
