"""Batch samplers and serving-raster positions (port of
``tcnn_tpu.utils.sampling``).

``stratified_uniform`` draws one jittered sample per cell of a regular
raster partition of [0, 1)^d, in raster order (dim 0 fastest): the layout
the JAX package's ``gather_strategy: "stratified"`` path is built for. It
draws from an explicit ``torch.Generator``, so its numbers are not
``jax.random``'s; the tests hand both packages the same numpy batches.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..common import default_device


def stratified_uniform(
    n: int,
    dims: int = 2,
    generator: Optional[torch.Generator] = None,
    phase_locked: Union[bool, int] = False,
    run_correlated: bool = False,
    device=None,
) -> torch.Tensor:
    """(n, dims) fp32 positions in [0, 1), sample ``j`` in raster tile
    ``j`` of a (strata,)*dims partition (dim 0 fastest); ``n`` must be a
    perfect ``dims``-th power (tcnn_tpu/utils/sampling.py:stratified_uniform).

    ``phase_locked``: share G jitter vectors, tile ``j`` using phase
    ``j % G`` (``True`` means G = 1). ``run_correlated``: share the jitter of
    dims >= 1 across each run of ``strata`` consecutive samples. The two are
    mutually exclusive. Drawn on ``device``; without one, on the generator's
    device, and without a generator on ``common.default_device()`` (the
    card: pass ``device="cpu"`` for the CPU)."""
    strata = strata_of(n, dims)
    if strata is None:
        raise ValueError(f"stratified_uniform: n={n} is not a perfect {dims}-th power")
    if phase_locked and run_correlated:
        raise ValueError("stratified_uniform: phase_locked and run_correlated are mutually exclusive")
    if device is None:
        device = generator.device if generator is not None else default_device()

    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=device, dtype=torch.float32)

    if phase_locked:
        n_phases = 1 if phase_locked is True else int(phase_locked)
        if n_phases < 1 or n % n_phases:
            raise ValueError(f"stratified_uniform: phase_locked={n_phases} must be a positive divisor of n={n}")
        phases = uniform(n_phases, dims)
        jitter = phases[torch.arange(n, device=device) % n_phases]
    elif run_correlated and dims > 1:
        j0 = uniform(n, 1)
        jr = uniform(n // strata, 1, dims - 1).expand(n // strata, strata, dims - 1)
        jitter = torch.cat([j0, jr.reshape(n, dims - 1)], dim=1)
    else:
        jitter = uniform(n, dims)
    ids = torch.arange(n, dtype=torch.int64, device=device)
    base = torch.stack([(ids // strata**d) % strata for d in range(dims)], dim=1).to(torch.float32)
    return (base + jitter) / strata


def strata_of(n: int, dims: int = 2) -> Optional[int]:
    """The per-dim strata count if ``n`` is a perfect power, else None."""
    strata = round(n ** (1.0 / dims))
    return strata if strata**dims == n else None


def is_stratified(x, strata: Optional[int] = None) -> bool:
    """Host-side check: does batch ``x`` satisfy the stratified raster
    contract (sample ``j`` in tile ``j``)? For tests and validation."""
    x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    n, dims = x.shape
    strata = strata or strata_of(n, dims)
    if strata is None:
        return False
    ids = np.arange(n)
    for d in range(dims):
        tile = (ids // strata**d) % strata
        got = np.floor(x[:, d] * strata).astype(np.int64)
        if not np.array_equal(np.clip(got, 0, strata - 1), tile):
            return False
    return True


def _sides_of(side, dims: int):
    return (int(side),) * dims if np.isscalar(side) else tuple(int(s) for s in side)


def raster_centers(side, dims: int = 2) -> np.ndarray:
    """Tile-center raster positions, (prod(sides), dims) float32 numpy.

    ``side`` is an int (cubic raster) or a per-dim tuple. Sample ``j`` is the
    center of raster tile ``j``, dim 0 fastest.
    """
    sides = _sides_of(side, dims)
    ids = np.arange(int(np.prod(sides)), dtype=np.int64)
    cols = []
    stride = 1
    for d in range(dims):
        base = (ids // stride) % sides[d]
        cols.append(
            (base.astype(np.float32) + np.float32(0.5)) / np.float32(sides[d])
        )
        stride *= sides[d]
    return np.stack(cols, axis=1)


def raster_centers_torch(side, dims: int, device, rows=None) -> torch.Tensor:
    """``raster_centers`` built on ``device``: each dim's ``side`` tile
    centers are computed in numpy (bit-identical to ``raster_centers``) and
    expanded on the device by index, so a 1024^2 raster never crosses the
    host-device link. (A torch division by a scalar may be evaluated as a
    multiply by the reciprocal on CUDA, which is not bit-identical.)
    ``rows`` = (start, stop): only those rows of the raster."""
    sides = _sides_of(side, dims)
    start, stop = (0, int(np.prod(sides))) if rows is None else (int(rows[0]), int(rows[1]))
    ids = torch.arange(start, stop, dtype=torch.int64, device=device)
    cols = []
    stride = 1
    for d in range(dims):
        s = sides[d]
        centers = (np.arange(s, dtype=np.float32) + np.float32(0.5)) / np.float32(s)
        cols.append(torch.from_numpy(centers).to(device)[(ids // stride) % s])
        stride *= s
    return torch.stack(cols, dim=1)
