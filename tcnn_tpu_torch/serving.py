"""Production serving over frozen parameters (port of ``tcnn_tpu.serving``).

``FrozenServer`` snapshots a trainer's inference parameters; training
further does not change a server. The JAX package also prebuilds per-level
quad tables here; on the card the lookup kernel reads the flat parameters
directly, so the snapshot is all there is to build. A serve-time
``table_dtype`` rounds, on read inside the lookup kernel, the levels the
JAX package serves from those tables (``GridEncoding.served_levels``).

Scale-out: pass a ``DeviceMesh`` (``parallel.make_mesh``) to serve over its
``axis_name`` dimension, as the JAX package serves over a mesh: params are
replicated, every rank takes the global batch or raster, evaluates its
contiguous rows (a raster's with the whole raster's levels, as
``apply_raster`` reads them) and returns the whole (B, n_output_dims)
output, the ranks' rows gathered. B must divide by the mesh size.

Usage::

    server = trainer.freeze_serving()
    y = server(x)                  # arbitrary (B, d) batches
    img = server.raster((w, h))    # full-raster evaluation

    server = trainer.freeze_serving(mesh=parallel.make_mesh())
    y = server(x)                  # every rank: the whole output
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from .encodings.grid import data_shards


class FrozenServer:
    def __init__(self, trainer, mesh=None, axis_name: str = "data", table_dtype: Optional[str] = None):
        """``table_dtype`` (serve-time only): round the table reads of the
        levels the JAX package stores in its prebuilt quad tables to this
        dtype (``"float16"`` or ``"bfloat16"``), after the encoding's own
        ``table_dtype``: under gather_strategy "quad" or "stratified" with
        Linear interpolation, the levels with affine strides, and on a
        stratified raster not the raster-stride levels of its static path
        (``GridEncoding.served_levels``). The other levels read as the
        encoding's ``table_dtype`` says. Training state is untouched.
        ``mesh``: a ``DeviceMesh`` whose ``axis_name`` dimension shares
        out the rows (see the module's head)."""
        self._group, self._n, self._index = None, 1, 0
        if mesh is not None:
            from .parallel.collectives import axis

            self._group, self._n, self._index = axis(mesh, axis_name)
        if table_dtype not in (None, "float32", "float16", "bfloat16"):
            raise ValueError(f"invalid table_dtype {table_dtype!r}")
        self.model = trainer.model
        self.n_output_dims = int(self.model.n_output_dims)
        self.table_dtype = table_dtype
        self._params = trainer.inference_params().detach().clone()

    def _kw(self):
        return {"table_dtype": self.table_dtype} if self.table_dtype is not None else {}

    def _rows(self, n: int, what: str):
        if n % self._n:
            raise ValueError(f"{what} size {n} must be divisible by the serving mesh size {self._n}")
        from .parallel.collectives import rows_of

        return rows_of(self._index, self._n, n)

    def _gathered(self, local: torch.Tensor) -> torch.Tensor:
        from .parallel.collectives import gather_rows

        return gather_rows(local, self._group, self._n)

    @torch.no_grad()
    def __call__(self, x) -> torch.Tensor:
        """Serve an arbitrary (B, d) batch, fp32 or the uint32 positions of
        a fixed_point_pos grid; returns (B, n_output_dims) fp32."""
        x = torch.as_tensor(x, device=self._params.device)
        if x.dtype != torch.uint32:
            x = x.to(torch.float32)
        kw = self._kw()
        # Arbitrary batches are not the stratified layout (the JAX package's
        # FrozenServer passes stratified=False for them).
        if getattr(getattr(self.model, "encoding", None), "gather_strategy", None) == "stratified":
            kw["stratified"] = False
        if self._n > 1:
            x = x[self._rows(x.shape[0], "batch")]
        with data_shards(self._n):
            out = self.model.apply(self._params, x, **kw)
        return self._gathered(out[:, : self.n_output_dims].to(torch.float32))

    @torch.no_grad()
    def raster(self, side: Union[int, Tuple[int, ...]]) -> torch.Tensor:
        """Serve the full tile-center raster; returns (prod(sides),
        n_output_dims) fp32."""
        side = int(side) if np.isscalar(side) else tuple(int(s) for s in side)
        kw = self._kw()
        if self._n > 1:
            n_pts = side ** self.model.n_input_dims if isinstance(side, int) else int(np.prod(side))
            rows = self._rows(n_pts, "raster")
            kw["rows"] = (rows.start, rows.stop)
        out = self.model.apply_raster(self._params, side, **kw)
        return self._gathered(out[:, : self.n_output_dims].to(torch.float32))
