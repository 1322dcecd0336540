"""Production serving over frozen parameters (port of ``tcnn_tpu.serving``).

``FrozenServer`` snapshots a trainer's inference parameters; training
further does not change a server. The JAX package also prebuilds per-level
quad tables here; on the card the lookup kernel reads the flat parameters
directly, so the snapshot is all there is to build. A serve-time
``table_dtype`` rounds, on read inside the lookup kernel, the levels the
JAX package serves from those tables (``GridEncoding.served_levels``).

Usage::

    server = trainer.freeze_serving()
    y = server(x)                  # arbitrary (B, d) batches
    img = server.raster((w, h))    # full-raster evaluation
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch


class FrozenServer:
    def __init__(self, trainer, mesh=None, table_dtype: Optional[str] = None):
        """``table_dtype`` (serve-time only): round the table reads of the
        levels the JAX package stores in its prebuilt quad tables to this
        dtype (``"float16"`` or ``"bfloat16"``), after the encoding's own
        ``table_dtype``: under gather_strategy "quad" or "stratified" with
        Linear interpolation, the levels with affine strides, and on a
        stratified raster not the raster-stride levels of its static path
        (``GridEncoding.served_levels``). The other levels read as the
        encoding's ``table_dtype`` says. Training state is untouched."""
        if mesh is not None:
            raise NotImplementedError(
                "FrozenServer: multi-GPU serving is not ported yet (ROADMAP.md, Queue 1: parallel)"
            )
        if table_dtype not in (None, "float32", "float16", "bfloat16"):
            raise ValueError(f"invalid table_dtype {table_dtype!r}")
        self.model = trainer.model
        self.n_output_dims = int(self.model.n_output_dims)
        self.table_dtype = table_dtype
        self._params = trainer.inference_params().detach().clone()

    def _kw(self):
        return {"table_dtype": self.table_dtype} if self.table_dtype is not None else {}

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
        out = self.model.apply(self._params, x, **kw)
        return out[:, : self.n_output_dims].to(torch.float32)

    @torch.no_grad()
    def raster(self, side: Union[int, Tuple[int, ...]]) -> torch.Tensor:
        """Serve the full tile-center raster; returns (prod(sides),
        n_output_dims) fp32."""
        side = int(side) if np.isscalar(side) else tuple(int(s) for s in side)
        out = self.model.apply_raster(self._params, side, **self._kw())
        return out[:, : self.n_output_dims].to(torch.float32)
