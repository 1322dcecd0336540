"""Parameter interchange with the JAX package (minimal port of
``tcnn_tpu.interchange``).

Both packages keep one flat fp32 parameter vector in the same layout, so
weights carried across are the vector itself, checked for length and dtype.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(flat, model) -> torch.Tensor:
    """The JAX package's flat parameters (a numpy array, e.g. from
    ``trainer.params``, ``trainer.inference_params()`` or a
    ``tcnn_tpu.modules`` module's ``params``) as a float32 tensor on
    ``model``'s device, ready for ``trainer.params = ...`` or a module's
    ``params.copy_(...)``. ``model`` is anything with ``n_params`` and
    ``params``: a ``NetworkWithInputEncoding`` or a ``modules`` module."""
    arr = np.asarray(flat)
    if arr.dtype != np.float32:
        raise ValueError(f"params_from_numpy: expected float32 params, got {arr.dtype}")
    if arr.shape != (model.n_params,):
        raise ValueError(f"params_from_numpy: got shape {arr.shape}, model has {model.n_params} params")
    return torch.from_numpy(np.array(arr, copy=True)).to(model.params.device)
