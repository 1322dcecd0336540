"""Optimizer protocol (port of ``tcnn_tpu.optimizers.base``; reference:
optimizer.h:39-63).

- ``allocate(n_weights, layer_sizes)``: static setup. ``layer_sizes`` lists
  the network's weight-matrix shapes; the params they cover ("matrix
  params") lead the flat vector and may be treated differently from the
  rest (hash grids etc.).
- ``init_state(device)``: a dict of tensors on the params' device (None:
  ``common.default_device()``, the card); the global step count is a 0-d
  int32 tensor there, so that no step needs a host synchronisation.
- ``step(state, params, grads, loss_scale)``: one update, gradients divided
  by ``loss_scale`` inside; returns ``(new_state, new_params)``. On the card
  the update runs in place, so the returned tensors are the ones passed in.
  ``plain=True`` runs every kernel's plain torch version instead, on any
  device (the reference the kernel path is checked against).
- ``custom_weights(state)``: separate inference weights (EMA), else None.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..common import resolve_device


class Optimizer:
    otype = "Optimizer"

    def __init__(self):
        self.n_weights = 0
        self.layer_sizes: List[Tuple[int, int]] = []

    def allocate(self, n_weights: int, layer_sizes: List[Tuple[int, int]]):
        self.n_weights = int(n_weights)
        self.layer_sizes = list(layer_sizes)

    def init_state(self, device=None) -> Dict[str, torch.Tensor]:
        return {"step": torch.zeros((), dtype=torch.int32, device=resolve_device(device))}

    def step(self, state, params: torch.Tensor, grads: torch.Tensor, loss_scale: float, plain: bool = False):
        raise NotImplementedError

    def custom_weights(self, state) -> Optional[torch.Tensor]:
        return None

    @property
    def learning_rate(self) -> float:
        return 0.0

    @learning_rate.setter
    def learning_rate(self, value: float):
        raise NotImplementedError

    def update_hyperparams(self, params: Dict):
        pass

    def hyperparams(self) -> Dict:
        return {"otype": self.otype}

    @property
    def n_matrix_weights(self) -> int:
        """Weights covered by weight matrices (the matrix/non-matrix
        boundary; matrix params come first in the flat vector)."""
        return sum(r * c for r, c in self.layer_sizes)
