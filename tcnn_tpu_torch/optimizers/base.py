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
- ``custom_weights(state)``: separate inference weights (EMA, Average,
  Lookahead), else None; Composite returns a function of the live params.

Every schedule stays on the device: step counters are 0-d int32 tensors and
every choice that depends on them (Batched's accumulate-then-step, the
decay factor, Novograd's first step, Lookahead's sync, Shampoo's root
refresh and its Newton iteration's stop) is a ``torch.where``, never a host
``if``, as the JAX package writes them under ``jit``. So a
captured training step (``Trainer.training_steps``) replays them right.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..common import resolve_device


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of a state tree (dicts and lists of tensors),
    with the same-shaped trees ``rest`` beside it, in ``tree_leaves``
    order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> List:
    """The leaves of a state tree in the JAX package's order (dict keys
    sorted, lists in order), the order its npz checkpoints number them in."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


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

    def n_nested(self) -> int:
        return 0

    def nested(self, idx: int = 0) -> "Optimizer":
        raise IndexError("optimizer has no nested optimizers")

    def update_hyperparams(self, params: Dict):
        pass

    def hyperparams(self) -> Dict:
        return {"otype": self.otype}

    @property
    def n_matrix_weights(self) -> int:
        """Weights covered by weight matrices (the matrix/non-matrix
        boundary; matrix params come first in the flat vector)."""
        return sum(r * c for r, c in self.layer_sizes)
