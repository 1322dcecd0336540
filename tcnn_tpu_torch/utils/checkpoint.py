"""Fast binary checkpoints of the full training state (port of the npz half
of ``tcnn_tpu.utils.checkpoint``; the orbax half is a JAX integration and is
not ported).

``Trainer.serialize`` / ``deserialize`` give the reference's JSON blobs
(trainer.h:442-482). ``save_npz`` / ``load_npz`` store the state tree
``{"opt": optimizer state, "params": flat params}`` as ``leaf_{i}`` arrays
numbered in the JAX package's leaf order (dict keys sorted, lists in
order), so an npz that either package writes loads into the other for the
same model and optimizer configuration.
"""

from __future__ import annotations

import numpy as np
import torch

from ..optimizers.base import tree_leaves, tree_map


def _state(trainer) -> dict:
    return {"opt": trainer.opt_state, "params": trainer.params}


def save_npz(path, trainer) -> None:
    """Save the full training state (params and optimizer state) as an .npz."""
    np.savez(path, **{f"leaf_{i}": leaf.detach().cpu().numpy() for i, leaf in enumerate(tree_leaves(_state(trainer)))})


def load_npz(path, trainer) -> None:
    """Restore state saved by ``save_npz`` (of either package) into a trainer
    of the same model and optimizer configuration. Raises ``ValueError`` on
    a leaf whose shape differs, before anything is changed."""
    state = _state(trainer)
    templates = tree_leaves(state)
    with np.load(path, allow_pickle=False) as data:
        arrays = [data[f"leaf_{i}"] for i in range(len(templates))]
    for i, (arr, tmpl) in enumerate(zip(arrays, templates)):
        if tuple(arr.shape) != tuple(tmpl.shape):
            raise ValueError(
                f"checkpoint leaf {i} has shape {arr.shape}, expected {tuple(tmpl.shape)} — "
                "optimizer/model config mismatch"
            )
    it = iter(arrays)
    restored = tree_map(lambda t: torch.from_numpy(np.array(next(it))).to(device=t.device, dtype=t.dtype), state)
    trainer.params = restored["params"]
    trainer.opt_state = restored["opt"]
