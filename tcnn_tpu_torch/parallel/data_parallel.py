"""Data-parallel training over a 1-D device mesh (port of
``tcnn_tpu.parallel.data_parallel``).

As in the JAX package the model's weights are small, so they are
replicated, and the batch is sharded: each rank of the mesh's ``data``
dimension takes its contiguous rows of the global batch. Where the JAX
package's ``jit`` over the mesh makes XLA insert the gradient reduction,
here a step runs the wrapped ``Trainer``'s own forward and backward on the
rank's rows, sums ONE flat buffer (the parameter gradient and the loss sum)
over the ranks with one ``all_reduce``, and then runs the optimizer (its
kernel on the card) on every rank alike, so the replicas stay equal.

What the JAX package gets free from ``jit`` of the global step is explicit:

- normalisation: a loss normalises by its batch * dims, here the rank's,
  so the summed gradient and loss are divided by the data degree (exact
  for a power of two); the external-gradient step does not divide, its
  dL/doutput being already the global batch's (trainer.h:127-138);
- decisions from the batch: the grid's own rounding and the table
  gradient's classes are decided on the global batch
  (``encodings.grid.data_shards``), the table gradient's launch plan on
  the rank's rows;
- ``perturbation_sigma``: each rank draws the global batch's uniforms from
  the trainer's generator and takes its rows, so the noise is the single
  trainer's and the generators stay in lockstep.

The process group is the caller's (``torch.distributed.init_process_group``
with any backend: NCCL on one card a rank, gloo on the CPU or for several
ranks on one card); ``make_mesh`` spans it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..common import resolve_device
from ..encodings.grid import data_shards
from ..optimizers.base import tree_leaves
from .collectives import all_reduce, axis, broadcast_, gather_rows, rows_of


def make_mesh(devices: Optional[Sequence[int]] = None, axis_name: str = "data", device=None):
    """A 1-D ``DeviceMesh`` named ``axis_name`` over the ranks ``devices``
    (default: every rank of the initialised process group) on ``device``'s
    type (default the card; ``device="cpu"`` for the CPU)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: initialise the process group first (torch.distributed.init_process_group)")
    ranks = list(range(dist.get_world_size())) if devices is None else [int(r) for r in devices]
    return DeviceMesh(resolve_device(device).type, torch.tensor(ranks, dtype=torch.int64), mesh_dim_names=(axis_name,))


def _broadcast_generator(gen: torch.Generator, group, device) -> None:
    """Gives ``gen`` the state of the group's first rank."""
    state = gen.get_state()
    t = broadcast_(state.to(device), group)
    gen.set_state(t.cpu())


class DataParallelTrainer:
    """Wraps a port ``Trainer`` with batch sharding over ``mesh``'s
    ``axis_name`` dimension (default: ``make_mesh`` over every rank on the
    trainer's device type). The params, the optimizer state and the
    perturbation generator of the group's first rank are broadcast at
    construction. Every method takes the GLOBAL batch on every rank, as
    the JAX package's methods take it."""

    def __init__(self, trainer, mesh=None, axis_name: str = "data"):
        self.trainer = trainer
        self.mesh = mesh if mesh is not None else make_mesh(axis_name=axis_name, device=trainer.device)
        self.axis_name = axis_name
        self._group, self._n, self._index = axis(self.mesh, axis_name)
        with torch.no_grad():
            broadcast_(trainer.params, self._group)
            for leaf in tree_leaves(trainer.opt_state):
                if isinstance(leaf, torch.Tensor):
                    broadcast_(leaf, self._group)
        if trainer.perturbation_generator is not None:
            _broadcast_generator(trainer.perturbation_generator, self._group, trainer.device)

    @property
    def n_devices(self) -> int:
        return self._n

    def shard_batch(self, *arrays):
        """This rank's rows of each global-batch array, on the trainer's
        device: a view, with no copy, of a tensor already there."""
        out = []
        for a in arrays:
            rows = rows_of(self._index, self._n, a.shape[0])
            if isinstance(a, torch.Tensor) and a.device == self.trainer.device:
                out.append(a[rows])
            else:
                out.append(torch.as_tensor(np.asarray(a)[rows] if not isinstance(a, torch.Tensor) else a[rows],
                                           device=self.trainer.device))
        return tuple(out) if len(out) > 1 else out[0]

    def _check_batch(self, batch: int):
        if batch % self._n != 0:
            raise ValueError(f"batch size {batch} must be divisible by the data-parallel degree {self._n}")

    def _reduced_step(self, x, output_gradient, divide: bool):
        """The wrapped trainer's backward on this rank's rows, one
        all_reduce of [gradient | loss sum], then its optimizer step;
        returns the reduced loss sum (None where the output gradient gives
        none)."""
        t = self.trainer
        with data_shards(self._n):
            grads, loss_sum = t._backward(x, False, output_gradient)
        n_params = grads.numel()
        flat = torch.empty(n_params + 1, dtype=torch.float32, device=grads.device)
        flat[:n_params] = grads
        flat[n_params] = 0.0 if loss_sum is None else loss_sum
        all_reduce(flat, self._group)
        if divide and self._n > 1:
            flat.div_(self._n)
        t._optimizer_step(flat[:n_params], plain=False)
        return None if loss_sum is None else flat[n_params]

    def training_step(self, inputs, targets, data_pdf=None) -> torch.Tensor:
        """One step on the global batch; returns the global loss sum (a 0-d
        device tensor, not synchronised)."""
        self._check_batch(inputs.shape[0])
        if data_pdf is None:
            x, y = self.shard_batch(inputs, targets)
            pdf = None
        else:
            x, y, pdf = self.shard_batch(inputs, targets, data_pdf)
        gradient = self.trainer._loss_gradient(y, pdf, shard=(self._index, self._n))
        return self._reduced_step(x, gradient, divide=True)

    def training_step_with_gradients(self, inputs, dL_doutput) -> None:
        """External-gradient step (reference: trainer.h:127-138), the global
        batch's dL/doutput sharded like the batch; not divided."""
        self._check_batch(inputs.shape[0])
        x, dL = self.shard_batch(inputs, dL_doutput)
        self._reduced_step(x, lambda out: (dL, None), divide=False)

    def inference(self, inputs) -> torch.Tensor:
        """(global batch, n_output_dims) fp32 on every rank: each rank
        serves its rows, then the rows are gathered."""
        self._check_batch(inputs.shape[0])
        with data_shards(self._n):
            local = self.trainer.inference(self.shard_batch(inputs))
        return gather_rows(local, self._group, self._n)
