"""Table- (model-) parallel grid encoding over a mesh dimension (port of
``tcnn_tpu.parallel.table_parallel``).

Every level of a grid's table is row-sharded over the ranks of the mesh's
``model`` dimension: rank d holds rows [d * ceil(S_l / n), (d + 1) *
ceil(S_l / n)) of level l (the JAX package's layout, ``shard_params``), so
tables larger than one card's memory train and serve across cards. The
lookup computes every corner's index on every rank (the replicated index
work the design trades for memory) and reads only the rank's rows: the
windowed lookup kernel (``ops.grid_encode.grid_encode_windowed``,
``csrc/grid_sharded.cu``) writes the rank's partial features, which ONE
``all_reduce`` over the model group sums. The backward of that sum is the
identity, since every rank of the group computes the same network on the
same features: the windowed table-gradient kernel adds each rank's
contributions into its own rows, with no collective. The positions are the
same on every rank of the group (a data shard's), so their gradient is the
sum of the ranks' partials (the windowed input-gradient kernel's): one
``all_reduce``, the transpose of the forward's. The two sums are each
other's backward (``_SumOverGroup``, ``_CopyToGroup``), so every order of
the lookup's derivatives is the whole table's: the windowed double
backward's table gradient is local and its d/dx and d/d(dL_dy) partials
are summed; a third order is autograd of the plain windowed double
backward, as for a whole table (``ops.grid_encode``).
``TableParallelTrainer`` composes this with data parallelism over the
mesh's ``data`` dimension.

Scope, as in the JAX package: the deterministic per-level lookup
(stochastic interpolation raises ``NotImplementedError``); and
``fixed_point_pos`` raises too (the JAX package's sharded lookup casts the
uint32 positions to fp32 and computes another function).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..encodings.grid import _INTERP_CODES, GridEncoding
from ..ops import grid_encode as ge
from ..optimizers import create_optimizer
from ..optimizers.base import tree_map
from .collectives import all_reduce, gather_rows, rows_of
from .collectives import axis as mesh_axis


def _mesh_device(mesh) -> torch.device:
    """The device of this rank on ``mesh``: its CUDA device, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


class _SumOverGroup(torch.autograd.Function):
    """The sum over the model group of each rank's partial, held by every
    rank. Its backward is the identity (``_CopyToGroup``): every rank of
    the group takes the same loss of the sum.

    ``_SumOverGroup.apply(t, group)``"""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _CopyToGroup.apply(g, ctx.group), None


class _CopyToGroup(torch.autograd.Function):
    """A tensor that every rank of the model group holds alike (the
    positions, dL/dy), handed to the ranks' partial computations: the
    identity, whose backward sums the ranks' partial gradients
    (``_SumOverGroup``).

    ``_CopyToGroup.apply(t, group)``"""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _SumOverGroup.apply(g, ctx.group), None


def _windowed_grads(x, params, dy, levels, windows, meta, need_x, need_params):
    """The first backward of a rank's windowed lookup: (the table gradient
    of its rows or None, its partial dL/dx or None), from the kernels."""
    F, interp, plan = meta
    dparams = ge.grid_backward_windowed(x, dy, levels, windows, F, interp, plan) if need_params else None
    dx = ge.grid_backward_input_windowed(x, dy, params, levels, windows, F, interp) if need_x else None
    return dparams, dx


class _WindowedLookup(torch.autograd.Function):
    """A rank's partial features of a row-sharded table (the windowed
    lookup of its rows ``params``), differentiable in ``params`` (the
    windowed table gradient of its rows) and in the positions (its partial
    input gradient, the windowed G1), each only where
    ``ctx.needs_input_grad`` asks for it. A backward that must itself be
    differentiable runs as ``_WindowedBackward``. The sums over the group
    are the caller's (``TableParallelGrid.apply``).

    ``_WindowedLookup.apply(x, params, levels, windows, meta)`` with
    ``meta`` = (F, interpolation, plan)."""

    @staticmethod
    def forward(ctx, x, params, levels, windows, meta):
        F, interp, plan = meta
        ctx.meta = meta
        ctx.save_for_backward(x, params, levels, windows)
        return ge.grid_encode_windowed(x, params, levels, windows, F, interp)

    @staticmethod
    def backward(ctx, dy):
        x, params, levels, windows = ctx.saved_tensors
        need_x, need_params = ctx.needs_input_grad[0], ctx.needs_input_grad[1]
        dy = dy.to(torch.float32).contiguous()
        if torch.is_grad_enabled():
            dparams, dx = _WindowedBackward.apply(x, params, dy, levels, windows, ctx.meta, need_x, need_params)
        else:
            dparams, dx = _windowed_grads(x, params, dy, levels, windows, ctx.meta, need_x, need_params)
        return dx, dparams, None, None, None


class _WindowedBackward(torch.autograd.Function):
    """``_WindowedLookup``'s first backward as a differentiable function of
    (x, params, dL_dy): its forward returns (the table gradient of the
    rank's rows, its partial dL/dx), each None where it is not wanted; its
    backward the windowed double backward (G2 of the rank's rows: its table
    gradient, its d/dx and d/d(dL_dy) partials), or, where that must itself
    be differentiable, ``_WindowedBackwardBackward``.

    ``_WindowedBackward.apply(x, params, dy, levels, windows, meta, need_x,
    need_params)``"""

    @staticmethod
    def forward(ctx, x, params, dy, levels, windows, meta, need_x, need_params):
        ctx.meta = meta
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, params, dy, levels, windows)
        return _windowed_grads(x, params, dy, levels, windows, meta, need_x, need_params)

    @staticmethod
    def backward(ctx, cgp, cgx):
        x, params, dy, levels, windows = ctx.saved_tensors
        if cgp is None and cgx is None:
            return (None,) * 8
        F, interp, plan = ctx.meta
        cgp = None if cgp is None else cgp.contiguous()
        cgx = None if cgx is None else cgx.contiguous()
        if torch.is_grad_enabled():
            d_params, d_x, d_dy = _WindowedBackwardBackward.apply(x, params, dy, levels, windows, cgp, cgx, ctx.meta)
        else:
            d_params, d_x, d_dy = ge.grid_backward_backward_windowed(x, dy, params, levels, windows, F, interp, cgp,
                                                                     cgx)
        need = ctx.needs_input_grad
        return (d_x if need[0] else None, d_params if need[1] else None, d_dy if need[2] else None,
                None, None, None, None, None)


class _WindowedBackwardBackward(torch.autograd.Function):
    """The windowed double backward as a differentiable function of (x,
    params, dL_dy, cgp, cgx): its forward is the kernel
    (``ops.grid_encode.grid_backward_backward_windowed``), its backward
    autograd of the plain version recomputed from the saved inputs
    (``grid_backward_backward_plain`` with the windows), as
    ``ops.grid_encode.GridEncodeBackwardBackwardFunction`` for a whole
    table.

    ``_WindowedBackwardBackward.apply(x, params, dy, levels, windows, cgp,
    cgx, meta)``"""

    @staticmethod
    def forward(ctx, x, params, dy, levels, windows, cgp, cgx, meta):
        F, interp, plan = meta
        ctx.meta = meta
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, params, dy, cgp, cgx, levels, windows)
        return ge.grid_backward_backward_windowed(x, dy, params, levels, windows, F, interp, cgp, cgx)

    @staticmethod
    def backward(ctx, g_params, g_x, g_dy):
        x, params, dy, cgp, cgx, levels, windows = ctx.saved_tensors
        F, interp, plan = ctx.meta
        need = ctx.needs_input_grad
        classes = ge._f32_classes(levels.shape[0], levels.device)

        def fn(xx, pp, yy, cp, cx):
            return ge.grid_backward_backward_plain(xx, yy, pp, levels, F, interp, classes, cp, cx, windows)

        d_x, d_params, d_dy, d_cgp, d_cgx = ge._autograd_of(
            fn, (x, params, dy, cgp, cgx), (need[0], need[1], need[2], need[5], need[6]), (g_params, g_x, g_dy))
        return d_x, d_params, d_dy, None, None, d_cgp, d_cgx, None


class TableParallelGrid:
    """Row-shards a port ``GridEncoding``'s tables over ``mesh[axis]``.

    ``shard_params(params)`` relays the flat parameter vector into the
    ``(n_shards * local_n_params,)`` stack, rank d's block at ``[d *
    local_n_params, (d + 1) * local_n_params)``, byte for byte the JAX
    package's (numpy, on the host); ``local_params`` cuts this rank's block
    out of it. ``apply(local, x)`` takes THIS rank's block and returns the
    (B, n_levels * F) fp32 features of the whole table on every rank of the
    model group, those of ``encoding.apply`` under the "per_level" strategy
    (affine levels fold every corner, reads unrounded).

    ``mesh=None`` with ``shard=(index, count)``: the layout of one rank of
    ``count``, with no process group (``apply`` then returns that rank's
    partial features, unsummed)."""

    def __init__(self, encoding: GridEncoding, mesh, axis: str = "model", data_axis: Optional[str] = None,
                 shard: Optional[Tuple[int, int]] = None):
        if not isinstance(encoding, GridEncoding):
            raise TypeError(f"TableParallelGrid: a grid encoding is required, not {type(encoding).__name__}")
        if encoding.stochastic_interpolation:
            raise NotImplementedError("table-parallel grid: stochastic interpolation is single-device only")
        if encoding.fixed_point_pos:
            raise NotImplementedError(
                "table-parallel grid: fixed_point_pos is not supported (the JAX package's sharded lookup casts "
                "the uint32 positions to fp32 and computes another function)"
            )
        self.encoding = encoding
        self.mesh = mesh
        self.axis = axis
        self.data_axis = data_axis
        if mesh is None:
            if shard is None:
                raise ValueError("TableParallelGrid: give a mesh, or shard=(index, count) without one")
            self.group, self.shard, self.n_shards = None, int(shard[0]), int(shard[1])
        else:
            self.group, self.n_shards, self.shard = mesh_axis(mesh, axis)
        if self.n_shards == 1:
            self.group = None
        F = encoding.n_features_per_level
        off = encoding.offset_table
        self.level_sizes = [int(off[lvl + 1] - off[lvl]) for lvl in range(encoding.n_levels)]
        self.local_rows = [-(-s // self.n_shards) for s in self.level_sizes]
        self.local_offsets = np.concatenate([[0], np.cumsum(self.local_rows)]).astype(np.int64)
        self.local_n_params = int(self.local_offsets[-1]) * F
        # This rank's windows and level table: local offsets, global sizes,
        # every affine level folding its corners, no rounding of reads.
        self.windows = np.asarray([[self.shard * r, r] for r in self.local_rows], np.int32)
        modes, strides = encoding.level_modes(quad=False)
        self.level_table = ge.level_table(self.local_offsets[:-1], self.level_sizes, modes, encoding.scales, strides)
        self._on: Dict[tuple, tuple] = {}
        self._plans: Dict[int, ge.BackwardPlan] = {}

    # -- parameter relayout --------------------------------------------------
    def _relayout(self, src: np.ndarray, to_blocks: bool) -> np.ndarray:
        """Rows of the flat table <-> rows of the block stack, in ``src``'s
        dtype."""
        e = self.encoding
        F = e.n_features_per_level
        n_blocks = self.local_n_params // F
        if to_blocks:
            table = src.reshape(-1, F)
            out = np.zeros((self.n_shards, n_blocks, F), src.dtype)
        else:
            blocks = src.reshape(self.n_shards, n_blocks, F)
            out = np.zeros((int(e.offset_table[-1]), F), src.dtype)
        for lvl, (size, rows) in enumerate(zip(self.level_sizes, self.local_rows)):
            goff, loff = int(e.offset_table[lvl]), int(self.local_offsets[lvl])
            for d in range(self.n_shards):
                lo, hi = d * rows, min(d * rows + rows, size)
                if hi > lo:
                    if to_blocks:
                        out[d, loff : loff + (hi - lo)] = table[goff + lo : goff + hi]
                    else:
                        out[goff + lo : goff + hi] = blocks[d, loff : loff + (hi - lo)]
        return out.reshape(-1)

    def shard_params(self, params) -> np.ndarray:
        """Flat (n_params,) -> (n_shards * local_n_params,) fp32 block stack."""
        return self._relayout(np.asarray(params, np.float32), True)

    def unshard_params(self, stacked) -> np.ndarray:
        """Inverse of ``shard_params`` (the reference-compatible flat layout
        for checkpoints)."""
        return self._relayout(np.asarray(stacked, np.float32), False)

    def local_params(self, params) -> np.ndarray:
        """This rank's block of ``shard_params(params)``."""
        stacked = self.shard_params(params)
        return stacked[self.shard * self.local_n_params : (self.shard + 1) * self.local_n_params]

    # -- sharded lookup ------------------------------------------------------
    def _tables_on(self, device: torch.device):
        key = (device.type, device.index)
        hit = self._on.get(key)
        if hit is None:
            hit = self._on[key] = ge.windowed_tables(self.level_table, self.windows, device)
        return hit

    def _plan(self, batch: int) -> ge.BackwardPlan:
        plan = self._plans.get(batch)
        if plan is None:
            plan = self._plans[batch] = ge.windowed_plan(self.level_table, self.windows,
                                                          self.encoding.n_features_per_level, batch)
        return plan

    def apply(self, local_params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """(B, n_levels * F) fp32 features of positions ``x`` (B, d) from
        this rank's block ``local_params`` (``local_n_params``,) fp32, the
        same on every rank of the model group. Differentiable to any order:
        with respect to ``local_params`` the gradient of this rank's rows
        (no collective), with respect to ``x`` the whole table's (the
        ranks' partials summed over the group)."""
        e = self.encoding
        x = x.to(torch.float32).contiguous()
        levels, windows = self._tables_on(x.device)
        meta = (e.n_features_per_level, _INTERP_CODES[e.interpolation_type], self._plan(x.shape[0]))
        if self.group is None:
            return _WindowedLookup.apply(x, local_params, levels, windows, meta)
        if x.requires_grad:
            x = _CopyToGroup.apply(x, self.group)
        return _SumOverGroup.apply(_WindowedLookup.apply(x, local_params, levels, windows, meta), self.group)

    def padded_apply(self, local_params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """``apply`` with the encoding's output padding and dtype (a drop-in
        for ``encoding.apply`` in a composed model)."""
        y = self.apply(local_params, x)
        pad = self.encoding.padded_output_width - y.shape[1]
        if pad > 0:
            y = torch.cat([y, y.new_full((y.shape[0], pad), self.encoding.pad_value)], dim=1)
        return y.to(self.encoding.output_dtype)


class TableParallelTrainer:
    """Trains a configured model (grid encoding + network + loss +
    optimizer: ``create_from_config``'s trainer) with every grid level's
    table row-sharded over the mesh's ``model_axis`` dimension, composed with
    batch data parallelism over ``data_axis`` (absent from the mesh: degree
    1). The state lives on this rank's device of the mesh, whatever the
    wrapped trainer's device (a host-side trainer keeps the full table off
    the card).

    A step: the sharded lookup (one ``all_reduce`` of the features over the
    model group), the network, the loss and its explicit gradient scaled by
    the trainer's loss scale, the backward (the windowed table gradient into
    the rank's rows), then ONE ``all_reduce`` over the data group of [network
    gradient | encoding gradient of the rank's rows | loss sum], divided by
    the data degree (the loss normalises by the rank's rows), and the
    optimizer: split at the [network | encoding] boundary into two
    instances of the configured type (exact: every supported optimizer is
    elementwise with behaviour keyed on the matrix boundary; adam.h:78-95),
    the encoding's state of the rank's rows only.

    ``params`` reassembles the reference flat layout on every rank;
    ``sync_to_trainer`` writes params and optimizer state into the wrapped
    trainer through its own setters. Optimizer wrappers with their own
    inference weights (EMA etc.) train as usual, but ``inference`` serves
    the live params, as in the JAX package."""

    def __init__(self, trainer, mesh, model_axis: str = "model", data_axis: str = "data"):
        model = trainer.model
        encoding = getattr(model, "encoding", None)
        if not isinstance(encoding, GridEncoding):
            raise TypeError(
                "TableParallelTrainer requires a NetworkWithInputEncoding with a grid encoding (got "
                f"{type(encoding).__name__ if encoding is not None else type(model).__name__})"
            )
        self.trainer = trainer
        self.model = model
        self.loss = trainer.loss
        self.loss_scale = trainer.loss_scale
        self.mesh = mesh
        self.model_axis = model_axis
        self.data_axis = data_axis
        self.tpg = TableParallelGrid(encoding, mesh, model_axis, data_axis)
        self._dgroup, self._n_data, self._data_index = mesh_axis(mesh, data_axis)
        self.device = _mesh_device(mesh)

        n_net = model.network.n_params
        self._n_net = n_net
        hp = trainer.optimizer.hyperparams()
        self.opt_net = create_optimizer(hp)
        self.opt_net.allocate(n_net, model.layer_sizes())
        self.opt_enc = create_optimizer(hp)
        self.opt_enc.allocate(self.tpg.local_n_params, [])

        flat = trainer.params.detach().cpu().numpy()
        self.net = torch.from_numpy(flat[:n_net].copy()).to(self.device)
        self.enc = torch.from_numpy(self.tpg.local_params(flat[n_net:])).to(self.device)
        self.opt_net_state = self.opt_net.init_state(self.device)
        self.opt_enc_state = self.opt_enc.init_state(self.device)

    def _data_rows(self, a, batch: int) -> torch.Tensor:
        rows = rows_of(self._data_index, self._n_data, batch)
        if isinstance(a, torch.Tensor):
            return a[rows].to(self.device)
        return torch.as_tensor(np.asarray(a)[rows], device=self.device)

    def _forward(self, net, enc, x):
        return self.model.network.apply(net, self.tpg.padded_apply(enc, x))

    def training_step(self, inputs, targets) -> torch.Tensor:
        """One step on the global batch (every rank passes it); returns the
        global loss sum (a 0-d device tensor, not synchronised)."""
        from ..trainer import _copy_into

        batch = inputs.shape[0]
        if batch % self._n_data:
            raise ValueError(f"batch {batch} not divisible by data-parallel degree {self._n_data}")
        x = self._data_rows(inputs, batch).to(torch.float32)
        y = self._data_rows(targets, batch).to(torch.float32)
        net = self.net.detach().requires_grad_(True)
        enc = self.enc.detach().requires_grad_(True)
        with torch.enable_grad():
            out = self._forward(net, enc, x)
        loss_sum, dL_dy = self.loss.evaluate_sum_and_gradient(self.loss_scale, out.detach(), y, None)
        g_net, g_enc = torch.autograd.grad(out, (net, enc), dL_dy.to(out.dtype))
        n_net, n_enc = g_net.numel(), g_enc.numel()
        flat = torch.empty(n_net + n_enc + 1, dtype=torch.float32, device=self.device)
        flat[:n_net] = g_net
        flat[n_net : n_net + n_enc] = g_enc
        flat[-1] = loss_sum
        if self._n_data > 1:
            all_reduce(flat, self._dgroup).div_(self._n_data)
        with torch.no_grad():
            for opt, state, params, grads in (
                (self.opt_net, self.opt_net_state, self.net, flat[:n_net]),
                (self.opt_enc, self.opt_enc_state, self.enc, flat[n_net : n_net + n_enc]),
            ):
                new_state, new_params = opt.step(state, params, grads, self.loss_scale)
                _copy_into(state, new_state)
                if new_params is not params:
                    params.copy_(new_params)
        return flat[-1]

    @torch.no_grad()
    def inference(self, inputs) -> torch.Tensor:
        """(global batch, n_output_dims) fp32 on every rank, from the live
        params: each data shard serves its rows, then they are gathered."""
        batch = inputs.shape[0]
        if batch % self._n_data:
            raise ValueError(f"batch {batch} not divisible by data-parallel degree {self._n_data}")
        out = self._forward(self.net, self.enc, self._data_rows(inputs, batch).to(torch.float32))
        return gather_rows(out[:, : self.model.n_output_dims].to(torch.float32), self._dgroup, self._n_data)

    def _unshard_leaf(self, leaf: torch.Tensor) -> np.ndarray:
        """A per-weight leaf of the encoding's state (last dim local_n_params)
        in the flat layout, gathered over the model group."""
        if leaf.dim() == 1:
            return self._unshard(leaf)
        return np.stack([self._unshard(r) for r in leaf])

    def _unshard(self, local: torch.Tensor) -> np.ndarray:
        """A vector of this rank's rows, gathered over the model group into
        the flat layout (host-side, its dtype kept)."""
        stack = gather_rows(local, self.tpg.group, self.tpg.n_shards)
        return self.tpg._relayout(stack.cpu().numpy(), False)

    @property
    def params(self) -> np.ndarray:
        """Reference flat layout ``[network | encoding]`` (host-side, on
        every rank; object.h:74-80)."""
        return np.concatenate([self.net.cpu().numpy(), self._unshard(self.enc)])

    def sync_to_trainer(self):
        """Write params AND optimizer state into the wrapped trainer, through
        its ``params`` and ``opt_state`` setters (checkpoint and serving
        handoff: an EMA wrapper's inference weights come from the state).
        Every rank of the model group takes part."""
        t = self.trainer
        t.params = torch.from_numpy(self.params)
        n_net, n_enc = self._n_net, self.tpg.local_n_params

        def join(net_leaf, enc_leaf):
            if net_leaf.dim() >= 1 and net_leaf.shape[-1] == n_net and enc_leaf.shape[-1] == n_enc:
                enc = self._unshard_leaf(enc_leaf)
                return torch.from_numpy(np.concatenate([net_leaf.cpu().numpy(), enc], axis=-1)).to(t.device)
            return net_leaf.to(t.device)  # scalars: the lockstep counters

        t.opt_state = tree_map(join, self.opt_net_state, self.opt_enc_state)
        return t

    @property
    def learning_rate(self) -> float:
        return self.opt_net.learning_rate

    @learning_rate.setter
    def learning_rate(self, value: float):
        self.trainer.learning_rate = value
        self.opt_net.learning_rate = value
        self.opt_enc.learning_rate = value

    def update_hyperparams(self, params: Dict):
        self.trainer.update_hyperparams(params)
        opt_hp = params.get("optimizer", {})
        if opt_hp:
            self.opt_net.update_hyperparams(opt_hp)
            self.opt_enc.update_hyperparams(opt_hp)
