"""Trainer (port of ``tcnn_tpu.trainer``; reference: trainer.h).

The trainer owns the model's flat fp32 parameters (the model's
``nn.Parameter``), the loss, the optimizer and its state. One training step
is: the forward through the grid and MLP kernels, the loss and its explicit
gradient scaled by ``loss_scale`` (trainer.h:137), the backward through the
MLP and grid backward kernels (torch autograd over the kernels' Functions),
and the optimizer step, which divides the scale back out. The step's
results land in the tensors the trainer already holds (the parameter and
every leaf of ``opt_state``, in place or by ``copy_``), so their addresses
stay fixed from step to step. ``training_step`` returns the summed loss as
a 0-d device tensor without a host synchronisation.
``training_step_plain`` runs the same step through every kernel's plain
version, on any device: the reference the kernel path is checked against.

``training_steps(batch_fn, n_steps)`` runs many steps at once. On the card
it captures one step, the batch included, into a ``torch.cuda.CUDAGraph``
and replays it (the reference's CUDA-graph capture and replay of the step,
trainer.h:344-350; the JAX package's jitted ``lax.scan``); on the CPU it
runs the same steps as a loop. A captured graph reads the tensors it was
captured with, so whatever replaces them (``initialize_params``,
``opt_state``, ``deserialize``, ``utils.checkpoint.load_npz``) or changes a
hyperparameter baked into a kernel's arguments (``learning_rate``,
``update_hyperparams``) drops the captured graphs, as the JAX package drops
its jitted programs.

``perturbation_sigma`` adds logistic noise to the output the loss sees
(reference: trainer.h:114-123), drawn from the trainer's own generator on
its device, seeded from ``seed``; a captured step registers it, so each
replay draws anew.

Checkpoints: ``serialize`` / ``deserialize`` give and take the reference's
snapshot layout (``interchange``); ``utils.checkpoint`` has the npz form.

The serving half: ``inference`` for arbitrary batches, ``inference_raster``
for the full tile-center raster and ``freeze_serving`` for a snapshot, all
over ``inference_params()`` (the EMA, average or lookahead weights when the
optimizer keeps them).
"""

from __future__ import annotations

import base64
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from . import interchange
from .common import default_loss_scale
from .losses import create_loss
from .optimizers import create_optimizer
from .optimizers.base import tree_leaves, tree_map
from .rng import make_rng


def _copy_into(dst, src):
    """Write the state tree ``src`` into the tensors of ``dst`` (same
    structure), skipping leaves already updated in place."""
    tree_map(lambda d, s: d if s is d else d.copy_(s), dst, src)


class _CapturedSteps:
    """One training step captured as a CUDA graph: replayed once per step,
    it draws the batch for the device step counter ``counter``, trains on
    it, writes the loss to ``losses[counter]`` and increments ``counter``.
    It holds ``batch_fn`` and the leaves of ``data`` it was captured with,
    so that neither their memory nor the id of ``batch_fn`` can be reused
    while the graph may replay."""

    def __init__(self, graph, counter, losses, batch_fn, leaves):
        self.graph, self.counter, self.losses = graph, counter, losses
        self.batch_fn, self.leaves = batch_fn, leaves

    def reads(self, leaves) -> bool:
        """Whether ``leaves`` (of a new ``data``) are the ones captured."""
        return len(leaves) == len(self.leaves) and all(
            a is b or (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor) and a.data_ptr() == b.data_ptr())
            for a, b in zip(leaves, self.leaves)
        )


class Trainer:
    def __init__(
        self,
        model,
        optimizer=None,
        loss=None,
        seed: int = 1337,
        loss_scale: Optional[float] = None,
        perturbation_sigma: Optional[float] = None,
        split_grid_state: bool = False,
    ):
        """The JAX package's ``Trainer(model, optimizer, loss, ...)``
        (tcnn_tpu/trainer.py:34-43): ``optimizer`` an ``Optimizer`` or an
        optimizer config dict, ``loss`` a ``Loss`` or a loss config dict
        (None: the config's defaults). ``optimizer_config`` and
        ``loss_config`` keep the dict given, or the object's
        ``hyperparams()``."""
        if split_grid_state:
            raise NotImplementedError(
                "Trainer: split_grid_state is a TPU layout of the JAX package and is not ported "
                "(ROADMAP.md, not to port)"
            )
        self._graphs: Dict[tuple, _CapturedSteps] = {}
        self.model = model
        if optimizer is None or isinstance(optimizer, Mapping):
            self.optimizer_config = dict(optimizer or {})
            self.optimizer = create_optimizer(self.optimizer_config)
        else:
            self.optimizer, self.optimizer_config = optimizer, optimizer.hyperparams()
        if loss is None or isinstance(loss, Mapping):
            self.loss_config = dict(loss or {})
            self.loss = create_loss(self.loss_config)
        else:
            self.loss, self.loss_config = loss, loss.hyperparams()
        self.loss_scale = float(loss_scale) if loss_scale is not None else default_loss_scale(model.compute_dtype)
        self.perturbation_sigma = perturbation_sigma
        self.perturbation_generator: Optional[torch.Generator] = None
        self.optimizer.allocate(model.n_params, model.layer_sizes())
        self.initialize_params(seed)

    @property
    def device(self) -> torch.device:
        return self.model.params.device

    def initialize_params(self, seed: int = 1337):
        """PCG32 init, bit-identical to the JAX package's (reference:
        trainer.h:69-87), and a fresh optimizer state."""
        params = self.model.initialize_params(make_rng(seed))
        if params.shape != (self.model.n_params,):
            raise RuntimeError(f"initialize_params: got {params.shape}, expected ({self.model.n_params},)")
        self.params = params
        self.opt_state = self.optimizer.init_state(self.device)
        if self.perturbation_sigma is not None:
            self.perturbation_generator = torch.Generator(device=self.device).manual_seed(int(seed))

    @property
    def opt_state(self) -> Dict[str, Any]:
        """The optimizer's state tree; assigning it drops the captured
        training steps, whose graphs read the tensors it replaces."""
        return self._opt_state

    @opt_state.setter
    def opt_state(self, value):
        self._opt_state = value
        self._graphs.clear()

    @property
    def params(self) -> torch.Tensor:
        """The flat fp32 parameter vector (the model's ``nn.Parameter`` data)."""
        return self.model.params.data

    @params.setter
    def params(self, value):
        value = torch.as_tensor(value, dtype=torch.float32)
        if value.shape != (self.model.n_params,):
            raise ValueError(f"params: got shape {tuple(value.shape)}, model has {self.model.n_params} params")
        with torch.no_grad():
            self.model.params.copy_(value)

    @property
    def n_params(self) -> int:
        return self.model.n_params

    def inference_params(self) -> torch.Tensor:
        """Custom (EMA, averaged, lookahead) weights if the optimizer keeps
        them, else the training params (reference: trainer.h:496-500)."""
        cw = self.optimizer.custom_weights(self.opt_state)
        if cw is None:
            return self.params
        if callable(cw):  # Composite stitches its ranges with the live params
            return cw(self.params)
        return cw

    # -- training ------------------------------------------------------------
    def _as_input(self, inputs) -> torch.Tensor:
        """Positions on the trainer's device: fp32, except uint32 ones
        (a fixed_point_pos grid's), which pass as they are, as the JAX
        trainer passes its inputs."""
        x = torch.as_tensor(inputs, device=self.device)
        return x if x.dtype == torch.uint32 else x.to(torch.float32)

    def perturbation_uniforms(self, batch: int, width: int) -> torch.Tensor:
        """The (batch, width) fp32 uniforms of one step's output noise, in
        [1e-9, 1) as the JAX package's ``jax.random.uniform(key, shape,
        float32, 1e-9, 1 - 1e-9)`` gives them, drawn from
        ``perturbation_generator``. An instance attribute of the same name
        replaces the draw (a test hands over the JAX package's)."""
        u = torch.rand((batch, width), generator=self.perturbation_generator, device=self.device) + 1e-9
        return torch.clamp_min(u, 1e-9)

    def _perturbed(self, out: torch.Tensor, shard=None) -> torch.Tensor:
        """The output the loss sees: with ``perturbation_sigma``, plus
        sigma * sqrt(3) / pi * log(u / (1 - u)) in fp32, back in the
        output's dtype (tcnn_tpu/trainer.py:243-266, 220-224); the loss's
        gradient with respect to it is taken as the output's. ``shard`` =
        (index, count): ``out`` is rows index * B .. (index + 1) * B of a
        global batch of count * B, whose uniforms are drawn and cut to
        them (data parallelism: every rank's generator stays in lockstep)."""
        if self.perturbation_sigma is None:
            return out
        if shard is None:
            u = self.perturbation_uniforms(out.shape[0], out.shape[1])
        else:
            index, count = shard
            b = out.shape[0]
            u = self.perturbation_uniforms(b * count, out.shape[1])[index * b : (index + 1) * b]
        noise = float(self.perturbation_sigma * 0.551328895421792050) * torch.log(u / (1.0 - u))
        return (out.to(torch.float32) + noise).to(out.dtype)

    def _backward(self, inputs, plain: bool, output_gradient):
        """Forward with autograd, then the parameter gradient for the output
        gradient ``output_gradient(output)`` -> (dL_doutput, aux)."""
        x = self._as_input(inputs)
        params = self.model.params
        apply = self.model.apply_plain if plain else self.model.apply
        with torch.enable_grad():
            out = apply(params, x)
        dL_dy, aux = output_gradient(out.detach())
        (grads,) = torch.autograd.grad(out, params, dL_dy.to(out.dtype))
        return grads, aux

    def _optimizer_step(self, grads, plain: bool, loss_scale: Optional[float] = None):
        """The optimizer's step for ``grads`` (scaled by ``loss_scale``,
        default the trainer's), its results written into the trainer's
        tensors. The samples that take their own loss's gradient call it
        with loss scale 1, as the JAX samples call ``optimizer.step``."""
        params = self.model.params.data
        scale = self.loss_scale if loss_scale is None else loss_scale
        with torch.no_grad():
            new_state, new_params = self.optimizer.step(self._opt_state, params, grads, scale, plain=plain)
            _copy_into(self._opt_state, new_state)
            if new_params is not params:
                params.copy_(new_params)

    def _loss_gradient(self, targets, data_pdf, shard=None):
        """The output gradient of a step, ``out -> (dL_doutput, loss sum)``,
        for ``_backward`` (``shard``: see ``_perturbed``)."""
        y = torch.as_tensor(targets, dtype=torch.float32, device=self.device)
        pdf = None if data_pdf is None else torch.as_tensor(data_pdf, dtype=torch.float32, device=self.device)

        def loss_gradient(out):
            loss_sum, dL_dy = self.loss.evaluate_sum_and_gradient(self.loss_scale, self._perturbed(out, shard), y, pdf)
            return dL_dy, loss_sum

        return loss_gradient

    def _step(self, inputs, targets, data_pdf, plain: bool) -> torch.Tensor:
        grads, loss_sum = self._backward(inputs, plain, self._loss_gradient(targets, data_pdf))
        self._optimizer_step(grads, plain)
        return loss_sum

    def training_step(self, inputs, targets, data_pdf=None) -> torch.Tensor:
        """One training iteration (trainer.h:97-141); returns the summed loss
        as a 0-d tensor on the device, without synchronising."""
        return self._step(inputs, targets, data_pdf, plain=False)

    def training_step_plain(self, inputs, targets, data_pdf=None) -> torch.Tensor:
        """``training_step`` through every kernel's plain torch version, on
        any device (on the CPU the two are the same)."""
        return self._step(inputs, targets, data_pdf, plain=True)

    # A captured graph per (n_steps, batch_fn, data or not); bounded, as
    # the JAX package bounds its scan programs, so that fresh per-call
    # lambdas cannot grow it (each graph pins its memory pool).
    _GRAPH_CACHE_MAX = 8

    def training_steps(self, batch_fn, n_steps: int, data=None) -> torch.Tensor:
        """Run ``n_steps`` training iterations; returns the ``(n_steps,)``
        fp32 losses on the device, without synchronising (reference:
        trainer.h:344-350; the JAX package's ``Trainer.training_steps``).

        ``batch_fn`` returns ``(inputs, targets)`` for one step. It is
        called ``batch_fn(data, i)`` when ``data`` is given, else
        ``batch_fn(i)``, with ``i`` the step index as a 0-d int32 tensor on
        the trainer's device. On the card one step is captured into a CUDA
        graph and replayed ``n_steps`` times; ``i`` is then incremented on
        the device, and ``batch_fn`` runs only at the capture, so it must
        draw on the device and read no host state that changes between
        steps (as the JAX package's traced ``batch_fn``). Every
        ``torch.Generator`` among the leaves of ``data`` (a tensor, a
        generator, or dicts, lists and tuples of them) is registered with
        the graph, so each replay draws anew; tensors in ``data`` are read
        where they lie, and new ones for the same ``batch_fn`` capture
        again. Capture warms up one step on a side stream first, with the
        params, the optimizer state and the generators restored after it.
        A step that cannot be captured raises. On the CPU the same steps
        run as a loop."""
        n_steps = int(n_steps)
        if n_steps < 1:
            raise ValueError(f"training_steps: n_steps must be >= 1, got {n_steps}")
        if self.device.type == "cpu":
            losses = []
            i = torch.zeros((), dtype=torch.int32)
            for _ in range(n_steps):
                inputs, targets = batch_fn(i) if data is None else batch_fn(data, i)
                losses.append(self._step(inputs, targets, None, plain=False).to(torch.float32))
                i = i + 1
            return torch.stack(losses)
        if self.device.type != "cuda":
            raise ValueError(f"training_steps: unsupported device {self.device}")
        key = (n_steps, id(batch_fn), data is None)
        leaves = tree_leaves(data)
        entry = self._graphs.get(key)
        if entry is None or not entry.reads(leaves):
            self._graphs.pop(key, None)
            if len(self._graphs) >= self._GRAPH_CACHE_MAX:
                self._graphs.pop(next(iter(self._graphs)))
            entry = self._graphs[key] = self._capture(batch_fn, n_steps, data, leaves)
        entry.counter.zero_()
        for _ in range(n_steps):
            entry.graph.replay()
        return entry.losses.clone()

    def _capture(self, batch_fn, n_steps: int, data, leaves) -> _CapturedSteps:
        dev = self.device
        generators = [g for g in leaves if isinstance(g, torch.Generator)]
        if self.perturbation_generator is not None:
            generators.append(self.perturbation_generator)
        counter = torch.zeros((), dtype=torch.int32, device=dev)
        losses = torch.zeros((n_steps,), dtype=torch.float32, device=dev)

        def step():
            x, y = batch_fn(counter) if data is None else batch_fn(data, counter)
            loss = self._step(x, y, None, plain=False)
            losses.index_copy_(0, counter.reshape(1).to(torch.int64), loss.reshape(1).to(torch.float32))
            counter.add_(1)

        # Warm-up, as capture requires: builds and loads the kernels and
        # fills the encoding's level, class and plan caches, whose first
        # use copies to the device. Its step is undone afterwards.
        params = self.params.clone()
        opt_state = tree_map(torch.clone, self._opt_state)
        rng = [g.get_state() for g in generators], torch.cuda.get_rng_state(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream(dev).wait_stream(side)
        with torch.no_grad():
            self.params.copy_(params)
            _copy_into(self._opt_state, opt_state)
        for g, state in zip(generators, rng[0]):
            g.set_state(state)
        torch.cuda.set_rng_state(rng[1], dev)
        counter.zero_()
        graph = torch.cuda.CUDAGraph()
        for g in generators:
            graph.register_generator_state(g)
        try:
            with torch.cuda.graph(graph):
                step()
        except BaseException:
            # A failed capture leaves the generators it registered in
            # capture mode (CUDAGraph.capture_end raises before their
            # epilogue), and every later draw from them raises: give each a
            # fresh state, at the seed and offset it had before the capture.
            default = torch.cuda.default_generators[dev.index if dev.index is not None else torch.cuda.current_device()]
            for g, state in zip([default, *generators], [rng[1], *rng[0]]):
                g.graphsafe_set_state(torch.Generator(device=g.device))
                g.set_state(state)
            raise
        return _CapturedSteps(graph, counter, losses, batch_fn, leaves)

    def training_step_with_gradients(self, inputs, dL_doutput):
        """One optimizer step from external output gradients, shape (batch,
        padded_output_width), pre-scaled by ``loss_scale`` (trainer.h:127-138)."""
        dL = torch.as_tensor(dL_doutput, device=self.device)
        grads, _ = self._backward(inputs, False, lambda out: (dL, None))
        self._optimizer_step(grads, plain=False)

    @torch.no_grad()
    def forward(self, inputs) -> torch.Tensor:
        """Training-params forward, padded output in the compute dtype."""
        return self.model.apply(self.params, self._as_input(inputs))

    def evaluate_loss(self, inputs, targets, data_pdf=None):
        """Per-element loss values (batch, padded width) and their sum,
        without stepping."""
        out = self.forward(inputs)
        y = torch.as_tensor(targets, dtype=torch.float32, device=self.device)
        pdf = None if data_pdf is None else torch.as_tensor(data_pdf, dtype=torch.float32, device=self.device)
        values, _ = self.loss.evaluate(self.loss_scale, out, y, pdf)
        return values, torch.sum(values)

    @property
    def learning_rate(self) -> float:
        return self.optimizer.learning_rate

    @learning_rate.setter
    def learning_rate(self, value: float):
        self.optimizer.learning_rate = value
        self._graphs.clear()  # the learning rate is baked into captured steps

    def update_hyperparams(self, params: Dict):
        """Update the optimizer's, the loss's and the model's hyperparameters
        from a config of the ``create_from_config`` form (keys
        ``optimizer``, ``loss``, ``encoding``, ``network``); captured
        training steps are dropped, as they bake the old values in."""
        self.optimizer.update_hyperparams(params.get("optimizer", {}))
        self.loss.update_hyperparams(params.get("loss", {}))
        if hasattr(self.model, "update_hyperparams"):
            self.model.update_hyperparams(params)
        self._graphs.clear()

    # -- serving -------------------------------------------------------------
    def _inference_kwargs(self) -> Dict[str, Any]:
        """Serving batches are arbitrary layouts: under the grid's
        "stratified" gather strategy a batch is not taken for the stratified
        layout (the JAX package's ``Trainer._inference_kwargs``), which
        decides the levels its encoding's own ``table_dtype`` rounds."""
        enc = getattr(self.model, "encoding", None)
        if getattr(enc, "gather_strategy", None) == "stratified":
            return {"stratified": False}
        return {}

    @torch.no_grad()
    def inference(self, inputs, stratified: bool = False) -> torch.Tensor:
        """Serving path: inference params, trimmed fp32 output of shape
        (batch, n_output_dims) (reference: object.h:214-271).
        ``stratified=True`` opts in to reading a batch that has the
        stratified raster-tile layout as such, as the JAX package's
        ``inference(x, stratified=True)`` does."""
        kwargs = {} if stratified else self._inference_kwargs()
        out = self.model.apply(self.inference_params(), self._as_input(inputs), **kwargs)
        return out[:, : self.model.n_output_dims].to(torch.float32)

    @torch.no_grad()
    def inference_raster(self, side) -> torch.Tensor:
        """Full-raster evaluation: trimmed fp32 output of shape
        (prod(sides), n_output_dims) in raster order (dim 0 fastest,
        ``utils.sampling.raster_centers``). ``side`` is an int or a per-dim
        tuple, e.g. ``(w, h)`` for an image."""
        side = int(side) if np.isscalar(side) else tuple(int(s) for s in side)
        out = self.model.apply_raster(self.inference_params(), side)
        return out[:, : self.model.n_output_dims].to(torch.float32)

    def freeze_serving(self, mesh=None, axis_name: str = "data", table_dtype: Optional[str] = None):
        """Production serving handle over a snapshot of the inference params
        (see ``serving.FrozenServer``); with a ``mesh``, every rank serves
        its rows of each batch or raster and returns the whole output."""
        from .serving import FrozenServer

        return FrozenServer(self, mesh=mesh, axis_name=axis_name, table_dtype=table_dtype)

    # -- serialization (reference: trainer.h:442-482) -------------------------
    def serialize(self, serialize_optimizer: bool = False) -> Dict:
        """Reference-layout snapshot ``{n_params, params_type,
        params_binary, optimizer?}``, optimizer state in each optimizer's
        own format (``interchange``). Binary blobs are nlohmann text-JSON
        binary objects (``{"bytes": [...]}``), so ``json.dumps`` of the
        result is what the reference's ``nlohmann::json`` parses; use
        ``interchange.to_msgpack(interchange.serialize_trainer(...))`` for
        the MessagePack spelling."""
        return interchange.to_json_obj(interchange.serialize_trainer(self, serialize_optimizer))

    def deserialize(self, blob: Dict):
        """Takes reference-layout snapshots (text-JSON or msgpack-decoded)
        and the JAX package's legacy base64 format."""
        if isinstance(blob.get("params_binary"), str):
            # Legacy format: base64 params and an __ndarray__ optimizer tree.
            n = int(blob["n_params"])
            if n != self.model.n_params:
                raise ValueError(f"checkpoint has {n} params, model has {self.model.n_params}")
            dtype = np.float16 if blob.get("params_type") == "half" else np.float32
            params = np.frombuffer(base64.b64decode(blob["params_binary"]), dtype=dtype).astype(np.float32)
            self.params = torch.from_numpy(params)
            if "optimizer" in blob:
                self.opt_state = _tree_from_json(blob["optimizer"], self.optimizer.init_state(self.device))
            return
        interchange.deserialize_trainer(self, interchange.from_json_obj(blob))


def _tree_from_json(blob, template):
    """Legacy optimizer-state reader: ``{"__ndarray__": base64, "dtype",
    "shape"}`` leaves, on the device of ``template``'s leaves."""
    if isinstance(blob, dict) and "__ndarray__" in blob:
        arr = np.frombuffer(base64.b64decode(blob["__ndarray__"]), dtype=np.dtype(blob["dtype"])).reshape(blob["shape"])
        return torch.from_numpy(arr.copy()).to(template.device)
    if isinstance(blob, dict):
        return {k: _tree_from_json(v, template[k]) for k, v in blob.items()}
    if isinstance(blob, list):
        return [_tree_from_json(v, template[i]) for i, v in enumerate(blob)]
    return blob
