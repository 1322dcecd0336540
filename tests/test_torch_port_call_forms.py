"""The JAX package's call forms on the port: code written against
``tcnn_tpu`` calls the port's same-named functions the same way, by
position where the JAX signature is positional.

Each case builds the same configuration in both packages (PCG32 init is
bit-identical), feeds the same numpy inputs and calls the JAX form on both
sides:

- ``Trainer(model, optimizer, loss)`` with ``Optimizer`` and ``Loss``
  objects, ``create_from_config(2, 3, cfg, 1337, None, False)`` and
  ``TrainableModel(model=, trainer=, loss=, optimizer=)``: two training
  steps, per-step loss within ``match_rae(1e-2)`` and params within
  ``match_rae(1e-2, percentile=99)``, as test_torch_port_training.py's
  stochastic-interpolation case holds a training step;
- ``GridEncoding(2, 8, 10, 8, 2.0, True)`` (the sixth positional is
  ``stochastic_interpolation``, the last ``fixed_point_pos``) and the
  grid's ``apply(p, x, 0.5)`` / ``apply_raster(p, side, 0.5)``: bitwise;
- ``CompositeEncoding.apply(p, x, None)``: max |diff| <= 1e-5 max |ref|, as
  test_torch_port_composite.py's forward;
- ``FullyFusedMLP(..., use_pallas=True, layout="cf")``: the JAX Pallas
  kernel in interpret mode against the port's plain chain, the bf16
  tolerance of test_torch_port_ffmlp.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from utils import match_rae

import tcnn_tpu as tc
import tcnn_tpu.common as jcommon
import tcnn_tpu.encodings as jenc
import tcnn_tpu.networks as jnets
import tcnn_tpu_torch as tt
import tcnn_tpu_torch.common as tcommon
import tcnn_tpu_torch.encodings as tenc
import tcnn_tpu_torch.networks as tnets
from tcnn_tpu.encodings.grid import GridEncoding as JaxGrid
from tcnn_tpu.network_with_input_encoding import NetworkWithInputEncoding as JaxNWIE
from tcnn_tpu.ops.pallas_utils import set_interpret_mode
from tcnn_tpu_torch.encodings.grid import GridEncoding as TorchGrid
from tcnn_tpu_torch.network_with_input_encoding import NetworkWithInputEncoding as TorchNWIE

from test_torch_port_composite import COMPOSITES, FWD_RTOL, _close_to_max, _pair, _params, _points
from test_torch_port_ffmlp import assert_bf16_close

CONFIG = {
    "loss": {"otype": "RelativeL2"},
    "optimizer": {"otype": "Adam", "learning_rate": 1e-2, "beta1": 0.9, "beta2": 0.99, "epsilon": 1e-15},
    "encoding": {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2, "log2_hashmap_size": 8,
                 "base_resolution": 4, "per_level_scale": 1.5},
    "network": {"otype": "FullyFusedMLP", "activation": "ReLU", "output_activation": "None", "n_neurons": 32,
                "n_hidden_layers": 2},
}
N_STEPS = 2
BATCH = 256


def _batches():
    r = np.random.default_rng(0)
    out = []
    for _ in range(N_STEPS):
        xy = r.uniform(0, 1, (BATCH, 2)).astype(np.float32)
        out.append((xy, np.stack([xy[:, 0], xy[:, 1], xy[:, 0] * xy[:, 1]], 1).astype(np.float32)))
    return out


def _train(step, batches):
    return [float(step(x, t)) for x, t in batches]


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's losses and params: ``Trainer(model, optimizer,
    loss)`` with objects, as its ``create_from_config`` builds it."""
    model = JaxNWIE(2, 3, CONFIG["encoding"], CONFIG["network"])
    trainer = tc.Trainer(model, tc.create_optimizer(CONFIG["optimizer"]), tc.create_loss(CONFIG["loss"]))
    losses = _train(trainer.training_step, _batches())
    return losses, np.asarray(trainer.params)


def _port_trainer_objects():
    model = TorchNWIE(2, 3, CONFIG["encoding"], CONFIG["network"], device="cpu")
    optimizer, loss = tt.create_optimizer(CONFIG["optimizer"]), tt.create_loss(CONFIG["loss"])
    trainer = tt.Trainer(model, optimizer, loss)
    assert trainer.optimizer is optimizer and trainer.loss is loss
    assert trainer.optimizer_config == optimizer.hyperparams() and trainer.loss_config == loss.hyperparams()
    return trainer.training_step, trainer.params


def _port_create_from_config():
    m = tt.create_from_config(2, 3, CONFIG, 1337, None, False, device="cpu")
    assert isinstance(m, tt.TrainableModel)
    assert m.loss is m.trainer.loss and m.optimizer is m.trainer.optimizer
    assert m.trainer.optimizer_config == CONFIG["optimizer"] and m.trainer.loss_config == CONFIG["loss"]
    return m.training_step, m.trainer.params


def _port_trainable_model():
    model = TorchNWIE(2, 3, CONFIG["encoding"], CONFIG["network"], device="cpu")
    trainer = tt.Trainer(model, CONFIG["optimizer"], CONFIG["loss"], 1337)
    m = tt.TrainableModel(model=model, trainer=trainer, loss=trainer.loss, optimizer=trainer.optimizer)
    return m.training_step, m.params


@pytest.mark.parametrize("form", ["Trainer(model, optimizer, loss)", "create_from_config(2, 3, cfg, 1337, None, False)",
                                  "TrainableModel(model=, trainer=, loss=, optimizer=)"])
def test_training_call_forms_match_jax(jax_run, form):
    """Two training steps of the port built by the JAX call form against
    the JAX package's."""
    build = {"Trainer(model, optimizer, loss)": _port_trainer_objects,
             "create_from_config(2, 3, cfg, 1337, None, False)": _port_create_from_config,
             "TrainableModel(model=, trainer=, loss=, optimizer=)": _port_trainable_model}[form]
    step, params = build()
    want_losses, want_params = jax_run
    match_rae(np.asarray(_train(step, _batches())), np.asarray(want_losses), 1e-2)
    match_rae(params.numpy(), want_params, 1e-2, percentile=99)


def test_create_from_config_positional_split_grid_state_and_device(monkeypatch):
    """The sixth positional is ``split_grid_state`` on both sides: False
    reaches the port's device default (the card; without one the port's
    own error, not torch.device's TypeError), True raises in the port's
    Trainer as a TPU layout it does not port."""
    with pytest.raises(NotImplementedError, match="split_grid_state"):
        tt.create_from_config(2, 3, CONFIG, 1337, None, True, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.create_from_config(2, 3, CONFIG, 1337, None, False)


def test_trainer_dicts_stay_a_port_convenience():
    """Config dicts in the JAX order (optimizer, then loss) build the same
    objects; ``optimizer_config`` / ``loss_config`` keep the dicts."""
    model = TorchNWIE(2, 3, CONFIG["encoding"], CONFIG["network"], device="cpu")
    trainer = tt.Trainer(model, CONFIG["optimizer"], CONFIG["loss"])
    assert trainer.optimizer.otype == "Adam" and trainer.loss.otype == "RelativeL2"
    assert trainer.optimizer_config == CONFIG["optimizer"] and trainer.loss_config == CONFIG["loss"]
    assert trainer.optimizer.hyperparams() == tt.create_optimizer(CONFIG["optimizer"]).hyperparams()


def _grid_pair(*args):
    je, te = JaxGrid(*args), TorchGrid(*args)
    je.output_dtype, te.output_dtype = jnp.float32, torch.float32
    params = (je.initialize_params(tc.rng.make_rng(3), 1.0) * 1e4).astype(np.float32)
    return je, te, params


def test_grid_encoding_positional_stochastic_interpolation():
    """``GridEncoding(2, 8, 10, 8, 2.0, True)``: the sixth positional sets
    stochastic interpolation and keeps Linear interpolation; the forward
    is the deterministic lookup on both sides, bitwise."""
    je, te, params = _grid_pair(2, 8, 10, 8, 2.0, True)
    for enc in (je, te):
        assert enc.stochastic_interpolation and not enc.fixed_point_pos
    assert te.interpolation_type.value == je.interpolation_type.value == "Linear"
    x = _points(200, 2, seed=1)
    want = np.asarray(je.apply(jnp.asarray(params), jnp.asarray(x)))
    np.testing.assert_array_equal(te.apply(torch.from_numpy(params), torch.from_numpy(x)).numpy(), want)


def test_grid_encoding_positional_fixed_point_pos():
    """The eleventh positional is ``fixed_point_pos``: uint32 positions on
    both sides, bitwise."""
    args = (2, 8, 10, 8, 2.0, False, jcommon.InterpolationType.Linear, jcommon.GridType.Hash,
            jcommon.HashType.CoherentPrime, 2, True)
    targs = (2, 8, 10, 8, 2.0, False, tcommon.InterpolationType.Linear, tcommon.GridType.Hash,
             tcommon.HashType.CoherentPrime, 2, True)
    je, te = JaxGrid(*args), TorchGrid(*targs)
    je.output_dtype, te.output_dtype = jnp.float32, torch.float32
    assert je.fixed_point_pos and te.fixed_point_pos and not te.stochastic_interpolation
    params = (je.initialize_params(tc.rng.make_rng(4), 1.0) * 1e4).astype(np.float32)
    x = np.random.default_rng(2).integers(0, 2**32, (200, 2), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(je.apply(jnp.asarray(params), jnp.asarray(x)))
    got = te.apply(torch.from_numpy(params), torch.from_numpy(x.astype(np.int64)).to(torch.uint32)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("call", ["apply(p, x, 0.5)", "apply(p, x, 0.5, None, False)", "apply_raster(p, 16, 0.5)",
                                  "apply(p, x, served_tables=, raster_side=)"])
def test_grid_apply_positional_forms_match_jax(call):
    """``apply``'s third positional is ``max_level`` (then ``rng``,
    ``stratified``), ``apply_raster``'s too; ``served_tables`` and
    ``raster_side`` pick TPU paths of the same function and are accepted
    and ignored by the port. Bitwise."""
    cfg = {"otype": "HashGrid", "n_levels": 8, "n_features_per_level": 2, "log2_hashmap_size": 10,
           "base_resolution": 8, "per_level_scale": 1.5}
    je, te = jenc.create_encoding(2, cfg, alignment=16), tenc.create_encoding(2, cfg, alignment=16)
    je.output_dtype, te.output_dtype = jnp.float32, torch.float32
    params = (je.initialize_params(tc.rng.make_rng(5), 1.0) * 1e4).astype(np.float32)
    jp, tp = jnp.asarray(params), torch.from_numpy(params)
    x = _points(256, 2, seed=3)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if call == "apply(p, x, 0.5)":
        want, got = je.apply(jp, jx, 0.5), te.apply(tp, tx, 0.5)
    elif call == "apply(p, x, 0.5, None, False)":
        want, got = je.apply(jp, jx, 0.5, None, False), te.apply(tp, tx, 0.5, None, False)
    elif call == "apply_raster(p, 16, 0.5)":
        want, got = je.apply_raster(jp, 16, 0.5), te.apply_raster(tp, 16, 0.5)
    else:
        tables = je.serving_tables(jp)
        want = je.apply(jp, jx, stratified=False, served_tables=tables)
        got = te.apply(tp, tx, served_tables=tables, raster_side=16)
        np.testing.assert_array_equal(te.apply_plain(tp, tx, served_tables=tables).numpy(), got.numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_composite_apply_positional_served_tables():
    """``CompositeEncoding.apply(p, x, None)``: the third positional is the
    JAX package's ``served_tables``, not the port's ``table_dtype``."""
    n, cfg, align = COMPOSITES["nerf"]
    je, te = _pair(n, cfg, align)
    params = _params(je, seed=7) * 1e4
    x = _points(300, n, seed=4)
    want = np.asarray(je.apply(jnp.asarray(params), jnp.asarray(x), None))
    got = te.apply(torch.from_numpy(params), torch.from_numpy(x), None)
    _close_to_max(got.numpy(), want, FWD_RTOL)
    np.testing.assert_array_equal(te.apply_plain(torch.from_numpy(params), torch.from_numpy(x), None).numpy(),
                                  got.numpy())


@pytest.mark.parametrize("use_pallas,layout", [(True, "cf"), (True, "rm"), (False, None)])
def test_fully_fused_mlp_use_pallas_and_layout(use_pallas, layout):
    """``FullyFusedMLP(..., use_pallas=, layout=)`` on both sides:
    ``use_pallas`` selects the port's kernel path (its plain chain on the
    CPU) as ``use_kernel``, ``layout`` is accepted; the outputs agree
    within the bf16 tolerance of test_torch_port_ffmlp.py."""
    kw = dict(n_neurons=64, n_hidden_layers=2, use_pallas=use_pallas, layout=layout)
    jnet = jnets.FullyFusedMLP(32, 3, **kw)
    tnet = tnets.FullyFusedMLP(32, 3, **kw)
    assert tnet.use_kernel is use_pallas
    r = np.random.default_rng(6)
    params = np.concatenate([r.uniform(-1, 1, a * b).astype(np.float32) * np.float32(2 / np.sqrt(b))
                             for a, b in jnet.layer_sizes()])
    x = r.uniform(-1, 1, (256, 32)).astype(np.float32)
    set_interpret_mode(True)
    try:
        want = np.asarray(jnet.apply(jnp.asarray(params), jnp.asarray(x)), np.float32)
    finally:
        set_interpret_mode(None)
    got = tnet.apply(torch.from_numpy(params), torch.from_numpy(x)).float().numpy()
    assert_bf16_close(got, want)


def test_fully_fused_mlp_positional_use_pallas_and_bad_layout():
    """The eighth positional is the JAX package's ``use_pallas``, the
    port's ``use_kernel``: the same meaning; an invalid ``layout`` raises
    ValueError as in the JAX package."""
    args = (32, 3, 64, 2, tcommon.Activation.ReLU, tcommon.Activation.NONE, 16, False)
    assert not tnets.FullyFusedMLP(*args).use_kernel
    assert tnets.FullyFusedMLP(*args[:7], None).use_kernel
    with pytest.raises(ValueError, match="layout"):
        jnets.FullyFusedMLP(32, 3, 64, 2, layout="nchw")
    with pytest.raises(ValueError, match="layout"):
        tnets.FullyFusedMLP(32, 3, 64, 2, layout="nchw")
    with pytest.raises(ValueError, match="layout"):
        tnets.create_network(32, 3, {"otype": "FullyFusedMLP", "n_neurons": 64, "layout": "nchw"})
