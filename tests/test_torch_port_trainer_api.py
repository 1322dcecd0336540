"""The rest of the trainer API: the PyTorch port against the JAX package.

- ``training_steps(batch_fn, n_steps, data)``: on the CPU a loop of the
  same steps; against the JAX package's scan on the same numpy batches,
  and against the port's own ``training_step`` loop;
- ``update_hyperparams`` and the ``learning_rate`` setter: a new learning
  rate takes effect in the next step, in both packages alike;
- ``hyperparams()`` of the model (encoding, network) as the JAX package
  gives it;
- ``serialize`` / ``deserialize`` within the port, the legacy base64
  format, and what drops captured training steps.

Tolerance of the cross-package runs: fp32 compute (``precision="fp32"``)
so that the comparison is of the algorithm, not of bf16 rounding flips;
losses and params to rtol 2e-5 (atol 1e-6 and 2e-6), as
tests/test_trainer.py holds the JAX package's scan to its sequential steps:
the same fp32 operations, with sums reduced in another order.
"""

import base64
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcnn_tpu as tc
import tcnn_tpu_torch as tt

B = 512
N_STEPS = 6
CONFIG = {
    "loss": {"otype": "RelativeL2"},
    "optimizer": {"otype": "EMA", "decay": 0.9, "nested": {"otype": "Adam", "learning_rate": 1e-2}},
    "encoding": {"otype": "HashGrid", "n_levels": 8, "n_features_per_level": 2, "log2_hashmap_size": 12,
                 "base_resolution": 8, "per_level_scale": 1.5},
    "network": {"otype": "FullyFusedMLP", "n_neurons": 64, "n_hidden_layers": 2},
}


def _data(seed=0, n=N_STEPS):
    r = np.random.default_rng(seed)
    xs = r.uniform(0, 1, (n, B, 2)).astype(np.float32)
    ts = np.stack([np.sin(5 * xs[..., 0]), np.cos(3 * xs[..., 1]), xs[..., 0] * xs[..., 1]], -1)
    return xs, (0.5 + 0.5 * ts).astype(np.float32)


def _pick(stack, i):
    return torch.index_select(stack, 0, i.reshape(1).to(torch.int64))[0]


def _pair(cfg=CONFIG, seed=7):
    jm = tc.create_from_config(2, 3, cfg, seed=seed, precision="fp32")
    tm = tt.create_from_config(2, 3, cfg, seed=seed, precision="fp32", device="cpu")
    np.testing.assert_array_equal(np.asarray(jm.trainer.params), tm.params.numpy())
    return jm, tm


def test_training_steps_matches_jax_and_the_loop():
    xs, ts = _data()
    jm, tm = _pair()
    j_losses = jm.trainer.training_steps(lambda i: (jnp.take(jnp.asarray(xs), i, 0), jnp.take(jnp.asarray(ts), i, 0)),
                                         N_STEPS)
    data = {"x": torch.from_numpy(xs), "t": torch.from_numpy(ts)}
    seen = []

    def batch_fn(d, i):
        assert i.dtype == torch.int32 and i.dim() == 0
        seen.append(int(i))
        return _pick(d["x"], i), _pick(d["t"], i)

    t_losses = tm.trainer.training_steps(batch_fn, N_STEPS, data)
    assert seen == list(range(N_STEPS))
    assert t_losses.shape == (N_STEPS,) and t_losses.dtype == torch.float32
    np.testing.assert_allclose(t_losses.numpy(), np.asarray(j_losses), rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(tm.params.numpy(), np.asarray(jm.trainer.params), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(tm.trainer.inference_params().numpy(), np.asarray(jm.trainer.inference_params()),
                               rtol=2e-5, atol=2e-6)
    # The port's own training_step loop on the same batches: the same steps.
    _, loop = _pair()
    l_losses = torch.stack([loop.training_step(xs[k], ts[k]) for k in range(N_STEPS)])
    assert torch.equal(l_losses, t_losses)
    assert torch.equal(loop.params, tm.params)
    assert torch.equal(loop.trainer.inference_params(), tm.trainer.inference_params())


def test_training_steps_without_data():
    xs, ts = _data(1, 3)
    x, t = torch.from_numpy(xs), torch.from_numpy(ts)
    _, a = _pair()
    _, b = _pair()
    losses = a.trainer.training_steps(lambda i: (_pick(x, i), _pick(t, i)), 3)
    assert torch.equal(losses, torch.stack([b.training_step(xs[k], ts[k]) for k in range(3)]))
    with pytest.raises(ValueError, match="n_steps"):
        a.trainer.training_steps(lambda i: (_pick(x, i), _pick(t, i)), 0)


@pytest.mark.parametrize("how", ["update_hyperparams", "setter"])
def test_new_learning_rate_takes_effect_in_the_next_step(how):
    xs, ts = _data(2, 4)
    jm, tm = _pair()
    for k in range(2):
        jm.training_step(jnp.asarray(xs[k]), jnp.asarray(ts[k]))
        tm.training_step(xs[k], ts[k])
    before = tm.params.clone()
    if how == "setter":
        jm.trainer.learning_rate = 1e-4
        tm.trainer.learning_rate = 1e-4
    else:
        jm.trainer.update_hyperparams({"optimizer": {"nested": {"learning_rate": 1e-4}}})
        tm.trainer.update_hyperparams({"optimizer": {"nested": {"learning_rate": 1e-4}}})
    assert tm.trainer.learning_rate == 1e-4 and tm.optimizer.hyperparams()["nested"]["learning_rate"] == 1e-4
    jm.training_step(jnp.asarray(xs[2]), jnp.asarray(ts[2]))
    tm.training_step(xs[2], ts[2])
    np.testing.assert_allclose(tm.params.numpy(), np.asarray(jm.trainer.params), rtol=2e-5, atol=2e-6)
    # Adam moves a param by about the learning rate a step.
    assert float((tm.params - before).abs().max()) <= 1.5e-4


@pytest.mark.parametrize("enc", [
    {"otype": "HashGrid", "n_levels": 4, "log2_hashmap_size": 10, "quad_build": "flat"},
    {"otype": "HashGrid", "n_levels": 8, "log2_hashmap_size": 10, "base_resolution": 4, "hash": "CoherentAdditive",
     "gather_strategy": "stratified", "strata": 16, "phase_locked": True, "locked_rounding": "sr",
     "strat_accum": "where", "table_dtype": "bfloat16"},
    {"otype": "DenseGrid", "n_levels": 3, "base_resolution": 4, "interpolation": "Smoothstep"},
    {"otype": "OneBlob", "n_bins": 8},
    {"otype": "Identity", "scale": 2.0, "offset": 0.5},
], ids=["hash", "stratified_locked", "dense", "oneblob", "identity"])
def test_model_hyperparams_match_jax(enc):
    cfg = {"encoding": enc, "network": {"otype": "CutlassMLP", "n_neurons": 16, "n_hidden_layers": 1}}
    jm = tc.create_from_config(2, 3, cfg)
    tm = tt.create_from_config(2, 3, cfg, device="cpu")
    assert tm.model.hyperparams() == jm.model.hyperparams()
    assert tm.loss.hyperparams() == jm.loss.hyperparams() == {"otype": "RelativeL2"}
    tm.model.update_hyperparams(tm.model.hyperparams())  # accepted, a no-op as in the JAX package
    assert tm.model.hyperparams() == jm.model.hyperparams()


def _trained(cfg=CONFIG, steps=3):
    _, tm = _pair(cfg)
    xs, ts = _data(3, steps)
    for k in range(steps):
        tm.training_step(xs[k], ts[k])
    return tm


def test_serialize_deserialize_within_the_port():
    import json

    tm = _trained()
    blob = json.loads(json.dumps(tm.trainer.serialize(serialize_optimizer=True)))
    _, fresh = _pair(seed=99)
    fresh.trainer.deserialize(blob)
    x = _data(4, 1)[0][0]
    assert torch.equal(fresh.trainer.inference(x), tm.trainer.inference(x))
    for a, b in zip(tt.optimizers.base.tree_leaves(fresh.trainer.opt_state),
                    tt.optimizers.base.tree_leaves(tm.trainer.opt_state)):
        assert torch.equal(a, b)


def test_legacy_base64_snapshot():
    """The JAX package's first format: base64 params and an __ndarray__
    optimizer tree."""
    tm = _trained(dict(CONFIG, optimizer={"otype": "Adam", "learning_rate": 1e-2}))

    def arr(t):
        a = t.numpy()
        return {"__ndarray__": base64.b64encode(a.tobytes()).decode(), "dtype": str(a.dtype), "shape": list(a.shape)}

    blob = {
        "n_params": tm.model.n_params,
        "params_type": "float",
        "params_binary": base64.b64encode(tm.params.numpy().tobytes()).decode(),
        "optimizer": {k: arr(v) for k, v in tm.trainer.opt_state.items()},
    }
    fresh = tt.create_from_config(2, 3, dict(CONFIG, optimizer={"otype": "Adam"}), seed=99, precision="fp32",
                                  device="cpu")
    fresh.trainer.deserialize(blob)
    assert torch.equal(fresh.params, tm.params)
    for k, v in tm.trainer.opt_state.items():
        assert torch.equal(fresh.trainer.opt_state[k], v), k
    with pytest.raises(ValueError, match="params"):
        fresh.trainer.deserialize(dict(blob, n_params=3))


@pytest.mark.parametrize("how", ["learning_rate", "update_hyperparams", "opt_state", "initialize_params",
                                 "deserialize", "load_npz"])
def test_what_drops_captured_steps(how, tmp_path):
    """Captured training steps read the tensors and hyperparameters they
    were captured with: each of these drops them."""
    from tcnn_tpu_torch.utils import checkpoint

    tm = _trained()
    tr = tm.trainer
    path = tmp_path / "s.npz"
    checkpoint.save_npz(path, tr)
    blob = tr.serialize(True)
    tr._graphs[("captured",)] = object()
    {
        "learning_rate": lambda: setattr(tr, "learning_rate", 1e-3),
        "update_hyperparams": lambda: tr.update_hyperparams({"loss": {}}),
        "opt_state": lambda: setattr(tr, "opt_state", tr.optimizer.init_state("cpu")),
        "initialize_params": lambda: tr.initialize_params(3),
        "deserialize": lambda: tr.deserialize(blob),
        "load_npz": lambda: checkpoint.load_npz(path, tr),
    }[how]()
    assert not tr._graphs
    # A step does not: it writes into the tensors the trainer holds.
    leaves = [t.data_ptr() for t in tt.optimizers.base.tree_leaves(tr.opt_state)] + [tr.params.data_ptr()]
    tr._graphs[("captured",)] = object()
    xs, ts = _data(5, 1)
    tr.training_step(xs[0], ts[0])
    assert tr._graphs
    assert leaves == [t.data_ptr() for t in tt.optimizers.base.tree_leaves(tr.opt_state)] + [tr.params.data_ptr()]


def test_not_ported_yet_still_raises():
    """What this once held unported is ported now: ``perturbation_sigma``
    and Shampoo, alone or nested in a Composite, are accepted (their
    parity: test_torch_port_training_extras.py); Shampoo's checkpoint
    still raises, as the reference's does (shampoo.h:963-965)."""
    model = tt.create_from_config(2, 3, CONFIG, device="cpu").model
    tr = tt.Trainer(model, CONFIG["optimizer"], CONFIG["loss"], perturbation_sigma=0.1)
    assert tr.perturbation_generator is not None
    m = tt.create_from_config(2, 3, dict(CONFIG, optimizer={"otype": "Shampoo"}), device="cpu")
    assert m.trainer.optimizer.otype == "Shampoo"
    with pytest.raises(NotImplementedError, match="Shampoo"):
        m.trainer.serialize(True)
    cfg = copy.deepcopy(CONFIG)
    cfg["optimizer"] = {"otype": "Composite", "nested": [{"otype": "Shampoo"}]}
    assert tt.create_from_config(2, 3, cfg, device="cpu").trainer.optimizer.nested(0).otype == "Shampoo"
