"""Checkpoint interchange: the PyTorch port against the JAX package and the
golden fixture (reference: trainer.h:442-482, adam.h:304-325,
gpu_memory_json.h:36-71).

- The committed reference-layout snapshot (tests/data/
  interchange_fixture.msgpack, CutlassMLP + CoherentPrime grid, as
  tests/test_interchange.py loads it into the JAX package): deserialized
  into the port and serialized again it gives the same bytes; the forward
  at its params matches ``interchange_expected.npz`` (rtol 1e-4, atol 1e-5,
  as the JAX package's test); the text-JSON spelling; half params.
- JAX -> port -> JAX: the JAX package trains five steps and writes a
  snapshot with optimizer state; the port reads it and writes the same
  bytes; the JAX package reads the port's bytes and writes them again, for
  every optimizer of the JAX package's round-trip test and Adam and
  Composite.
- npz checkpoints (``utils.checkpoint``) in both directions: the same
  leaves, equal, and training resumes in both packages alike (fp32
  compute, rtol 2e-5 as tests/test_torch_port_trainer_api.py).
"""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcnn_tpu as tc
import tcnn_tpu_torch as tt
from tcnn_tpu import interchange as jic
from tcnn_tpu.utils import checkpoint as jckpt
from tcnn_tpu_torch import interchange as tic
from tcnn_tpu_torch.optimizers.base import tree_leaves
from tcnn_tpu_torch.utils import checkpoint as tckpt

DATA = Path(__file__).resolve().parent / "data"
_spec = importlib.util.spec_from_file_location("make_interchange_fixture", DATA / "make_interchange_fixture.py")
_fixture_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_fixture_mod)
FIXTURE_CONFIG = _fixture_mod.FIXTURE_CONFIG

OPTIMIZERS = [
    {"otype": "Adam", "learning_rate": 1e-2},
    {"otype": "SGD", "learning_rate": 1e-2},
    {"otype": "Novograd", "learning_rate": 1e-2},
    {"otype": "EMA", "decay": 0.95, "nested": {"otype": "Adam"}},
    {"otype": "Average", "n_samples": 4, "nested": {"otype": "Adam"}},
    {"otype": "Batched", "batch_size_multiplier": 2, "nested": {"otype": "Adam"}},
    {"otype": "Lookahead", "nested": {"otype": "Adam"}},
    {"otype": "ExponentialDecay", "decay_base": 0.5, "decay_start": 2, "decay_interval": 2, "decay_end": 100,
     "nested": {"otype": "Adam"}},
    {"otype": "Composite", "nested": [{"otype": "Adam", "n_params_to_optimize": 512},
                                      {"otype": "EMA", "nested": {"otype": "SGD"}}]},
]
IDS = [c["otype"] for c in OPTIMIZERS]


def _port_fixture_model(**kw):
    return tt.create_from_config(2, 1, FIXTURE_CONFIG, device="cpu", **kw)


def _batch(seed=0, n=128):
    r = np.random.default_rng(seed)
    return r.uniform(0, 1, (n, 2)).astype(np.float32), r.uniform(0, 1, (n, 1)).astype(np.float32)


def test_fixture_byte_level_roundtrip():
    raw = (DATA / "interchange_fixture.msgpack").read_bytes()
    blob = tic.from_msgpack(raw)
    m = _port_fixture_model()
    tic.deserialize_trainer(m.trainer, blob)
    out = tic.serialize_trainer(m.trainer, serialize_optimizer_state=True)
    assert tic.to_msgpack(out) == raw
    assert bytes(out["params_binary"]) == bytes(blob["params_binary"])


def test_fixture_forward_outputs():
    m = _port_fixture_model()
    tic.deserialize_trainer(m.trainer, tic.from_msgpack((DATA / "interchange_fixture.msgpack").read_bytes()))
    exp = np.load(DATA / "interchange_expected.npz")
    np.testing.assert_array_equal(m.params.numpy(), exp["params"])
    np.testing.assert_allclose(m.trainer.inference(exp["x"]).numpy(), exp["y"], rtol=1e-4, atol=1e-5)


def test_text_json_spelling():
    m = _port_fixture_model()
    tic.deserialize_trainer(m.trainer, tic.from_msgpack((DATA / "interchange_fixture.msgpack").read_bytes()))
    parsed = json.loads(json.dumps(m.trainer.serialize(serialize_optimizer=True)))
    assert "bytes" in parsed["params_binary"] and parsed["params_binary"]["subtype"] is None
    m2 = _port_fixture_model(seed=5)
    m2.trainer.deserialize(parsed)
    assert torch.equal(m2.params, m.params)
    assert torch.equal(m2.trainer.opt_state["first_moments"], m.trainer.opt_state["first_moments"])
    # The JAX package reads the port's text JSON.
    jm = tc.create_from_config(2, 1, FIXTURE_CONFIG)
    jm.trainer.deserialize(parsed)
    np.testing.assert_array_equal(np.asarray(jm.trainer.params), m.params.numpy())


def test_half_params_accepted():
    m = _port_fixture_model()
    p16 = m.params.numpy().astype(np.float16)
    tic.deserialize_trainer(m.trainer, {
        "n_params": m.model.n_params, "params_type": "__half", "params_binary": tic.Binary(p16.tobytes()),
    })
    np.testing.assert_array_equal(m.params.numpy(), p16.astype(np.float32))
    with pytest.raises(ValueError, match="float or __half"):
        tic.deserialize_trainer(m.trainer, {"params_type": "double", "params_binary": b""})
    with pytest.raises(ValueError, match="params"):
        tic.deserialize_trainer(m.trainer, {"n_params": 3, "params_binary": tic.Binary(np.zeros(3, np.float32))})


def test_hash_auto_warns():
    cfg = dict(FIXTURE_CONFIG, encoding={k: v for k, v in FIXTURE_CONFIG["encoding"].items() if k != "hash"})
    m = tt.create_from_config(2, 1, cfg, device="cpu")
    assert m.model.encoding.hash_auto_resolved
    assert not _port_fixture_model().model.encoding.hash_auto_resolved
    from tcnn_tpu_torch.utils import set_log_callback

    seen = []
    set_log_callback(lambda sev, msg: seen.append(msg))
    try:
        tic.deserialize_trainer(m.trainer, tic.serialize_trainer(m.trainer))
    finally:
        set_log_callback(None)
    assert any("CoherentPrime" in msg for msg in seen)


@pytest.mark.parametrize("opt_cfg", OPTIMIZERS, ids=IDS)
def test_jax_port_jax_bytes_equal(opt_cfg):
    cfg = {**FIXTURE_CONFIG, "optimizer": opt_cfg}
    jm = tc.create_from_config(2, 1, cfg)
    x, t = _batch()
    for _ in range(5):
        jm.trainer.training_step(jnp.asarray(x), jnp.asarray(t))
    j_bytes = jic.to_msgpack(jic.serialize_trainer(jm.trainer, serialize_optimizer_state=True))

    tm = tt.create_from_config(2, 1, cfg, seed=3, device="cpu")
    tic.deserialize_trainer(tm.trainer, tic.from_msgpack(j_bytes))
    t_bytes = tic.to_msgpack(tic.serialize_trainer(tm.trainer, serialize_optimizer_state=True))
    assert t_bytes == j_bytes

    jm2 = tc.create_from_config(2, 1, cfg, seed=3)
    jic.deserialize_trainer(jm2.trainer, jic.from_msgpack(t_bytes))
    assert jic.to_msgpack(jic.serialize_trainer(jm2.trainer, serialize_optimizer_state=True)) == j_bytes
    # The optimizer state the port holds is the JAX package's.
    j_leaves = jax.tree_util.tree_leaves(jm.trainer.state["opt"])
    t_leaves = tree_leaves(tm.trainer.opt_state)
    assert len(j_leaves) == len(t_leaves)
    for j, tl in zip(j_leaves, t_leaves):
        np.testing.assert_array_equal(tl.numpy(), np.asarray(j))


def _fp32_pair(cfg, seed):
    return (tc.create_from_config(2, 1, cfg, seed=seed, precision="fp32"),
            tt.create_from_config(2, 1, cfg, seed=seed, precision="fp32", device="cpu"))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("opt_cfg", [OPTIMIZERS[0], OPTIMIZERS[3], OPTIMIZERS[-1]], ids=["Adam", "EMA", "Composite"])
def test_npz_both_directions(opt_cfg, direction, tmp_path):
    cfg = {**FIXTURE_CONFIG, "optimizer": opt_cfg}
    jm, tm = _fp32_pair(cfg, seed=1)
    x, t = _batch(1)
    for _ in range(3):
        jm.trainer.training_step(jnp.asarray(x), jnp.asarray(t))
        tm.trainer.training_step(x, t)
    path = tmp_path / "state.npz"
    j2, t2 = _fp32_pair(cfg, seed=9)
    if direction == "jax_to_port":
        jckpt.save_npz(path, jm.trainer)
        tckpt.load_npz(path, t2.trainer)
        src_leaves = jax.tree_util.tree_leaves(jm.trainer.state)
        got = tree_leaves({"opt": t2.trainer.opt_state, "params": t2.trainer.params})
        resumed_j, resumed_t = jm, t2
    else:
        tckpt.save_npz(path, tm.trainer)
        jckpt.load_npz(path, j2.trainer)
        src_leaves = tree_leaves({"opt": tm.trainer.opt_state, "params": tm.trainer.params})
        got = jax.tree_util.tree_leaves(j2.trainer.state)
        resumed_j, resumed_t = j2, tm
    assert len(src_leaves) == len(got)
    for a, b in zip(src_leaves, got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # Training resumes alike in both packages.
    x2, t2_ = _batch(2)
    lj = [float(resumed_j.trainer.training_step(jnp.asarray(x2), jnp.asarray(t2_))) for _ in range(3)]
    lt = [float(resumed_t.trainer.training_step(x2, t2_)) for _ in range(3)]
    np.testing.assert_allclose(lt, lj, rtol=2e-5, atol=1e-6)


def test_npz_shape_mismatch_raises(tmp_path):
    tm = _port_fixture_model()
    path = tmp_path / "state.npz"
    tckpt.save_npz(path, tm.trainer)
    other = dict(FIXTURE_CONFIG, network={**FIXTURE_CONFIG["network"], "n_neurons": 32})
    m2 = tt.create_from_config(2, 1, other, device="cpu")
    before = m2.params.clone()
    with pytest.raises(ValueError, match="shape"):
        tckpt.load_npz(path, m2.trainer)
    assert torch.equal(m2.params, before)


def test_shampoo_and_unknown_serializations_raise():
    class Fake:
        otype = "Shampoo"

    with pytest.raises(NotImplementedError, match="Shampoo"):
        tic.serialize_optimizer(Fake(), {})
    with pytest.raises(NotImplementedError, match="Shampoo"):
        tic.deserialize_optimizer(Fake(), {}, {})
