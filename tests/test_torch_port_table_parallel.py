"""The port's table parallelism (``tcnn_tpu_torch.parallel.table_parallel``)
against the JAX package's (``tcnn_tpu.parallel.table_parallel``), on the
CPU.

- Without processes: for each rank d of n (n = 3, an uneven last shard, and
  4), the windowed lookup's plain version (``ops.grid_encode
  .grid_encode_windowed`` on CPU tensors) summed over d equals the JAX
  package's unsharded lookup, and the windowed table gradients,
  unsharded, equal its gradient; for the three cases of
  tests/test_table_parallel.py and the flagship encoding, at that test's
  tolerances (features rtol 2e-5 atol 1e-5, gradients rtol 1e-5 atol 1e-6:
  fp32 sums of the partials in another order).
- ``shard_params`` / ``unshard_params`` are byte for byte the JAX
  package's, for n = 1, 2, 3, 4 and 8.
- Spawned on 4 gloo ranks (``parallel.launch.run_ranks``, one spawn for
  every case): ``TableParallelTrainer`` on a (data 2, model 2) mesh against
  the JAX package's on ``Mesh((2, 2))``, tests/test_table_parallel.py's
  end-to-end config computing in fp32 (``precision="float32"``, as the
  port's cross-package runs do, so that bf16 rounding flips between the
  two libraries do not enter: each holds its own bf16 run to these
  tolerances) and that test's tolerances (losses rtol 5e-5 atol 1e-6, params rtol
  5e-4 atol 1e-6, inference rtol 2e-4 atol 2e-5, ``sync_to_trainer``'s
  params exact); its EMA config: ``sync_to_trainer`` hands back the
  optimizer state (the EMA inference weights and the serialized params
  within rtol 5e-4 atol 1e-6 of the JAX run's), and a new
  ``learning_rate`` reaches both optimizers (losses rtol 5e-5). The ranks
  import no JAX: only the functions that compare import it.
- The raises: a model without a grid encoding (TypeError), stochastic
  interpolation and fixed_point_pos (NotImplementedError).
"""

import copy

import numpy as np
import pytest
import torch

import tcnn_tpu_torch as tt
from tcnn_tpu_torch.encodings import create_encoding
from tcnn_tpu_torch.encodings.grid import _INTERP_CODES
from tcnn_tpu_torch.ops import grid_encode as ge
from tcnn_tpu_torch.parallel import TableParallelGrid, TableParallelTrainer
from tcnn_tpu_torch.parallel.launch import run_ranks

_ENC = dict(otype="HashGrid", n_levels=6, n_features_per_level=2, log2_hashmap_size=9, base_resolution=3,
            per_level_scale=1.9)
CASES = {
    "2-Linear-CoherentPrime": (2, dict(_ENC, interpolation="Linear", hash="CoherentPrime")),
    "3-Smoothstep-Prime": (3, dict(_ENC, interpolation="Smoothstep", hash="Prime")),
    "2-Nearest-CoherentAdditive": (2, dict(_ENC, interpolation="Nearest", hash="CoherentAdditive")),
    "flagship": (2, {"otype": "HashGrid", "n_levels": 16, "n_features_per_level": 2, "log2_hashmap_size": 15,
                     "base_resolution": 16, "per_level_scale": 1.5, "hash": "CoherentAdditive",
                     "gather_strategy": "stratified"}),
}


def _jax_reference(n_dims, cfg, params, x, dy):
    """The JAX package's unsharded lookup (a batch taken for no stratified
    layout: the flagship's coarse levels keep their raster strides, as its
    sharded lookup's do) and the gradient of <lookup, dy> with respect to
    the table."""
    import jax
    import jax.numpy as jnp

    import tcnn_tpu as tc

    e = tc.create_encoding(n_dims, cfg, 16)
    e.output_dtype = jnp.float32
    L2 = e.n_levels * e.n_features_per_level
    kw = {"stratified": False} if cfg.get("gather_strategy") == "stratified" else {}
    y, vjp = jax.vjp(lambda p: e.apply(p, jnp.asarray(x), **kw)[:, :L2], jnp.asarray(params))
    (g,) = vjp(jnp.asarray(dy))
    return np.asarray(y), np.asarray(g)


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    n_dims, cfg = CASES[request.param]
    enc = create_encoding(n_dims, cfg, alignment=16)
    r = np.random.default_rng(0)
    params = r.standard_normal(enc.n_params).astype(np.float32)
    x = r.uniform(0, 1, (64, n_dims)).astype(np.float32)
    dy = r.standard_normal((64, enc.n_levels * enc.n_features_per_level)).astype(np.float32)
    return enc, params, x, dy, _jax_reference(n_dims, cfg, params, x, dy)


@pytest.mark.parametrize("n", [3, 4])
def test_windowed_lookup_summed_over_shards_is_the_lookup(case, n):
    enc, params, x, dy, (want, _) = case
    F = enc.n_features_per_level
    interp = _INTERP_CODES[enc.interpolation_type]
    total = np.zeros_like(want)
    for d in range(n):
        tpg = TableParallelGrid(enc, None, shard=(d, n))
        levels, windows = tpg._tables_on(torch.device("cpu"))
        y = ge.grid_encode_windowed(torch.from_numpy(x), torch.from_numpy(tpg.local_params(params)), levels, windows,
                                    F, interp)
        assert y.dtype == torch.float32 and y.shape == want.shape
        total += y.numpy()
    np.testing.assert_allclose(total, want, rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("n", [3, 4])
def test_windowed_table_gradients_unsharded_are_the_gradient(case, n):
    enc, params, x, dy, (_, want) = case
    F = enc.n_features_per_level
    interp = _INTERP_CODES[enc.interpolation_type]
    grads = []
    for d in range(n):
        tpg = TableParallelGrid(enc, None, shard=(d, n))
        levels, windows = tpg._tables_on(torch.device("cpu"))
        g = ge.grid_backward_windowed(torch.from_numpy(x), torch.from_numpy(dy), levels, windows, F, interp)
        assert g.shape == (tpg.local_n_params,)
        grads.append(g.numpy())
    np.testing.assert_allclose(tpg.unshard_params(np.concatenate(grads)), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("name", list(CASES))
def test_shard_params_are_the_jax_layout(name, n):
    import jax
    from jax.sharding import Mesh

    import tcnn_tpu as tc
    from tcnn_tpu.parallel import TableParallelGrid as JaxTPG

    n_dims, cfg = CASES[name]
    jtp = JaxTPG(tc.create_encoding(n_dims, cfg, 16), Mesh(np.asarray(jax.devices()[:n]), ("model",)))
    enc = create_encoding(n_dims, cfg, alignment=16)
    params = np.random.default_rng(n).standard_normal(enc.n_params).astype(np.float32)
    stack = None
    for d in range(n):
        tpg = TableParallelGrid(enc, None, shard=(d, n))
        assert (tpg.local_rows, tpg.local_n_params) == (jtp.local_rows, jtp.local_n_params)
        np.testing.assert_array_equal(tpg.local_offsets, jtp.local_offsets)
        stack = tpg.shard_params(params)
        assert stack.tobytes() == jtp.shard_params(params).tobytes()
        np.testing.assert_array_equal(tpg.local_params(params), stack[d * tpg.local_n_params:(d + 1) * tpg.local_n_params])
    assert tpg.unshard_params(stack).tobytes() == jtp.unshard_params(stack).tobytes() == params.tobytes()


# -- the trainer on 4 ranks --------------------------------------------------

END_TO_END = {
    "loss": {"otype": "RelativeL2"},
    "optimizer": {"otype": "Adam", "learning_rate": 1e-2, "epsilon": 1e-15, "l2_reg": 1e-6},
    "encoding": {"otype": "HashGrid", "n_levels": 6, "n_features_per_level": 2, "log2_hashmap_size": 9,
                 "base_resolution": 3, "per_level_scale": 1.9},
    "network": {"otype": "CutlassMLP", "n_neurons": 32, "n_hidden_layers": 1},
}
EMA = {
    "loss": {"otype": "RelativeL2"},
    "optimizer": {"otype": "EMA", "decay": 0.9,
                  "nested": {"otype": "Adam", "learning_rate": 1e-2, "epsilon": 1e-15, "l2_reg": 1e-6}},
    "encoding": {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2, "log2_hashmap_size": 8,
                 "base_resolution": 3, "per_level_scale": 1.9},
    "network": {"otype": "CutlassMLP", "n_neurons": 16, "n_hidden_layers": 1},
}


def _batches(seed, n, batch=256):
    r = np.random.default_rng(seed)
    return [(r.uniform(0, 1, (batch, 2)).astype(np.float32), r.uniform(0, 1, (batch, 3)).astype(np.float32))
            for _ in range(n)]


def _rank(rank, world):
    """Every trainer case on this rank of a (data 2, model 2) mesh."""
    import sys

    from torch.distributed.device_mesh import init_device_mesh

    assert "jax" not in sys.modules and "tcnn_tpu" not in sys.modules
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out = {}
    m = tt.create_from_config(2, 3, END_TO_END, device="cpu", precision="float32")
    tpt = TableParallelTrainer(m.trainer, mesh)
    out["initial"] = tpt.params
    out["losses"] = [float(tpt.training_step(torch.from_numpy(x), torch.from_numpy(t))) for x, t in _batches(7, 5)]
    out["params"] = tpt.params
    out["inference"] = tpt.inference(torch.from_numpy(_batches(8, 1, 128)[0][0])).numpy()
    tpt.sync_to_trainer()
    out["synced"] = m.trainer.params.numpy().copy()

    m = tt.create_from_config(2, 3, EMA, device="cpu", precision="float32")
    tpt = TableParallelTrainer(m.trainer, mesh)
    batches = _batches(3, 5)
    for x, t in batches[:3]:
        tpt.training_step(x, t)
    tpt.sync_to_trainer()
    out["ema"] = m.trainer.inference_params().numpy().copy()
    out["ema_serialized"] = np.frombuffer(bytes(m.trainer.serialize(True)["params_binary"]["bytes"]), np.float32)
    tpt.learning_rate = 1e-3
    out["lr"] = (m.trainer.learning_rate, tpt.opt_net.learning_rate, tpt.opt_enc.learning_rate)
    out["ema_losses"] = [float(tpt.training_step(x, t)) for x, t in batches[3:]]
    assert "jax" not in sys.modules and "tcnn_tpu" not in sys.modules
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(_rank, 4, tmp_dir=tmp_path_factory.mktemp("tp_ranks"))


def _jax_mesh():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))


def test_trainer_end_to_end_matches_jax(ranks):
    import jax.numpy as jnp

    import tcnn_tpu as tc
    from tcnn_tpu.parallel import TableParallelTrainer as JaxTPT

    jm = tc.create_from_config(2, 3, END_TO_END, precision="float32")
    jtp = JaxTPT(jm.trainer, _jax_mesh())
    want = [float(jtp.training_step(jnp.asarray(x), jnp.asarray(t))) for x, t in _batches(7, 5)]
    for out in ranks:
        np.testing.assert_array_equal(out["initial"], np.asarray(tc.create_from_config(2, 3, END_TO_END, precision="float32").trainer.params))
        np.testing.assert_allclose(out["losses"], want, rtol=5e-5, atol=1e-6)
        np.testing.assert_allclose(out["params"], jtp.params, rtol=5e-4, atol=1e-6)
        y = np.asarray(jtp.inference(jnp.asarray(_batches(8, 1, 128)[0][0])))
        np.testing.assert_allclose(out["inference"], y, rtol=2e-4, atol=2e-5)
        np.testing.assert_array_equal(out["synced"], out["params"])


def test_trainer_syncs_optimizer_state_and_learning_rate(ranks):
    import jax.numpy as jnp

    import tcnn_tpu as tc

    ref = tc.create_from_config(2, 3, EMA, precision="float32")
    batches = _batches(3, 5)
    for x, t in batches[:3]:
        ref.training_step(jnp.asarray(x), jnp.asarray(t))
    ema = np.asarray(ref.trainer.inference_params())
    blob = np.frombuffer(bytes(ref.trainer.serialize(serialize_optimizer=True)["params_binary"]["bytes"]), np.float32)
    ref.trainer.learning_rate = 1e-3
    want = [float(ref.training_step(jnp.asarray(x), jnp.asarray(t))) for x, t in batches[3:]]
    for out in ranks:
        assert np.abs(out["ema"]).max() > 0, "EMA weights still zeros: no sync"
        np.testing.assert_allclose(out["ema"], ema, rtol=5e-4, atol=1e-6)
        np.testing.assert_allclose(out["ema_serialized"], blob, rtol=5e-4, atol=1e-6)
        assert out["lr"] == (1e-3, 1e-3, 1e-3)
        np.testing.assert_allclose(out["ema_losses"], want, rtol=5e-5, atol=1e-6)


def test_trainer_rejects_non_grid():
    m = tt.create_from_config(2, 2, {"loss": {"otype": "L2"}, "optimizer": {"otype": "Adam"},
                                     "encoding": {"otype": "Identity"},
                                     "network": {"otype": "CutlassMLP", "n_neurons": 16, "n_hidden_layers": 1}},
                              device="cpu")
    with pytest.raises(TypeError, match="grid encoding"):
        TableParallelTrainer(m.trainer, None)


@pytest.mark.parametrize("extra", [{"stochastic_interpolation": True}, {"fixed_point_pos": True}])
def test_grid_rejects_modes_it_does_not_serve(extra):
    enc = create_encoding(2, dict(_ENC, **extra), alignment=16)
    with pytest.raises(NotImplementedError):
        TableParallelGrid(enc, None, shard=(0, 2))
    cfg = copy.deepcopy(END_TO_END)
    cfg["encoding"].update(extra)
    m = tt.create_from_config(2, 3, cfg, device="cpu")
    with pytest.raises(NotImplementedError):
        TableParallelTrainer(m.trainer, None)
