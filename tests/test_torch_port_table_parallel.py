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
- The input gradient: for each rank d of n (n = 2, 3, 4) the windowed
  input-gradient partials (``grid_backward_input_windowed``) summed over d
  equal ``jax.grad`` of the unsharded lookup with respect to the
  positions, on the four cases (the gradients' tolerances, the atol in
  units of max |JAX|: ``_tol_close``); and through
  ``TableParallelGrid.apply`` with one shard, autograd of ``loss +
  x.sum()`` holds the lookup's term beside the ones.
- The second order: the windowed double backward's partials
  (``grid_backward_backward_windowed``), d/dx and d/d(dL_dy) summed over
  the shards and the table gradients unsharded, equal ``jax.grad`` of the
  eikonal form sum((dy/dx . w)^2) of the unsharded lookup, and of
  <cgp, dparams> + sum(dx^2) for a table-gradient cotangent cgp (the same
  tolerances: sums over shards, levels and corners in another order).
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
- Spawned on 2 gloo ranks: TableParallelGrid.apply on a model-2 mesh,
  d/dx of the lookup and the eikonal form's d/dparams (each rank's rows)
  and d/dx through autograd, against the JAX package's unsharded lookup.
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


# The case whose input gradients the spawned ranks take over a model group.
TP_GRAD_CASE = "3-Smoothstep-Prime"


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


def _case_inputs(name):
    n_dims, cfg = CASES[name]
    enc = create_encoding(n_dims, cfg, alignment=16)
    r = np.random.default_rng(0)
    params = r.standard_normal(enc.n_params).astype(np.float32)
    x = r.uniform(0, 1, (64, n_dims)).astype(np.float32)
    dy = r.standard_normal((64, enc.n_levels * enc.n_features_per_level)).astype(np.float32)
    return n_dims, cfg, enc, params, x, dy


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    n_dims, cfg, enc, params, x, dy = _case_inputs(request.param)
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


def _jax_input_grads(n_dims, cfg, params, x, dy, cgp):
    """``jax.grad`` of the unsharded lookup in the positions (of <lookup,
    dy>), and (params, x, dy) of the eikonal form sum((dy/dx . dy)^2) and
    of <cgp, dparams> + sum(dx^2) (dx, dparams: the gradients of <lookup,
    dy>)."""
    import jax
    import jax.numpy as jnp

    import tcnn_tpu as tc

    e = tc.create_encoding(n_dims, cfg, 16)
    e.output_dtype = jnp.float32
    L2 = e.n_levels * e.n_features_per_level
    kw = {"stratified": False} if cfg.get("gather_strategy") == "stratified" else {}

    def first(p, xx, g):
        return jnp.sum(e.apply(p, xx, **kw)[:, :L2] * g)

    def eikonal(p, xx, g):
        return jnp.sum(jax.grad(first, argnums=1)(p, xx, g) ** 2)

    def with_cgp(p, xx, g):
        gp, gx = jax.grad(first, argnums=(0, 1))(p, xx, g)
        return jnp.sum(gp * cgp) + jnp.sum(gx * gx)

    def all_of(*args):
        return (jax.grad(first, argnums=1)(*args), jax.grad(eikonal, argnums=(0, 1, 2))(*args),
                jax.grad(with_cgp, argnums=(0, 1, 2))(*args))

    dx, eik, cg = jax.jit(all_of)(jnp.asarray(params), jnp.asarray(x), jnp.asarray(dy))
    return {"dx": np.asarray(dx), "eikonal": [np.asarray(a) for a in eik], "cgp": [np.asarray(a) for a in cg]}


@pytest.fixture(scope="module", params=list(CASES))
def input_case(request):
    n_dims, cfg, enc, params, x, dy = _case_inputs(request.param)
    cgp = np.random.default_rng(1).standard_normal(enc.n_params).astype(np.float32)
    return enc, params, x, dy, cgp, _jax_input_grads(n_dims, cfg, params, x, dy, cgp)


def _tol_close(got, want, what):
    """The gradients' tolerances, rtol 1e-5 and atol 1e-6, the atol in
    units of max |JAX| (at least 1): entries of dL/dx reach 4.5e4 at the
    flagship's finest scales and cancel, so the unsharded plain input
    gradient itself is 1.2e-2 from JAX's there (2.6e-7 of the max)."""
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * max(float(np.abs(want).max()), 1.0), err_msg=what)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_windowed_input_gradients_summed_over_shards_are_the_gradient(input_case, n):
    enc, params, x, dy, _, want = input_case
    F = enc.n_features_per_level
    interp = _INTERP_CODES[enc.interpolation_type]
    total = np.zeros_like(x)
    for d in range(n):
        tpg = TableParallelGrid(enc, None, shard=(d, n))
        levels, windows = tpg._tables_on(torch.device("cpu"))
        dx = ge.grid_backward_input_windowed(torch.from_numpy(x), torch.from_numpy(dy),
                                             torch.from_numpy(tpg.local_params(params)), levels, windows, F, interp)
        assert dx.dtype == torch.float32 and dx.shape == x.shape
        total += dx.numpy()
    _tol_close(total, want["dx"], "dL/dx")


@pytest.mark.parametrize("form", ["eikonal", "cgp"])
@pytest.mark.parametrize("n", [2, 3])
def test_windowed_double_backward_summed_over_shards_is_the_second_order(input_case, n, form):
    """The eikonal form's cgx = 2 dx (dx the whole table's: the partials
    summed), and with ``form`` "cgp" a cotangent cgp of the table gradient
    beside it; d/dparams unsharded, d/dx and d/d(dL_dy) summed over the
    shards."""
    enc, params, x, dy, cgp, want = input_case
    F = enc.n_features_per_level
    interp = _INTERP_CODES[enc.interpolation_type]
    xt, dyt = torch.from_numpy(x), torch.from_numpy(dy)
    grids = [TableParallelGrid(enc, None, shard=(d, n)) for d in range(n)]
    tables = [g._tables_on(torch.device("cpu")) for g in grids]
    locals_ = [torch.from_numpy(g.local_params(params)) for g in grids]
    dx = sum(ge.grid_backward_input_windowed(xt, dyt, p, lv, win, F, interp) for p, (lv, win) in zip(locals_, tables))
    cgx = 2 * dx
    d_params, d_x, d_dy = [], 0, 0
    for g, p, (lv, win) in zip(grids, locals_, tables):
        cp = torch.from_numpy(g.local_params(cgp)) if form == "cgp" else None
        dp, dxx, ddy = ge.grid_backward_backward_windowed(xt, dyt, p, lv, win, F, interp, cp, cgx)
        d_params.append(dp.numpy())
        d_x, d_dy = d_x + dxx.numpy(), d_dy + ddy.numpy()
    gp_j, gx_j, gdy_j = want[form]
    _tol_close(grids[0].unshard_params(np.concatenate(d_params)), gp_j, "d/dparams")
    _tol_close(d_x, gx_j, "d/dx")
    _tol_close(d_dy, gdy_j, "d/d(dL_dy)")


def test_input_gradient_through_apply_keeps_the_lookup_term(input_case):
    """autograd of loss + x.sum() through TableParallelGrid.apply (one
    shard): dx is the lookup's input gradient plus the ones, and a
    gradient taken with create_graph differentiates again (the eikonal
    form's d/dparams and d/dx)."""
    enc, params, x, dy, _, want = input_case
    tpg = TableParallelGrid(enc, None, shard=(0, 1))
    local = torch.from_numpy(tpg.local_params(params)).requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = (tpg.apply(local, xt) * torch.from_numpy(dy)).sum() + xt.sum()
    (dx,) = torch.autograd.grad(loss, xt)
    _tol_close(dx.numpy() - 1.0, want["dx"], "dL/dx - 1")
    assert np.abs(want["dx"]).max() == 0 or np.abs(dx.numpy() - 1.0).max() > 0
    (g,) = torch.autograd.grad((tpg.apply(local, xt) * torch.from_numpy(dy)).sum(), xt, create_graph=True)
    gp, gx = torch.autograd.grad((g * g).sum(), (local, xt))
    _tol_close(tpg.unshard_params(gp.numpy()), want["eikonal"][0], "d/dparams")
    _tol_close(gx.numpy(), want["eikonal"][1], "d/dx")


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

    # The lookup's derivatives in x over the model group: dL/dx and the
    # eikonal form's gradients through autograd.
    _, _, enc, params, x, dy = _case_inputs(TP_GRAD_CASE)
    tpg = TableParallelGrid(enc, mesh)
    local = torch.from_numpy(tpg.local_params(params)).requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    (g,) = torch.autograd.grad((tpg.apply(local, xt) * torch.from_numpy(dy)).sum(), xt, create_graph=True)
    gp, gx = torch.autograd.grad((g * g).sum(), (local, xt))
    out["grads"] = {"shard": tpg.shard, "dx": g.detach().numpy(), "eikonal": (gp.numpy(), gx.numpy())}
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


def test_input_gradients_over_a_model_group_match_jax(ranks):
    """TableParallelGrid.apply on the model axis of the 4 ranks: dL/dx and
    the eikonal form's d/dx on every rank, and its d/dparams of each
    rank's rows unsharded, against the JAX package's unsharded lookup."""
    n_dims, cfg, enc, params, x, dy = _case_inputs(TP_GRAD_CASE)
    want = _jax_input_grads(n_dims, cfg, params, x, dy, np.zeros(enc.n_params, np.float32))
    by_shard = {}
    for out in ranks:
        got = out["grads"]
        _tol_close(got["dx"], want["dx"], "dL/dx")
        _tol_close(got["eikonal"][1], want["eikonal"][1], "eikonal d/dx")
        by_shard[got["shard"]] = got["eikonal"][0]
    assert sorted(by_shard) == [0, 1]
    tpg = TableParallelGrid(enc, None, shard=(0, 2))
    _tol_close(tpg.unshard_params(np.concatenate([by_shard[0], by_shard[1]])), want["eikonal"][0],
               "eikonal d/dparams")


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
