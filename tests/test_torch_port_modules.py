"""The module API: ``tcnn_tpu_torch.modules`` against ``tcnn_tpu.modules``.

Mirrors tests/test_modules.py and tests/test_torch_modules.py. The same seed
gives bit-identical parameters (the same PCG32 draws). Forward outputs and
first-order gradients with respect to params and inputs go against the JAX
modules' ``apply`` and ``jax.grad`` on the CPU (Pallas kernels in interpret
mode). The port runs any batch as it is; the JAX modules pad to
``BATCH_SIZE_GRANULARITY`` (B = 250 shows that the padded rows change
nothing).

Tolerances: outputs atol 1e-6 (fp32 encoding; the network's bf16 outputs
come from the same roundings); parameter gradients atol 1e-5 of fp32 sums
in another order, as tests/test_torch_modules.py; input gradients atol 1e-6
relative to their magnitude (~2e-3 here). A table gradient in the (RN, bf16)
class against ``Module.__call__``'s: ``match_rae`` p99 within 1e-3 and mean
within 1e-4 (bf16 sums of the same rounded contributions in another order
differ in the last bits of under 1% of the entries; the fp32 class where the
JAX package takes the bf16 one misses both by 4x or more).
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcnn_tpu.modules as jm
import tcnn_tpu_torch as tt
import tcnn_tpu_torch.modules as tm
from tcnn_tpu_torch.common import BATCH_SIZE_GRANULARITY, next_multiple
from tcnn_tpu_torch.ops import scatter_rows as sr
from utils import match_rae

ENC = {
    "otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
    "log2_hashmap_size": 9, "base_resolution": 4, "per_level_scale": 1.5,
}
NETS = {
    "CutlassMLP": {"otype": "CutlassMLP", "n_neurons": 32, "n_hidden_layers": 1, "activation": "ReLU",
                   "output_activation": "None"},
    "FullyFusedMLP": {"otype": "FullyFusedMLP", "n_neurons": 32, "n_hidden_layers": 2},
}


def make_pair(net, seed=7):
    return tm.NetworkWithInputEncoding(2, 3, ENC, NETS[net], seed=seed, device="cpu"), \
        jm.NetworkWithInputEncoding(2, 3, ENC, NETS[net], seed=seed)


@pytest.mark.parametrize("net", list(NETS))
def test_seed_params_and_forward_match_jax(net):
    t, j = make_pair(net)
    np.testing.assert_array_equal(t.params.detach().numpy(), np.asarray(j.params))
    assert t.n_params == j.n_params and t.padded_output_width == j.padded_output_width
    x = np.random.default_rng(0).uniform(0, 1, (256, 2)).astype(np.float32)
    y = t(torch.from_numpy(x))
    assert y.dtype == torch.float32 and y.shape == (256, 3)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(j(jnp.asarray(x)), np.float32)[:, :3], rtol=0,
                               atol=1e-6)
    padded = t.apply(t.params, torch.from_numpy(x))
    assert padded.shape == (256, j.padded_output_width)


@pytest.mark.parametrize("batch", [256, 250])
@pytest.mark.parametrize("net", list(NETS))
def test_gradients_match_jax(net, batch):
    t, j = make_pair(net)
    x_np = np.random.default_rng(1).uniform(0, 1, (batch, 2)).astype(np.float32)
    w_np = np.random.default_rng(2).standard_normal((batch, 3)).astype(np.float32)
    x_t = torch.from_numpy(x_np.copy()).requires_grad_(True)
    (t(x_t) * torch.from_numpy(w_np)).sum().backward()

    def jax_loss(p, xx):
        return jnp.sum(j.apply(p, xx)[:, :3].astype(jnp.float32) * jnp.asarray(w_np))

    gp_j, gx_j = jax.grad(jax_loss, argnums=(0, 1))(j.params, jnp.asarray(x_np))
    np.testing.assert_allclose(t.params.grad.numpy(), np.asarray(gp_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(x_t.grad.numpy(), np.asarray(gx_j), rtol=0, atol=1e-6)


# A 2D grid whose one hashed level (2^17 entries) crosses the "auto" scatter
# gate between a batch and its padded batch: per-corner rows (4 a sample)
# of at least 65,536 into a level of more than 65,536 entries take the
# (RN, bf16) class, so B = 16,257 (65,028 rows) stays fp32 unpadded and
# turns bf16 padded to 16,384; no smaller batch crosses it.
GATE_ENC = {
    "otype": "HashGrid", "n_levels": 1, "n_features_per_level": 2, "log2_hashmap_size": 17,
    "base_resolution": 512, "gather_strategy": "per_level",
}


@pytest.mark.parametrize("batch", [16257, 16384])
def test_forward_decides_on_the_padded_batch_as_jax_call(batch):
    """``forward`` gives the output and parameter gradient of the JAX
    modules' ``__call__``, which pads the batch to BATCH_SIZE_GRANULARITY
    and so takes the bf16 table gradient at B = 16,257 as at 16,384;
    ``apply`` keeps the unpadded batch's fp32 class, as JAX ``apply``."""
    t, j = tm.Encoding(2, GATE_ENC, seed=3, device="cpu"), jm.Encoding(2, GATE_ENC, seed=3)
    enc = t._encoding
    padded = next_multiple(batch, BATCH_SIZE_GRANULARITY)
    assert enc.gradient_classes(16256).tolist() == enc.gradient_classes(next_multiple(16256, 128)).tolist()
    assert enc.gradient_classes(16257).tolist() != enc.gradient_classes(16384).tolist()
    assert enc.gradient_classes(padded)[0].tolist() == [sr.CONTRIB_RN, sr.ACC_BF16]
    x = np.random.default_rng(0).uniform(0, 1, (batch, 2)).astype(np.float32)
    w = np.random.default_rng(1).standard_normal((batch, t.n_output_dims)).astype(np.float32)
    y = t(torch.from_numpy(x))
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(j(jnp.asarray(x))), rtol=0, atol=1e-6)
    g_call = jax.grad(lambda p: jnp.sum(j(jnp.asarray(x), params=p) * jnp.asarray(w)))(j.params)
    match_rae(t.params.grad.numpy(), np.asarray(g_call), 1e-3, percentile=99)
    match_rae(t.params.grad.numpy(), np.asarray(g_call), 1e-4, mean_only=True)
    applied = torch.autograd.grad((t.apply(t.params, torch.from_numpy(x)) * torch.from_numpy(w)).sum(), t.params)[0]
    g_apply = jax.grad(lambda p: jnp.sum(j.apply(p, jnp.asarray(x)) * jnp.asarray(w)))(j.params)
    match_rae(applied.numpy(), np.asarray(g_apply), 1e-3, percentile=99)


def test_network_through_identity():
    cfg = NETS["FullyFusedMLP"]
    t, j = tm.Network(16, 4, cfg, seed=2, device="cpu"), jm.Network(16, 4, cfg, seed=2)
    np.testing.assert_array_equal(t.params.detach().numpy(), np.asarray(j.params))
    x = np.random.default_rng(1).uniform(0, 1, (64, 16)).astype(np.float32)
    y = t(torch.from_numpy(x))
    assert y.shape == (64, 4) and torch.isfinite(y).all()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(j(jnp.asarray(x)), np.float32)[:, :4], rtol=0, atol=0)
    assert "n_params=2048" in repr(t)
    with pytest.raises(ValueError, match="dims"):
        t(torch.rand(4, 7))


def test_identity_encoding_matches_jax():
    from tcnn_tpu.encodings import create_encoding as jenc
    from tcnn_tpu_torch.encodings import create_encoding as tenc

    cfg = {"otype": "Identity", "scale": 0.5, "offset": 0.25}
    je, te = jenc(3, cfg, alignment=8), tenc(3, cfg, alignment=8)
    je.output_dtype, te.output_dtype = jnp.float32, torch.float32
    x = np.random.default_rng(3).uniform(-1, 1, (10, 3)).astype(np.float32)
    got = te.apply(torch.zeros(0), torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(je.apply(None, jnp.asarray(x))))
    assert got.shape == (10, 8) and (got[:, 3:] == 1.0).all()


def test_standalone_encoding_is_fp32_and_matches_jax():
    t, j = tm.Encoding(2, ENC, seed=5, device="cpu"), jm.Encoding(2, ENC, seed=5)
    assert t.n_output_dims == j.n_output_dims == 8
    np.testing.assert_array_equal(t.params.detach().numpy(), np.asarray(j.params))
    x = np.random.default_rng(6).uniform(0, 1, (128, 2)).astype(np.float32)
    y = t(torch.from_numpy(x))
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(j(jnp.asarray(x))), rtol=0, atol=1e-6)
    y.sum().backward()
    assert float(t.params.grad.abs().sum()) > 0
    with pytest.warns(UserWarning, match="ignores dtype"):
        tm.Encoding(2, ENC, seed=1, dtype=torch.half, device="cpu")


def test_pickle_roundtrip():
    m = tm.Encoding(2, ENC, seed=5, device="cpu")
    x = torch.from_numpy(np.random.default_rng(4).uniform(0, 1, (16, 2)).astype(np.float32))
    m2 = pickle.loads(pickle.dumps(m))
    assert torch.equal(m(x), m2(x))
    n = tm.NetworkWithInputEncoding(2, 3, ENC, NETS["FullyFusedMLP"], seed=3, device="cpu")
    n2 = pickle.loads(pickle.dumps(n))
    assert torch.equal(n(x), n2(x)) and n2.params is n2._model.params


def test_torch_optimizer_trains():
    t, _ = make_pair("CutlassMLP", seed=3)
    assert len(list(t.parameters())) == 1
    opt = torch.optim.Adam(t.parameters(), lr=1e-2)
    x_np = np.random.default_rng(4).uniform(0, 1, (512, 2)).astype(np.float32)
    x = torch.from_numpy(x_np)
    target = torch.from_numpy(np.stack([x_np[:, 0], x_np[:, 1], (x_np[:, 0] + x_np[:, 1]) / 2], axis=1))
    losses = []
    for _ in range(40):
        opt.zero_grad()
        loss = torch.nn.functional.mse_loss(t(x), target)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert losses[-1] < 0.3 * losses[0], losses[:: len(losses) - 1]


def test_params_from_numpy_carries_jax_weights():
    t, j = make_pair("FullyFusedMLP", seed=9)
    j_params = np.asarray(j.params) * np.float32(1.5)
    with torch.no_grad():
        t.params.copy_(tt.params_from_numpy(j_params, t))
    x = np.random.default_rng(8).uniform(0, 1, (64, 2)).astype(np.float32)
    np.testing.assert_allclose(t(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(j.apply(jnp.asarray(j_params), jnp.asarray(x)), np.float32)[:, :3],
                               rtol=0, atol=1e-6)


def test_free_temporary_memory_is_callable():
    assert tm.free_temporary_memory() is None
