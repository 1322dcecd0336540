"""The port's public surface against the JAX package's, on the CPU.

- The top-level names: every name ``tcnn_tpu`` exports, the port exports.
- ``register_loss``: a user loss registered in both packages under one
  name gives the same values and gradients through ``create_loss``; a
  second registration raises ``RuntimeError``, case-insensitively. Each
  test registers into a copy of the registry, so other tests see the
  built-ins only.
- ``NetworkWithInputEncoding.input_gradient`` on a small HashGrid +
  FullyFusedMLP model with the same flat parameters, for each output;
  atol 1e-6 of d output / dx, whose entries here reach ~3 (both
  backpropagate the same bf16 network; fp32 sums in another order differ
  by ~5e-7 at most).
- ``rng.generate_random_uniform`` / ``generate_random_logistic``: bit for
  bit the JAX package's from the same seed, and the generator left in the
  same state.
- ``name`` of every encoding and network, and ``required_input_alignment()``
  of every network.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcnn_tpu as tc
import tcnn_tpu.losses as jl
import tcnn_tpu.rng as jr
import tcnn_tpu_torch as tt
import tcnn_tpu_torch.losses as tl
import tcnn_tpu_torch.rng as tr


def test_top_level_exports_cover_the_jax_package():
    missing = sorted(set(tc.__all__) - set(tt.__all__))
    assert not missing, missing
    for name in tc.__all__:
        assert hasattr(tt, name), name
    assert tt.builtin_losses() == tc.builtin_losses()
    assert [m.value for m in tt.ReductionType] == [m.value for m in tc.ReductionType]
    for dtype in ("float32", "bfloat16", "float16"):
        assert tt.default_loss_scale(getattr(torch, dtype)) == tc.default_loss_scale(getattr(jnp, dtype))


@pytest.fixture
def registries(monkeypatch):
    """Both packages' loss registries, as copies for this test."""
    monkeypatch.setattr(jl, "_LOSS_FACTORIES", type(jl._LOSS_FACTORIES)(jl._LOSS_FACTORIES))
    monkeypatch.setattr(tl, "_LOSS_FACTORIES", type(tl._LOSS_FACTORIES)(tl._LOSS_FACTORIES))


def _weighted_l2(base):
    """A user loss on ``base`` (either package's ``Loss``): weight * (p - t)^2
    / n, its weight read from the config by the factory."""

    class WeightedL2(base):
        otype = "WeightedL2"

        def __init__(self, weight):
            self.weight = weight

        def _value_and_gradient(self, pred, target, pdf, n_total):
            diff = pred - target
            return self.weight * diff * diff / n_total, 2 * self.weight * diff / n_total

    return lambda cfg: WeightedL2(float(cfg.get("weight", 1.0)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_register_loss_matches_jax(registries, dtype):
    jl.register_loss("WeightedL2", _weighted_l2(jl.Loss))
    tt.register_loss("WeightedL2", _weighted_l2(tl.Loss))
    assert "WeightedL2" in tt.builtin_losses() and tt.builtin_losses() == tc.builtin_losses()
    rng = np.random.default_rng(3)
    pred = rng.normal(0, 1, (64, 16)).astype(np.float32)
    target = rng.normal(0, 1, (64, 3)).astype(np.float32)
    cfg = {"otype": "weightedl2", "weight": 2.5}
    jv, jg = tc.create_loss(cfg).evaluate(128.0, jnp.asarray(pred, getattr(jnp, dtype)), jnp.asarray(target))
    tv, tg = tt.create_loss(cfg).evaluate(128.0, torch.from_numpy(pred).to(getattr(torch, dtype)),
                                          torch.from_numpy(target))
    assert tg.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(tg.float().numpy(), np.asarray(jg, np.float32))


@pytest.mark.parametrize("name", ["WeightedL2", "weightedl2", "L2", "relativel2"])
def test_register_loss_twice_raises(registries, name):
    for pkg, base in ((jl, jl.Loss), (tl, tl.Loss)):
        if name.lower() == "weightedl2":
            pkg.register_loss("WeightedL2", _weighted_l2(base))
        with pytest.raises(RuntimeError, match="twice"):
            pkg.register_loss(name, _weighted_l2(base))


CFG = {
    "encoding": {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2, "log2_hashmap_size": 9,
                 "base_resolution": 4, "per_level_scale": 1.5},
    "network": {"otype": "FullyFusedMLP", "n_neurons": 32, "n_hidden_layers": 2},
}


@pytest.fixture(scope="module")
def input_gradient_pair():
    """The JAX model and the port's with the same flat parameters: the JAX
    model's initial network weights and grid entries in [-0.5, 0.5)."""
    jm = tc.create_from_config(2, 3, CFG, seed=3)
    tm = tt.create_from_config(2, 3, CFG, device="cpu")
    rng = np.random.default_rng(4)
    flat = np.array(jm.trainer.params, np.float32)
    n_net = jm.model.network.n_params
    flat[n_net:] = rng.uniform(-0.5, 0.5, flat.size - n_net)
    x = rng.uniform(0, 1, (96, 2)).astype(np.float32)
    return jm, tm, flat, x


@pytest.mark.parametrize("output_index", [0, 1, 2])
def test_input_gradient_matches_jax(input_gradient_pair, output_index):
    jm, tm, flat, x = input_gradient_pair
    want = np.asarray(jm.model.input_gradient(jnp.asarray(flat), jnp.asarray(x), output_index=output_index))
    params = tt.params_from_numpy(flat, tm.model).requires_grad_(True)
    got = tm.model.input_gradient(params, torch.from_numpy(x), output_index)
    assert got.shape == x.shape and got.dtype == torch.float32 and not got.requires_grad
    assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert params.grad is None


@pytest.mark.parametrize("seed", [0, 1337])
def test_rng_distributions_match_jax(seed):
    for fn, args in (("generate_random_uniform", (-2.0, 3.0)), ("generate_random_logistic", (0.5, 2.0))):
        a, b = jr.PCG32(seed), tr.PCG32(seed)
        for n in (1, 1000):
            want = getattr(jr, fn)(a, n, *args)
            got = getattr(tr, fn)(b, n, *args)
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want)
        assert int(a.next_uint()) == int(b.next_uint())
        np.testing.assert_array_equal(tr.generate_random_uniform(tr.PCG32(seed), 8),
                                      jr.generate_random_uniform(jr.PCG32(seed), 8))


ENCODINGS = [
    (3, {"otype": "Identity"}), (3, {"otype": "Empty"}), (2, {"otype": "Frequency", "n_frequencies": 4}),
    (2, {"otype": "TriangleWave", "n_frequencies": 4}), (2, {"otype": "OneBlob", "n_bins": 8}),
    (2, CFG["encoding"]), (2, {"otype": "DenseGrid", "n_levels": 2}), (3, {"otype": "SphericalHarmonics", "degree": 3}),
    (3, {"otype": "Composite", "nested": [{"n_dims_to_encode": 2, "otype": "Frequency", "n_frequencies": 2},
                                          {"otype": "OneBlob", "n_bins": 4}]}),
]


@pytest.mark.parametrize("n_dims,cfg", ENCODINGS, ids=[c["otype"] for _, c in ENCODINGS])
def test_encoding_name_matches_jax(n_dims, cfg):
    want = tc.create_encoding(n_dims, cfg).name
    assert tt.create_encoding(n_dims, cfg).name == want


@pytest.mark.parametrize("otype", ["CutlassMLP", "MLP", "FullyFusedMLP"])
def test_network_name_and_alignment_match_jax(otype):
    cfg = {"otype": otype, "n_neurons": 32, "n_hidden_layers": 1}
    want, got = tc.create_network(16, 3, cfg), tt.create_network(16, 3, cfg)
    assert got.name == want.name
    assert got.required_input_alignment() == want.required_input_alignment()
