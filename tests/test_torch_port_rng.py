"""PCG32 and parameter init: the PyTorch port against the JAX package.

Both packages draw initial parameters from PCG32 on the host, so the same
config and seed must give bit-identical flat parameter vectors.
"""

import numpy as np
import pytest

import tcnn_tpu as tc
import tcnn_tpu.rng as jrng
import tcnn_tpu_torch as tt
import tcnn_tpu_torch.rng as trng


@pytest.mark.parametrize("seed", [0, 1, 1337, 2**40 + 7])
def test_pcg32_streams_identical(seed):
    a, b = jrng.PCG32(seed), trng.PCG32(seed)
    for n in (1, 2, 3, 1000, 65537):
        np.testing.assert_array_equal(a.next_uint(n), b.next_uint(n))
    np.testing.assert_array_equal(a.next_float(777), b.next_float(777))
    assert a.next_float() == b.next_float()
    a.advance(123456789)
    b.advance(123456789)
    assert a.state == b.state
    np.testing.assert_array_equal(a.next_uint(10), b.next_uint(10))


def test_make_rng_matches_jax_factory():
    # The JAX factory may return its native helper; its draws are the same.
    np.testing.assert_array_equal(jrng.make_rng(42).next_float(4096), trng.make_rng(42).next_float(4096))


def _flagship():
    import __graft_entry__ as g

    return g.FLAGSHIP_CONFIG


SMALL = {
    "encoding": {"otype": "HashGrid", "n_levels": 4, "log2_hashmap_size": 10, "base_resolution": 4},
    "network": {"otype": "FullyFusedMLP", "n_neurons": 32, "n_hidden_layers": 1},
}
SIREN = {
    "encoding": {"otype": "DenseGrid", "n_levels": 3, "base_resolution": 4},
    "network": {"otype": "FullyFusedMLP", "n_neurons": 16, "n_hidden_layers": 3, "activation": "Sine"},
}
CUTLASS = {
    "encoding": {"otype": "HashGrid", "n_levels": 8, "n_features_per_level": 4, "log2_hashmap_size": 9},
    "network": {"otype": "CutlassMLP", "n_neurons": 48, "n_hidden_layers": 0},
}


@pytest.mark.parametrize("name", ["flagship", "small", "siren", "cutlass"])
@pytest.mark.parametrize("seed", [1337, 7])
def test_initialize_params_identical(name, seed):
    cfg = {"flagship": _flagship(), "small": SMALL, "siren": SIREN, "cutlass": CUTLASS}[name]
    dims = 2 if name != "siren" else 3
    jm = tc.create_from_config(dims, 3, cfg, seed=seed)
    tm = tt.create_from_config(dims, 3, cfg, seed=seed, device="cpu")
    want = np.asarray(jm.trainer.params)
    got = tm.trainer.params.numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    if name == "flagship":
        assert got.shape == (715760,)
    np.testing.assert_array_equal(got, want)
    assert tm.model.layer_sizes() == jm.model.layer_sizes()
