"""The port's ``utils.data.HostImageSampler`` against the JAX package's
(``tcnn_tpu.utils.data.HostImageSampler``), on the CPU.

- the native path: the port's own helper (``runtime/host_sampler.cpp``)
  gives the JAX package's native batches bit for bit, for three seeds,
  stratified and i.i.d., over several ``next()`` calls, on every sample
  that the JAX package's sampler puts inside its raster tile; on the
  stratified samples it puts on or past a tile edge (its fp32 ``col + u``
  rounds up to ``col + 1``), the port's lie strictly inside the tile and
  read the pixel at their position (a 512^2 batch has a few such samples
  a call);
- the numpy fallbacks (each package's ``native._load`` patched to None)
  give equal batches bit for bit, with the same exception; a jitter of
  the largest fp32 below 1 puts every JAX fallback sample of a 512^2
  batch on its upper edge and every port sample inside;
- the port never loads the JAX package's library;
- the JAX file's contract tests (tests/test_host_sampler.py), as cases of
  one parametrised test over both paths: shapes, positions in [0, 1), rgb
  the pixel at xy, the stream advancing, stratified batches in their
  tiles; a non-square stratified batch raises; a model trains on the
  batches (the loss falls over 15 steps).
"""

import numpy as np
import pytest

import tcnn_tpu.runtime.native as jnative
import tcnn_tpu_torch as tt
import tcnn_tpu_torch.runtime.native as tnative
from tcnn_tpu.utils.data import HostImageSampler as JaxSampler
from tcnn_tpu_torch.utils.data import HostImageSampler
from tcnn_tpu_torch.utils.sampling import is_stratified


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(0).random((32, 48, 3)).astype(np.float32)


def _batches(cls, image, batch, stratified, seed, n=4):
    with cls(image, batch, stratified=stratified, seed=seed) as s:
        return s.native, [s.next() for _ in range(n)]


def _tiles(batch):
    """Each sample's raster tile (col, row) of a stratified batch."""
    strata = int(round(np.sqrt(batch)))
    ids = np.arange(batch)
    return np.stack([ids % strata, ids // strata], axis=1), strata


def _outside_tiles(xy):
    """Rows of a stratified batch with a coordinate outside its tile,
    floor(x * strata) != tile in exact arithmetic (fp32 times an int is
    exact in float64)."""
    tiles, strata = _tiles(xy.shape[0])
    return np.any(np.floor(xy.astype(np.float64) * strata) != tiles, axis=1)


def _assert_equal_but_edges(image, got, want, stratified):
    """The port's batches equal the JAX package's bit for bit on every
    sample the JAX sampler puts inside its tile; the others lie inside
    theirs in the port's batch and read the pixel at their position.
    Returns the count of those."""
    h, w, _ = image.shape
    n_edge = 0
    for (xy, rgb), (jxy, jrgb) in zip(got, want):
        edge = _outside_tiles(jxy) if stratified else np.zeros(len(jxy), bool)
        np.testing.assert_array_equal(xy[~edge], jxy[~edge])
        np.testing.assert_array_equal(rgb[~edge], jrgb[~edge])
        if stratified:
            assert not _outside_tiles(xy).any()
            px = np.minimum((xy[edge, 0] * w).astype(np.int64), w - 1)
            py = np.minimum((xy[edge, 1] * h).astype(np.int64), h - 1)
            np.testing.assert_array_equal(rgb[edge], image[py, px])
        n_edge += int(edge.sum())
    return n_edge


@pytest.mark.parametrize("stratified,batch", [(True, 256), (False, 300), (True, 512**2)])
@pytest.mark.parametrize("seed", [0, 3, 2**40 + 7])
def test_native_batches_equal_the_jax_samplers(image, stratified, batch, seed):
    native_t, got = _batches(HostImageSampler, image, batch, stratified, seed)
    native_j, want = _batches(JaxSampler, image, batch, stratified, seed)
    assert native_t and native_j, tnative.build_error
    _assert_equal_but_edges(image, got, want, stratified)


@pytest.mark.parametrize("stratified,batch", [(True, 256), (False, 300), (True, 512**2)])
@pytest.mark.parametrize("seed", [0, 3])
def test_fallback_batches_equal_the_jax_samplers(image, monkeypatch, stratified, batch, seed):
    monkeypatch.setattr(tnative, "_load", lambda: None)
    monkeypatch.setattr(jnative, "_load", lambda: None)
    native_t, got = _batches(HostImageSampler, image, batch, stratified, seed)
    native_j, want = _batches(JaxSampler, image, batch, stratified, seed)
    assert not native_t and not native_j
    _assert_equal_but_edges(image, got, want, stratified)


class _TopJitter:
    """A numpy generator stand-in whose uniforms are all the largest fp32
    below 1."""

    def random(self, shape, dtype):
        return np.full(shape, np.nextafter(np.float32(1), np.float32(0)), dtype)


def test_fallback_keeps_edge_jitter_inside_the_tiles(image, monkeypatch):
    monkeypatch.setattr(tnative, "_load", lambda: None)
    monkeypatch.setattr(jnative, "_load", lambda: None)
    batch = 512**2
    with HostImageSampler(image, batch, seed=0) as s, JaxSampler(image, batch, seed=0) as j:
        s._rng = j._rng = _TopJitter()
        got, want = s.next(), j.next()
    tiles, strata = _tiles(batch)
    # Past tile 127 the fp32 sum col + (1 - 2^-24) rounds up to col + 1.
    on_edge = np.floor(want[0].astype(np.float64) * strata) == tiles + 1
    assert on_edge[tiles >= 128].all()
    assert not _outside_tiles(got[0]).any()
    assert _assert_equal_but_edges(image, [got], [want], True) == int(_outside_tiles(want[0]).sum())


def test_the_port_builds_its_own_library():
    lib = tnative._load()
    assert lib is not None, tnative.build_error
    path = tnative.library_path()
    assert path.exists() and path.name.startswith("libhost_sampler-") and path.parent.parts[-2:] == (
        "build", "tcnn_tpu_torch")
    assert "librtcnn" not in lib._name and "-march=native" not in tnative.FLAGS


def _check(sampler, image):
    h, w, _ = image.shape
    xy, rgb = sampler.next()
    assert xy.shape == (sampler.batch, 2) and rgb.shape == (sampler.batch, 3)
    assert xy.dtype == rgb.dtype == np.float32
    assert 0.0 <= xy.min() and xy.max() < 1.0
    px = np.minimum((xy[:, 0] * w).astype(int), w - 1)
    py = np.minimum((xy[:, 1] * h).astype(int), h - 1)
    np.testing.assert_array_equal(rgb, image[py, px])
    xy2, _ = sampler.next()
    assert not np.array_equal(xy, xy2)  # stream advances
    return xy


def _contract_stratified(image):
    with HostImageSampler(image, 256, stratified=True, seed=3) as s:
        assert is_stratified(_check(s, image))


def _contract_iid(image):
    with HostImageSampler(image, 300, stratified=False, seed=3) as s:
        _check(s, image)


def _contract_non_square_rejected(image):
    with pytest.raises(ValueError):
        HostImageSampler(image, 300, stratified=True)


def _contract_trains_with_model(image):
    cfg = {
        "loss": {"otype": "RelativeL2"},
        "optimizer": {"otype": "Adam", "learning_rate": 1e-2},
        "encoding": {
            "otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2, "log2_hashmap_size": 8,
            "base_resolution": 4, "per_level_scale": 1.5, "hash": "CoherentAdditive",
            "gather_strategy": "stratified", "strata": 16,
        },
        "network": {"otype": "CutlassMLP", "n_neurons": 16, "n_hidden_layers": 1},
    }
    model = tt.create_from_config(2, 3, cfg, device="cpu")
    with HostImageSampler(image, 256, stratified=True, seed=0) as s:
        losses = [float(model.training_step(*s.next())) for _ in range(15)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


CONTRACT = {"stratified": _contract_stratified, "iid": _contract_iid,
            "non_square_rejected": _contract_non_square_rejected, "trains_with_model": _contract_trains_with_model}


@pytest.mark.parametrize("path", ["native", "fallback"])
@pytest.mark.parametrize("case", list(CONTRACT))
def test_contract(image, monkeypatch, path, case):
    if path == "fallback":
        monkeypatch.setattr(tnative, "_load", lambda: None)
    with HostImageSampler(image, 256, seed=1) as s:
        assert s.native == (path == "native")
    CONTRACT[case](image)
