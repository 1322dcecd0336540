"""The image-fit sample and the image metrics of the port against the JAX
package's: ``tcnn_tpu_torch.samples.mlp_learning_an_image`` (its image,
config, ``--phase-locked`` handling, image loading and a tiny CPU run with
its output keys) and ``tcnn_tpu_torch.utils.metrics`` (every metric, at
fp64 rounding: rtol 1e-12).
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import samples.mlp_learning_an_image as jsample  # noqa: E402
import tcnn_tpu.utils.metrics as jmetrics  # noqa: E402
import tcnn_tpu_torch.utils.metrics as tmetrics  # noqa: E402
from tcnn_tpu_torch.samples import mlp_learning_an_image as tsample  # noqa: E402

SMALL_GRID = {
    "loss": {"otype": "RelativeL2"},
    "optimizer": {"otype": "Adam", "learning_rate": 1e-2},
    "encoding": {"otype": "HashGrid", "n_levels": 4, "log2_hashmap_size": 10, "base_resolution": 8,
                 "gather_strategy": "stratified"},
    "network": {"otype": "FullyFusedMLP", "n_neurons": 16, "n_hidden_layers": 1},
}


def _images(seed=0):
    r = np.random.default_rng(seed)
    img = r.uniform(-0.1, 1.3, (16, 12, 3)).astype(np.float32)
    ref = np.clip(img + r.normal(0, 0.05, img.shape).astype(np.float32), 0, 1.2).astype(np.float32)
    return img, ref


@pytest.mark.parametrize("name", ["srgb_to_linear", "linear_to_srgb", "luminance"])
def test_color_functions_match_jax_package(name):
    img, _ = _images()
    img = np.abs(img)
    np.testing.assert_allclose(getattr(tmetrics, name)(img), getattr(jmetrics, name)(img), rtol=1e-12)


@pytest.mark.parametrize("metric", ["MAE", "MAPE", "SMAPE", "MSE", "MScE", "MRSE", "MtRSE", "MRScE"])
def test_compute_error_matches_jax_package(metric):
    img, ref = _images(1)
    got, want = tmetrics.compute_error(metric, img, ref), jmetrics.compute_error(metric, img, ref)
    assert np.isfinite(got) and got == pytest.approx(want, rel=1e-12)


def test_psnr_and_errors_match_jax_package():
    img, ref = _images(2)
    for fn in ("L1", "APE", "SAPE", "L2", "RSE"):
        np.testing.assert_allclose(getattr(tmetrics, fn)(img, ref), getattr(jmetrics, fn)(img, ref), rtol=1e-12)
    assert tmetrics.psnr(img, ref) == pytest.approx(jmetrics.psnr(img, ref), rel=1e-12)
    assert tmetrics.psnr(img, ref, peak=2.0) == pytest.approx(jmetrics.psnr(img, ref, peak=2.0), rel=1e-12)
    assert tmetrics.psnr(ref, ref) == float("inf")
    with pytest.raises(ValueError, match="Unknown metric"):
        tmetrics.compute_error("nope", img, ref)


def test_synthetic_image_and_config_equal_the_jax_sample():
    np.testing.assert_array_equal(tsample.synthetic_image(), jsample.synthetic_image())
    assert tsample.synthetic_image(64).tobytes() == jsample.synthetic_image(64).tobytes()
    assert tsample.DEFAULT_CONFIG == jsample.DEFAULT_CONFIG


def test_phase_locked_wraps_only_the_default_config(tmp_path):
    """--phase-locked[=G] as the JAX sample (:109-139): the encoding gets
    phase_locked and locked_phases; the default config's optimizer, and only
    the default's, is wrapped in EMA(0.99)."""
    cfg = tsample.resolve_config("-", 4)
    assert cfg["encoding"]["phase_locked"] is True and cfg["encoding"]["locked_phases"] == 4
    assert cfg["optimizer"] == {"otype": "EMA", "decay": 0.99, "nested": jsample.DEFAULT_CONFIG["optimizer"]}
    assert tsample.resolve_config("-", 0) == jsample.DEFAULT_CONFIG
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(SMALL_GRID))
    own = tsample.resolve_config(str(path), 1)
    assert own["optimizer"] == SMALL_GRID["optimizer"] and own["encoding"]["locked_phases"] == 1
    assert tsample.build_parser().parse_args(["--phase-locked"]).phase_locked == 1
    assert tsample.build_parser().parse_args(["--phase-locked=3"]).phase_locked == 3


def test_load_image_matches_the_jax_sample(tmp_path):
    r = np.random.default_rng(3)
    for img in (r.integers(0, 256, (6, 5, 4)).astype(np.float32), r.uniform(0, 1, (7, 3)).astype(np.float32)):
        path = tmp_path / "img.npy"
        np.save(path, img)
        np.testing.assert_array_equal(tsample.load_image(str(path)), jsample.load_image(str(path)))
    with pytest.raises(ValueError, match="npy"):
        tsample.load_image(str(tmp_path / "img.png"))


def test_tiny_cpu_fit_writes_the_jax_sample_outputs(tmp_path, capsys):
    cfg = tmp_path / "small.json"
    cfg.write_text(json.dumps(SMALL_GRID))
    out = tmp_path / "out"
    metrics = tsample.main(["-", str(cfg), "2", str(out), "--device", "cpu"])
    written = json.loads((out / "metrics.json").read_text())
    assert set(written) == {"image", "steps", "batch", "train_seconds", "ms_per_step", "first_step_seconds",
                            "psnr_db", "mse", "loss_curve"}
    assert written == json.loads(json.dumps(metrics))
    assert written["image"] == "synthetic" and written["steps"] == 2 and written["batch"] == 2**18
    assert [i for i, _ in written["loss_curve"]] == [0, 1] and np.isfinite(written["psnr_db"])
    assert np.load(out / "fitted_image.npy").shape == (512, 512, 3)
    text = capsys.readouterr().out
    assert "step     0  loss" in text and "PSNR:" in text and "samples/s" in text
