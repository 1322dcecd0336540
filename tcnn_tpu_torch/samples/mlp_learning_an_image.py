"""Image-fit sample: learns (x, y) -> RGB of an image with a trainable
input encoding and a tiny MLP (the port of the JAX package's
``samples/mlp_learning_an_image.py:29-224``; reference:
samples/mlp_learning_an_image.cu).

Usage:
    python -m tcnn_tpu_torch.samples.mlp_learning_an_image [image.npy|-]
        [config.json|-] [n_steps] [out_dir] [--phase-locked[=G]]
        [--device cuda]

Without an image the synthetic 512x512 test image is fitted (the repo
carries no binary assets). Each step draws a stratified batch of 2^18
positions on the card from a ``torch.Generator`` (seed 42), takes each
position's nearest pixel as its target and runs ``training_step``; every
100 steps a ``step / loss / samples/s`` line. Then ``inference_raster``
renders the image and the PSNR line follows; with ``out_dir`` the fitted
image (``fitted_image.npy``) and ``metrics.json`` (the JAX sample's keys)
are written there.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..benchmarks import bench_device, sync
from ..config import create_from_config, load_config
from ..utils.metrics import psnr as psnr_of
from ..utils.sampling import stratified_uniform

DEFAULT_CONFIG = {
    # Mirrors the reference's data/config_hash.json protocol.
    "loss": {"otype": "RelativeL2"},
    "optimizer": {
        "otype": "Adam",
        "learning_rate": 1e-2,
        "beta1": 0.9,
        "beta2": 0.99,
        "epsilon": 1e-15,
        "l2_reg": 1e-6,
    },
    "encoding": {
        "otype": "HashGrid",
        "n_levels": 16,
        "n_features_per_level": 2,
        "log2_hashmap_size": 15,
        "base_resolution": 16,
        "per_level_scale": 1.5,
        # The JAX package's fast-path keys: the additive hash (part of the
        # function) and the stratified strategy (raster strides on coarse
        # levels, also part of the function).
        "hash": "CoherentAdditive",
        "gather_strategy": "stratified",
    },
    "network": {
        "otype": "FullyFusedMLP",
        "activation": "ReLU",
        "output_activation": "None",
        "n_neurons": 64,
        "n_hidden_layers": 2,
    },
}

BATCH = 2**18
SEED = 42


def synthetic_image(res: int = 512) -> np.ndarray:
    """(samples/mlp_learning_an_image.py:62-72)"""
    yy, xx = np.meshgrid(np.linspace(0, 1, res), np.linspace(0, 1, res),
                         indexing="ij")
    return np.stack(
        [
            0.5 + 0.5 * np.sin(8 * np.pi * xx) * np.cos(6 * np.pi * yy),
            0.5 + 0.5 * np.cos(4 * np.pi * (xx + yy)),
            0.5 + 0.5 * np.sin(2 * np.pi * (xx - yy) * 3),
        ],
        axis=-1,
    ).astype(np.float32)


def load_image(path: str) -> np.ndarray:
    """An (h, w, 3) fp32 image in [0, 1] from a ``.npy`` file (values above
    1.5 are read as 8-bit; grayscale is repeated to RGB)."""
    p = Path(path)
    if p.suffix != ".npy":
        raise ValueError(f"load_image: {p} is not a .npy file")
    img = np.asarray(np.load(p), np.float32)
    if img.max() > 1.5:
        img = img / 255.0
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    return img[..., :3]


def build_parser():
    ap = argparse.ArgumentParser(description="Fit an image with a hash grid and a tiny MLP.")
    ap.add_argument("image", nargs="?", default="-", help=".npy image, or - for the synthetic one")
    ap.add_argument("config", nargs="?", default="-", help="JSON config, or - for DEFAULT_CONFIG")
    ap.add_argument("n_steps", nargs="?", type=int, default=1000)
    ap.add_argument("out_dir", nargs="?", default=None, help="write fitted_image.npy and metrics.json here")
    ap.add_argument("--phase-locked", nargs="?", type=int, const=1, default=0, metavar="G",
                    help="G shared jitter phases per batch and phase-locked fine levels; wraps the default "
                    "config's optimizer in EMA(0.99)")
    ap.add_argument("--device", default="cuda")
    return ap


def resolve_config(config_arg: str, phase_locked: int) -> dict:
    """The config file (or DEFAULT_CONFIG), with ``--phase-locked`` applied
    as the JAX sample does (:129-139)."""
    is_default = config_arg in ("", "-")
    config = DEFAULT_CONFIG if is_default else load_config(config_arg)
    config = json.loads(json.dumps(config))
    if phase_locked:
        config["encoding"]["phase_locked"] = True
        config["encoding"]["locked_phases"] = phase_locked
        config["encoding"].setdefault("gather_strategy", "stratified")
        if is_default:
            config["optimizer"] = {"otype": "EMA", "decay": 0.99, "nested": config["optimizer"]}
    return config


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = bench_device(args.device)
    image = synthetic_image() if args.image in ("", "-") else load_image(args.image)
    config = resolve_config(args.config, args.phase_locked)
    n_steps, batch, phase_locked = args.n_steps, BATCH, args.phase_locked
    h, w, _ = image.shape
    print(f"Fitting a {w}x{h} image with {config['encoding']['otype']} + {config['network']['otype']}"
          + (f" [phase-locked G={phase_locked}]" if phase_locked else ""), flush=True)

    model = create_from_config(2, 3, config, device=dev)
    trainer = model.trainer
    img = torch.from_numpy(image).to(dev).reshape(h * w, 3)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def step():
        # Stratified jitter: the reference's uniform marginals, one sample
        # per raster tile; the nearest pixel is the target.
        xy = stratified_uniform(batch, 2, gen, phase_locked=phase_locked)
        ij_y = torch.clamp((xy[:, 1] * h).to(torch.int64), 0, h - 1)
        ij_x = torch.clamp((xy[:, 0] * w).to(torch.int64), 0, w - 1)
        return trainer.training_step(xy, img[ij_y * w + ij_x])

    loss_curve = []
    t0 = time.perf_counter()
    t_first = None
    for i in range(n_steps):
        loss = step()
        if i == 0:
            loss = float(loss)  # synchronises: steady-state timing starts after step 0
            t_first = time.perf_counter()
        if i % 100 == 0 or i == n_steps - 1:
            loss = float(loss)
            loss_curve.append([i, loss])
            elapsed = time.perf_counter() - t0
            print(f"step {i:5d}  loss {loss:.3e}  [{elapsed:.2f}s, {batch * (i + 1) / max(elapsed, 1e-9):.3g} "
                  f"samples/s]", flush=True)
    sync(dev)
    train_time = time.perf_counter() - t0
    steady_ms = (time.perf_counter() - t_first) / max(n_steps - 1, 1) * 1e3 if n_steps > 1 else train_time * 1e3
    print(f"steady-state {steady_ms:.1f} ms/step ({batch / steady_ms * 1e3:.3g} samples/s); "
          f"first step {t_first - t0:.1f}s")

    t_render = time.perf_counter()
    pred = trainer.inference_raster((w, h)).cpu().numpy().reshape(h, w, 3)
    print(f"render: {time.perf_counter() - t_render:.2f}s ({h * w} points, one raster call)")
    mse = float(np.mean((pred - image) ** 2))
    psnr = psnr_of(pred, image)
    print(f"PSNR: {psnr:.2f} dB", flush=True)
    metrics = {
        "image": args.image if args.image not in ("", "-") else "synthetic",
        "steps": n_steps,
        "batch": batch,
        "train_seconds": round(train_time, 3),
        "ms_per_step": round(steady_ms, 3),
        "first_step_seconds": round(t_first - t0, 3),
        "psnr_db": round(psnr, 3),
        "mse": mse,
        "loss_curve": loss_curve,
    }
    if args.out_dir:
        out_dir = Path(args.out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        np.save(out_dir / "fitted_image.npy", pred)
        (out_dir / "metrics.json").write_text(json.dumps(metrics, indent=1) + "\n")
        print(f"wrote {out_dir}/fitted_image.npy, metrics.json")
    return metrics


if __name__ == "__main__":
    main()
