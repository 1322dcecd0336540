"""Real-time rendering sample: train an image field, then serve it at
interactive rates through a ``FrozenServer`` (the port of the JAX
package's ``samples/realtime_render.py``; reference:
samples/mlp_learning_an_image.cu:116-124).

Fits the synthetic 512x512 image for ``--steps`` training steps through
``trainer.training_steps`` (one step captured as a CUDA graph on the card,
its stratified batch and nearest-pixel targets drawn on the device), freezes
a server and renders ``--frames`` frames twice: the static view, one
``server.raster`` call a frame, and a pan/zoom camera path, one
``server(x)`` batch a frame at the tile-centre raster zoomed and shifted on
the device. Both report frames/second.

Usage:
    python -m tcnn_tpu_torch.samples.realtime_render [--steps 300]
        [--side 512] [--frames 120] [--batch 262144] [--out render.npy]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..benchmarks import bench_device
from ..config import create_from_config
from ..utils.profiling import sync
from ..utils.sampling import stratified_uniform
from .mlp_learning_an_image import DEFAULT_CONFIG, synthetic_image

SEED = 7


def base_grid(side: int, device) -> torch.Tensor:
    """The (side^2, 2) tile-centre positions of the moving view, x fastest:
    the JAX sample's meshgrid with its columns swapped, built on
    ``device`` from the ``side`` centres (fp64 in numpy, then fp32, as the
    JAX sample rounds them)."""
    c = torch.from_numpy(((np.arange(side) + 0.5) / side).astype(np.float32)).to(device)
    rows, cols = torch.meshgrid(c, c, indexing="ij")
    return torch.stack([rows, cols], dim=-1).reshape(side * side, 2).flip(1)


def view(base: torch.Tensor, i: int, frames: int) -> torch.Tensor:
    """Frame ``i`` of the pan/zoom path: ``base * zoom + (ox, oy)`` in fp32,
    on the device of ``base``."""
    zoom = 0.6 + 0.4 * np.cos(2 * np.pi * i / frames)
    pan = 0.5 * (1 - zoom)
    ox = pan * (0.5 + 0.5 * np.sin(2 * np.pi * i / frames))
    oy = pan
    # Scalar operands, so that no host-to-device copy enters a frame.
    v = base * float(np.float32(zoom))
    v[:, 0] += float(np.float32(ox))
    v[:, 1] += float(np.float32(oy))
    return v


def image_batches(image: np.ndarray, batch: int, device):
    """``(batch_fn, data)`` for ``trainer.training_steps``: a stratified
    batch of positions drawn from ``data["gen"]`` and each position's
    nearest pixel of ``image``, all on ``device``."""
    h, w, _ = image.shape
    data = {"gen": torch.Generator(device=device).manual_seed(SEED),
            "img": torch.from_numpy(image).to(device).reshape(h * w, 3)}

    def batch_fn(d, i):
        xy = stratified_uniform(batch, 2, d["gen"])
        ij_y = torch.clamp((xy[:, 1] * h).to(torch.int64), 0, h - 1)
        ij_x = torch.clamp((xy[:, 0] * w).to(torch.int64), 0, w - 1)
        return xy, d["img"][ij_y * w + ij_x]

    return batch_fn, data


def _fps_line(what: str, frames: int, side: int, dt: float) -> str:
    return (f"{what}: {frames} frames of {side}^2 in {dt:.2f}s -> {frames / dt:.1f} FPS "
            f"({side * side * frames / dt / 1e6:.1f} M samples/s)")


def build_parser():
    ap = argparse.ArgumentParser(description="Train an image field, then serve it through a FrozenServer.")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--side", type=int, default=512)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--batch", type=int, default=2**18)
    ap.add_argument("--out", default=None, help="save the last frame (npy)")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> dict:
    """Returns the loss, both frame rates and the ``server``."""
    args = build_parser().parse_args(argv)
    dev = bench_device(args.device)
    model = create_from_config(2, 3, DEFAULT_CONFIG, device=dev)
    trainer = model.trainer
    batch_fn, data = image_batches(synthetic_image(), args.batch, dev)

    t0 = time.time()
    losses = trainer.training_steps(batch_fn, args.steps, data)
    loss = float(losses[-1])
    print(f"trained {args.steps} steps in {time.time() - t0:.1f}s (loss {loss:.3e})", flush=True)

    server = trainer.freeze_serving()
    side, frames = args.side, args.frames

    # Static view: full-raster frames, one raster call each.
    sync(server.raster((side, side)))
    t0 = time.perf_counter()
    for _ in range(frames):
        frame = server.raster((side, side))
    sync(frame)
    static_s = time.perf_counter() - t0
    print(_fps_line("static view ", frames, side, static_s), flush=True)

    # Moving camera: per-frame pan/zoom -> arbitrary query batches.
    base = base_grid(side, dev)
    sync(server(view(base, 0, frames)))
    t0 = time.perf_counter()
    for i in range(frames):
        frame = server(view(base, i, frames))
    sync(frame)
    moving_s = time.perf_counter() - t0
    print(_fps_line("moving view ", frames, side, moving_s), flush=True)

    if args.out:
        np.save(args.out, frame.cpu().numpy().reshape(side, side, 3))
        print(f"wrote {args.out}", flush=True)
    return {"loss": loss, "static_fps": frames / static_s, "moving_fps": frames / moving_s, "server": server}


if __name__ == "__main__":
    main()
