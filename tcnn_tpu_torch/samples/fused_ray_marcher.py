"""Whole-program sample: a NeRF-style ray marcher with the model inlined (the
port of the JAX package's ``samples/fused_ray_marcher.py``).

The reference stitches the model's device function into a hand-written
renderer kernel (README.md:103-144); the JAX package traces ``model.apply``
into one jitted ``lax.scan``. Here the march of all ``N_STEPS`` steps, each
the grid lookup, the fused MLP forward and the compositing ops, is captured
once as one CUDA graph (``Marcher``) and replayed per render: one launch of
the whole program from the host.

The field is a HashGrid + FullyFusedMLP from 3D positions to (density,
r, g, b): softplus density, sigmoid colour, front-to-back compositing of
``N_STEPS`` steps a ray through the unit cube.

Usage:
    python -m tcnn_tpu_torch.samples.fused_ray_marcher [--rays 4096]
        [--steps 64] [--renders 10] [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..benchmarks import bench_device
from ..common import resolve_device
from ..network_with_input_encoding import NetworkWithInputEncoding
from ..rng import make_rng
from ..utils.profiling import sync

CONFIG = {
    "encoding": {
        "otype": "HashGrid",
        "n_levels": 8,
        "n_features_per_level": 2,
        "log2_hashmap_size": 15,
        "base_resolution": 8,
        "per_level_scale": 1.6,
    },
    "network": {
        "otype": "FullyFusedMLP",
        "n_neurons": 64,
        "n_hidden_layers": 2,
        "output_activation": "None",
    },
}

N_RAYS = 4096
N_STEPS = 64
N_RENDERS = 10


def make_model(device):
    """3D position -> (density, r, g, b), and its parameters from PCG32 seed
    1337 on ``device``."""
    model = NetworkWithInputEncoding(3, 4, encoding_config=CONFIG["encoding"], network_config=CONFIG["network"],
                                     device=device)
    params = torch.from_numpy(model.initialize_params(make_rng(1337))).to(device)
    return model, params


def make_rays(n_rays: int = N_RAYS, device=None):
    """The sample's rays: origins uniform on the z = 0 face (numpy seed 0),
    all pointing along +z, on ``device`` (None: the card; raises without
    one)."""
    device = resolve_device(device)
    r = np.random.default_rng(0)
    origins = np.stack([r.uniform(0, 1, n_rays), r.uniform(0, 1, n_rays), np.zeros(n_rays)], 1).astype(np.float32)
    dirs = np.stack([np.zeros(n_rays), np.zeros(n_rays), np.ones(n_rays)], 1).astype(np.float32)
    return torch.from_numpy(origins).to(device), torch.from_numpy(dirs).to(device)


@torch.no_grad()
def render_plain(model, params, origins, dirs, n_steps: int = N_STEPS, plain: bool = False):
    """The eager march: ``n_steps`` steps of ``model.apply`` at the midpoints
    of the steps of t in [0, 1], composited front to back. Returns (colour
    (n, 3), transmittance (n, 1)), fp32. ``plain`` runs every kernel's
    plain version."""
    apply = model.apply_plain if plain else model.apply
    dt = 1.0 / n_steps
    color = torch.zeros((origins.shape[0], 3), dtype=torch.float32, device=origins.device)
    transmittance = torch.ones((origins.shape[0], 1), dtype=torch.float32, device=origins.device)
    for i in range(n_steps):
        pos = origins + dirs * ((i + 0.5) * dt)
        raw = apply(params, pos).to(torch.float32)
        sigma = torch.nn.functional.softplus(raw[:, 0:1])
        rgb = torch.sigmoid(raw[:, 1:4])
        alpha = 1.0 - torch.exp(-sigma * dt)
        color = color + transmittance * alpha * rgb
        transmittance = transmittance * (1.0 - alpha)
    return color, transmittance


class Marcher:
    """The march of ``n_rays`` rays captured once as one CUDA graph.

    On the card the constructor runs the march once on a side stream (it
    builds and loads the kernels and fills the encoding's and the MLP's
    per-shape caches, whose first use copies to the device), then captures
    it; a capture that fails raises. A call copies the rays into the tensors
    the graph reads and replays it. On the CPU a call runs the eager
    march."""

    def __init__(self, model, params, n_rays: int = N_RAYS, n_steps: int = N_STEPS):
        self.model, self.params, self.n_steps = model, params, int(n_steps)
        dev = params.device
        self.origins = torch.zeros((n_rays, 3), dtype=torch.float32, device=dev)
        self.dirs = torch.zeros((n_rays, 3), dtype=torch.float32, device=dev)
        self.graph = None
        if dev.type != "cuda":
            return
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._march()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.color, self.transmittance = self._march()
        self.graph = graph

    def _march(self):
        return render_plain(self.model, self.params, self.origins, self.dirs, self.n_steps)

    def __call__(self, origins, dirs):
        """(colour (n, 3), transmittance (n, 1)) of the rays, fp32, as new
        tensors."""
        self.origins.copy_(origins)
        self.dirs.copy_(dirs)
        if self.graph is None:
            return self._march()
        self.graph.replay()
        return self.color.clone(), self.transmittance.clone()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Render a hash-grid field with a ray marcher captured as one CUDA graph.")
    ap.add_argument("--rays", type=int, default=N_RAYS)
    ap.add_argument("--steps", type=int, default=N_STEPS, help="steps a ray")
    ap.add_argument("--renders", type=int, default=N_RENDERS, help="timed renders")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = bench_device(args.device)
    model, params = make_model(dev)
    origins, dirs = make_rays(args.rays, dev)

    t0 = time.perf_counter()
    marcher = Marcher(model, params, args.rays, args.steps)
    color, transmittance = marcher(origins, dirs)
    sync(color)
    first = time.perf_counter() - t0
    print(f"compile+first render: {first:.2f}s")

    t0 = time.perf_counter()
    for _ in range(args.renders):
        color, transmittance = marcher(origins, dirs)
    sync(color)
    per = (time.perf_counter() - t0) / args.renders
    rays_per_s = args.rays / per
    print(f"render: {per * 1e3:.2f} ms for {args.rays} rays x {args.steps} steps "
          f"({rays_per_s:.3g} rays/s, {rays_per_s * args.steps:.3g} samples/s)")
    mean_color = color.mean(0).cpu().numpy()
    mean_t = float(transmittance.mean())
    print(f"mean color {mean_color}, mean transmittance {mean_t:.3f}")
    return {"first_render_s": first, "ms_per_render": per * 1e3, "rays_per_s": rays_per_s,
            "samples_per_s": rays_per_s * args.steps, "mean_color": mean_color.tolist(),
            "mean_transmittance": mean_t}


if __name__ == "__main__":
    main()
