"""NGP-style radiance-field training on a synthetic analytic scene (the port
of the JAX package's ``samples/nerf_synthetic.py``; the reference's
flagship downstream use, Instant-NGP).

  model:  Composite[HashGrid(xyz) (+) SphericalHarmonics(dir)] -> FFMLP
          -> (rgb, sigma)
  render: N_SAMPLES jittered depth samples a ray, softplus density, alpha
          compositing, in torch around the model's kernels
  data:   three coloured Gaussian blobs; the ground truth is the analytic
          field volume-rendered with the same quadrature and the same jitter

Usage:
    python -m tcnn_tpu_torch.samples.nerf_synthetic [n_steps] [rays_per_batch]
        [out_dir] [--seed S] [--device cuda]

Each step draws rays and depth jitter on the device from a
``torch.Generator`` (``--seed``), renders the model and the analytic field,
takes the gradient of ``mean(diff^2 / (pred^2 + 1e-2))`` with respect to the
flat parameters and applies the trainer's optimizer to it unscaled (loss
scale 1, as the JAX sample does). Then a 128^2 validation view is rendered
and its PSNR printed, and the same view is served 30 times through
``FrozenServer`` (frames per second, field evaluations per second). With
``out_dir`` the rendered and true views are written there as
``nerf_pred.npy`` and ``nerf_gt.npy``.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from ..benchmarks import bench_device, sync
from ..config import create_from_config
from ..serving import FrozenServer
from ..utils.metrics import psnr as psnr_of

CONFIG = {
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
        "otype": "Composite",
        "nested": [
            {
                "otype": "HashGrid",
                "n_dims_to_encode": 3,
                "n_levels": 8,
                "n_features_per_level": 2,
                "log2_hashmap_size": 15,
                "base_resolution": 4,
                "per_level_scale": 1.6,
                "hash": "CoherentAdditive",
                "gather_strategy": "quad",
            },
            {"otype": "SphericalHarmonics", "degree": 3},
        ],
    },
    "network": {
        "otype": "FullyFusedMLP",
        "activation": "ReLU",
        "output_activation": "None",
        "n_neurons": 64,
        "n_hidden_layers": 2,
    },
}

N_SAMPLES = 32  # depth samples a ray
NEAR, FAR = 0.05, 1.6
VAL_RES = 128
N_SERVED_FRAMES = 30

_BLOBS = [[0.35, 0.35, 0.45], [0.65, 0.55, 0.5], [0.5, 0.7, 0.6]]
_RADII = [0.12, 0.10, 0.08]
_COLORS = [[0.9, 0.2, 0.15], [0.15, 0.7, 0.9], [0.95, 0.85, 0.2]]
_CAMERA = [0.5, -0.9, 0.5]


def scene_sigma_rgb(x: torch.Tensor):
    """Analytic density and colour on [0, 1]^3: three Gaussian blobs."""
    blobs = torch.tensor(_BLOBS, dtype=torch.float32, device=x.device)
    radii = torch.tensor(_RADII, dtype=torch.float32, device=x.device)
    colors = torch.tensor(_COLORS, dtype=torch.float32, device=x.device)
    d2 = torch.sum((x[:, None, :] - blobs[None]) ** 2, -1)  # (B, 3)
    dens = 60.0 * torch.exp(-d2 / (2 * radii[None] ** 2))
    sigma = torch.sum(dens, -1)
    rgb = (dens @ colors) / (sigma[:, None] + 1e-6)
    return sigma, rgb


def make_rays(uv: torch.Tensor):
    """Rays from a fixed camera through the image-plane points ``uv`` (n,
    2) in [0, 1]^2; the image plane spans x and z in [0.1, 0.9] at y = 0.
    Returns (origins, unit directions), each (n, 3)."""
    cam = torch.tensor(_CAMERA, dtype=torch.float32, device=uv.device)
    target = torch.stack([0.1 + 0.8 * uv[:, 0], torch.zeros_like(uv[:, 0]), 0.1 + 0.8 * uv[:, 1]], dim=1)
    d = target - cam
    d = d / torch.linalg.norm(d, dim=1, keepdim=True)
    return cam.expand_as(d), d


def validation_plane(res: int = VAL_RES, device=None) -> torch.Tensor:
    """The (res^2, 2) pixel centres of the validation view, row-major."""
    c = (np.arange(res) + 0.5) / res
    vv, uu = np.meshgrid(c, c, indexing="ij")
    return torch.from_numpy(np.stack([uu.ravel(), vv.ravel()], 1).astype(np.float32)).to(device)


def sample_points(origins: torch.Tensor, dirs: torch.Tensor, jitter=None):
    """The field's inputs of ``render``: N_SAMPLES depth samples a ray, at
    ``jitter`` (n, N_SAMPLES) in [0, 1) within each depth bin, else at the
    bins' midpoints, clamped to [0, 1]^3, and each sample's ray direction.
    Returns (points, directions), each (n * N_SAMPLES, 3)."""
    n = origins.shape[0]
    dt = (FAR - NEAR) / N_SAMPLES
    t = torch.from_numpy(np.linspace(NEAR, FAR, N_SAMPLES + 1)[:-1].astype(np.float32)).to(origins.device)
    if jitter is not None:
        t = t[None] + jitter * dt
    else:
        t = (t[None] + 0.5 * dt).expand(n, N_SAMPLES)
    pts = (origins[:, None, :] + dirs[:, None, :] * t[..., None]).reshape(n * N_SAMPLES, 3)
    dcast = dirs[:, None, :].expand(n, N_SAMPLES, 3).reshape(-1, 3)
    return torch.clamp(pts, 0.0, 1.0), dcast


def render(field, origins: torch.Tensor, dirs: torch.Tensor, jitter=None) -> torch.Tensor:
    """Volume rendering of ``field(pts, dirs)`` -> (sigma, rgb) at the
    samples of ``sample_points``. Returns (n, 3)."""
    n = origins.shape[0]
    dt = (FAR - NEAR) / N_SAMPLES
    sigma, rgb = field(*sample_points(origins, dirs, jitter))
    sigma = sigma.reshape(n, N_SAMPLES)
    rgb = rgb.reshape(n, N_SAMPLES, 3)
    alpha = 1.0 - torch.exp(-sigma * dt)
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=1)
    trans = torch.cat([torch.ones((n, 1), dtype=trans.dtype, device=trans.device), trans[:, :-1]], dim=1)
    w = alpha * trans
    return torch.sum(w[..., None] * rgb, dim=1)


def gt_field(pts, dirs):
    return scene_sigma_rgb(pts)


def model_field(apply, params: torch.Tensor, **kwargs):
    """The radiance field of a model's ``apply``: directions remapped to
    [0, 1]^3 for the SH encoding (the reference's convention), sigma =
    softplus(out_3 - 1), rgb = sigmoid(out_0..2)."""

    def field(pts, dirs):
        out = apply(params, torch.cat([pts, (dirs + 1.0) * 0.5], dim=1), **kwargs).to(torch.float32)
        return torch.nn.functional.softplus(out[:, 3] - 1.0), torch.sigmoid(out[:, :3])

    return field


def nerf_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    diff = pred - target
    return torch.mean(diff * diff / (pred * pred + 1e-2))


def loss_and_grad(model, origins, dirs, jitter, plain: bool = False):
    """Render the analytic field (the target) and the model with the same
    rays and jitter; return the loss and its gradient with respect to the
    flat parameters. ``plain`` runs every kernel's plain version."""
    net = model.model
    params = net.params
    target = render(gt_field, origins, dirs, jitter)
    with torch.enable_grad():
        pred = render(model_field(net.apply_plain if plain else net.apply, params), origins, dirs, jitter)
        loss = nerf_loss(pred, target)
        (grads,) = torch.autograd.grad(loss, params)
    return loss.detach(), grads


def train_step(model, origins, dirs, jitter, plain: bool = False) -> torch.Tensor:
    """One step of the sample: ``loss_and_grad``, then the trainer's
    optimizer applied to the gradient with loss scale 1 (the functional
    ``optimizer.step``, its results written into the trainer's tensors).
    Returns the loss as a 0-d device tensor."""
    loss, grads = loss_and_grad(model, origins, dirs, jitter, plain)
    model.trainer._optimizer_step(grads, plain, loss_scale=1.0)
    return loss


def draw_rays(n_rays: int, gen: torch.Generator, device):
    """Rays through uniform image-plane points and their depth jitter, drawn
    on ``device`` from ``gen``."""
    uv = torch.rand((n_rays, 2), generator=gen, device=device)
    origins, dirs = make_rays(uv)
    return origins, dirs, torch.rand((n_rays, N_SAMPLES), generator=gen, device=device)


def build_parser():
    ap = argparse.ArgumentParser(description="Train an NGP-style radiance field on an analytic scene.")
    ap.add_argument("n_steps", nargs="?", type=int, default=400)
    ap.add_argument("rays_per_batch", nargs="?", type=int, default=4096)
    ap.add_argument("out_dir", nargs="?", default=None, help="write nerf_pred.npy and nerf_gt.npy here")
    ap.add_argument("--seed", type=int, default=0, help="seed of the rays, the jitter and the parameters")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = bench_device(args.device)
    n_steps, n_rays, res, n_frames = args.n_steps, args.rays_per_batch, VAL_RES, N_SERVED_FRAMES
    model = create_from_config(6, 4, CONFIG, seed=1337 + args.seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    print(f"NeRF sample: {model.model.n_params} params, {n_rays} rays x {N_SAMPLES} samples a step, "
          f"{n_steps} steps on {dev}", flush=True)

    loss_curve = []
    t0 = time.perf_counter()
    t_first = None
    for i in range(n_steps):
        loss = train_step(model, *draw_rays(n_rays, gen, dev))
        if i == 0:
            sync(dev)
            t_first = time.perf_counter()
        if i % 100 == 0 or i == n_steps - 1:
            loss_curve.append([i, float(loss)])
            print(f"step {i:5d}  loss {loss_curve[-1][1]:.3e}  [{time.perf_counter() - t0:.1f}s]", flush=True)
    sync(dev)
    t_end = time.perf_counter()
    ms_per_step = (t_end - t_first) / max(n_steps - 1, 1) * 1e3 if n_steps > 1 else (t_end - t0) * 1e3

    # Validation: render a res^2 view and compare it with the ground truth.
    origins, dirs = make_rays(validation_plane(res, dev))
    with torch.no_grad():
        pred = render(model_field(model.model.apply, model.trainer.params), origins, dirs)
        gt = render(gt_field, origins, dirs)
    pred_np = pred.cpu().numpy().reshape(res, res, 3)
    gt_np = gt.cpu().numpy().reshape(res, res, 3)
    psnr = psnr_of(pred_np, gt_np)
    print(f"validation view PSNR: {psnr:.2f} dB", flush=True)

    # Serving: the same view through a FrozenServer over cat([pts, (dirs +
    # 1) / 2]): each frame is res^2 rays x N_SAMPLES field evaluations.
    server = FrozenServer(model.trainer)

    def served(pts, d):
        out = server(torch.cat([pts, (d + 1.0) * 0.5], dim=1))
        return torch.nn.functional.softplus(out[:, 3] - 1.0), torch.sigmoid(out[:, :3])

    render(served, origins, dirs)
    sync(dev)
    t_serve = time.perf_counter()
    for _ in range(n_frames):
        frame = render(served, origins, dirs)
    sync(dev)
    dt = time.perf_counter() - t_serve
    evals = res * res * N_SAMPLES
    fps = n_frames / dt
    print(f"served render: {n_frames} frames of {res}^2 x {N_SAMPLES} samples in {dt:.2f}s -> "
          f"{fps:.1f} FPS ({evals * fps / 1e6:.1f} M field evals/s)", flush=True)
    served_psnr = psnr_of(frame.cpu().numpy().reshape(res, res, 3), gt_np)
    if args.out_dir:
        out_dir = Path(args.out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        np.save(out_dir / "nerf_pred.npy", pred_np)
        np.save(out_dir / "nerf_gt.npy", gt_np)
        print(f"wrote {out_dir}/nerf_pred.npy / nerf_gt.npy")
    return {
        "loss_curve": loss_curve,
        "psnr_db": psnr,
        "served_psnr_db": served_psnr,
        "ms_per_step": ms_per_step,
        "fps": fps,
        "evals_per_s": evals * fps,
        "n_params": model.model.n_params,
    }


if __name__ == "__main__":
    main()
