"""SDF-learning sample: fit a signed distance field with an eikonal prior
(the port of the JAX package's ``samples/sdf_learning.py``; reference:
grid.h:910-1042 ``backward_backward_input``).

Learns f(x) ~ sdf(x) for an analytic target (a sphere and a torus) over
[0, 1]^3 from sampled distances, regularised by the eikonal residual
(|grad f| - 1)^2: a second-order objective, since training differentiates
through grad_x f. On the card the step runs the grid lookup (d = 3,
Smoothstep), its input gradient and double backward, the table gradient and
the Adam kernel; CutlassMLP is the plain matmul chain.

The step drives the trainer's optimizer directly, as an advanced user
would: the parameter gradient of the total loss, then
``trainer.optimizer.step`` at loss scale 1, its results written into the
trainer's own tensors.

Usage:
    python -m tcnn_tpu_torch.samples.sdf_learning [n_steps] [batch]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import torch

from ..benchmarks import bench_device
from ..config import create_from_config

CONFIG = {
    "loss": {"otype": "L2"},  # distance supervision term (manual total loss)
    "optimizer": {
        "otype": "Adam",
        "learning_rate": 1e-3,
        "beta1": 0.9,
        "beta2": 0.99,
        "epsilon": 1e-15,
    },
    "encoding": {
        "otype": "HashGrid",
        "n_levels": 8,
        "n_features_per_level": 2,
        "log2_hashmap_size": 15,
        "base_resolution": 8,
        "per_level_scale": 1.6,
        # Smoothstep makes the interpolant C1 — a continuous spatial
        # gradient for the eikonal term (the reference ships the same knob
        # for the same reason, grid.h InterpolationType::Smoothstep).
        "interpolation": "Smoothstep",
        "hash": "CoherentAdditive",
        "gather_strategy": "quad",
    },
    "network": {
        "otype": "CutlassMLP",
        "activation": "ReLU",
        "output_activation": "None",
        "n_neurons": 64,
        "n_hidden_layers": 2,
    },
}

EIKONAL_WEIGHT = 0.01
N_VALIDATION = 4096


def target_sdf(x: torch.Tensor) -> torch.Tensor:
    """Union of a sphere and a torus, both well inside [0,1]^3."""
    p = x - 0.5
    sphere = torch.linalg.vector_norm(p - p.new_tensor([0.15, 0.0, 0.0]), dim=-1) - 0.18
    q = p + p.new_tensor([0.15, 0.0, 0.0])
    ring = torch.sqrt(q[..., 0] ** 2 + q[..., 1] ** 2) - 0.2
    torus = torch.sqrt(ring**2 + q[..., 2] ** 2) - 0.07
    return torch.minimum(sphere, torus)


def total_loss(net, params, x, d_true, plain: bool = False, eikonal_weight: float = EIKONAL_WEIGHT):
    """``(loss, (data, eik))``: the distance L2 plus ``eikonal_weight`` times
    the mean eikonal residual, differentiable with respect to ``params``.
    ``plain`` runs every kernel's plain version."""
    apply = net.apply_plain if plain else net.apply
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        d_pred = apply(params, x)[:, 0].to(torch.float32)
        data = torch.mean((d_pred - d_true) ** 2)
        # The JAX sample takes jax.vmap(jax.grad(f_scalar)) sample by
        # sample; each row's output depends on that row's input alone, so
        # one vector-Jacobian product with a ones cotangent gives every
        # row's spatial gradient at once.
        (grads,) = torch.autograd.grad(d_pred, x, torch.ones_like(d_pred), create_graph=True)
        eik = torch.mean((torch.linalg.vector_norm(grads, dim=-1) - 1.0) ** 2)
        return data + eikonal_weight * eik, (data, eik)


def train_step(model, x, d_true, plain: bool = False, eikonal_weight: float = EIKONAL_WEIGHT):
    """One step of the sample on the points ``x``: the parameter gradient
    of ``total_loss``, then the trainer's optimizer at loss scale 1 (the
    functional ``optimizer.step``, its results written into the trainer's
    tensors). Returns ``(loss, data, eik)`` as 0-d device tensors."""
    params = model.model.params
    loss, (data, eik) = total_loss(model.model, params, x, d_true, plain, eikonal_weight)
    (grads,) = torch.autograd.grad(loss, params)
    model.trainer._optimizer_step(grads, plain, loss_scale=1.0)
    return loss.detach(), data.detach(), eik.detach()


def draw(batch: int, gen: torch.Generator):
    """``batch`` uniform points of [0, 1)^3 drawn on the generator's device
    and their target distances."""
    x = torch.rand((batch, 3), generator=gen, device=gen.device)
    return x, target_sdf(x)


def fit(n_steps: int = 200, batch: int = 8192, eikonal_weight: float = EIKONAL_WEIGHT, seed: int = 0,
        log_every: int = 50, device="cuda"):
    """Train ``create_from_config(3, 1, CONFIG)`` for ``n_steps`` on fresh
    points each step; returns the validation ``(sdf-l2, eikonal residual,
    history)`` as the JAX sample's ``fit`` does, ``history`` the losses of
    the logged steps."""
    dev = bench_device(device)
    model = create_from_config(3, 1, CONFIG, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    history = []
    t0 = time.time()
    for i in range(n_steps):
        loss, data, eik = train_step(model, *draw(batch, gen), eikonal_weight=eikonal_weight)
        if (i + 1) % log_every == 0 or i == 0:
            loss_f = float(loss)
            history.append(loss_f)
            print(f"step {i + 1:5d}  loss {loss_f:.5f}  sdf-l2 {float(data):.5f}  eikonal {float(eik):.5f}",
                  flush=True)
    dt = time.time() - t0

    # Validation: the distance L2 on fresh points + the eikonal residual.
    xv, dv = draw(N_VALIDATION, torch.Generator(device=dev).manual_seed(seed + 1))
    _, (data_v, eik_v) = total_loss(model.model, model.model.params.detach(), xv, dv,
                                    eikonal_weight=eikonal_weight)
    data_v, eik_v = float(data_v.detach()), float(eik_v.detach())
    print(f"done in {dt:.1f}s: validation sdf-l2 {data_v:.6f}, eikonal residual {eik_v:.5f}", flush=True)
    return data_v, eik_v, history


def main(argv=None):
    ap = argparse.ArgumentParser(description="Fit a signed distance field with an eikonal prior.")
    ap.add_argument("n_steps", nargs="?", type=int, default=200)
    ap.add_argument("batch", nargs="?", type=int, default=8192)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return fit(n_steps=args.n_steps, batch=args.batch, device=args.device)


if __name__ == "__main__":
    main()
