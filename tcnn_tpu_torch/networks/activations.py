"""Activation functions (port of ``tcnn_tpu.networks.activations``).

Forward formulas match the reference (common_device.h:110-230, K_ACT=10 at
:108). ``activation_backward`` gives the derivatives JAX autodiff takes of
the JAX package's forms, in fp32, with ReLU's taken as 0 at z == 0 as the
JAX fused backward does (tcnn_tpu/ops/ffmlp.py:_act_vjp). The fused MLP
kernels implement the same ten and their derivatives as device functions
(csrc/activations.cuh); the integer codes below are those kernels' argument.
"""

from __future__ import annotations

import torch

from ..common import K_ACT, Activation

# Kernel argument codes; csrc/activations.cuh switches on the same values.
ACTIVATION_CODES = {
    Activation.NONE: 0,
    Activation.ReLU: 1,
    Activation.LeakyReLU: 2,
    Activation.SiLU: 3,
    Activation.Exponential: 4,
    Activation.Sine: 5,
    Activation.Sigmoid: 6,
    Activation.Squareplus: 7,
    Activation.Softplus: 8,
    Activation.Tanh: 9,
}


def activation_fn(x: torch.Tensor, activation: Activation) -> torch.Tensor:
    if activation == Activation.NONE:
        return x
    if activation == Activation.ReLU:
        return torch.clamp_min(x, 0)
    if activation == Activation.LeakyReLU:
        return x * torch.where(x > 0, 1.0, 0.01).to(x.dtype)
    if activation == Activation.SiLU:
        return x * torch.sigmoid(x)
    if activation == Activation.Exponential:
        return torch.exp(x)
    if activation == Activation.Sine:
        return torch.sin(x)
    if activation == Activation.Sigmoid:
        return torch.sigmoid(x)
    if activation == Activation.Squareplus:
        xk = x * K_ACT
        return (0.5 * (xk + torch.sqrt(xk * xk + 4.0)) / K_ACT).to(x.dtype)
    if activation == Activation.Softplus:
        # log(exp(x*K)+1)/K, computed stably.
        xk = x.to(torch.float32) * K_ACT
        return (torch.logaddexp(xk, torch.zeros_like(xk)) / K_ACT).to(x.dtype)
    if activation == Activation.Tanh:
        return torch.tanh(x)
    raise ValueError(f"Unsupported activation: {activation}")


def activation_backward(g: torch.Tensor, z: torch.Tensor, activation: Activation) -> torch.Tensor:
    """dL/dz given ``g`` = dL/da where a = activation(z); fp32 in and out."""
    g = g.to(torch.float32)
    z = z.to(torch.float32)
    if activation == Activation.NONE:
        return g
    if activation == Activation.ReLU:
        return torch.where(z > 0, g, torch.zeros_like(g))
    if activation == Activation.LeakyReLU:
        return g * torch.where(z > 0, 1.0, 0.01).to(torch.float32)
    if activation == Activation.SiLU:
        s = torch.sigmoid(z)
        return g * s + (g * z) * (s * (1.0 - s))
    if activation == Activation.Exponential:
        return g * torch.exp(z)
    if activation == Activation.Sine:
        return g * torch.cos(z)
    if activation == Activation.Sigmoid:
        s = torch.sigmoid(z)
        return g * (s * (1.0 - s))
    if activation == Activation.Squareplus:
        xk = z * K_ACT
        return g * (0.5 * (1.0 + xk / torch.sqrt(xk * xk + 4.0)))
    if activation == Activation.Softplus:
        return g * torch.sigmoid(z * K_ACT)
    if activation == Activation.Tanh:
        t = torch.tanh(z)
        return g * (1.0 - t * t)
    raise ValueError(f"Unsupported activation: {activation}")
