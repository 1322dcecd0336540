"""Fused Adam step: the CUDA kernel's wrapper.

Replaces the Pallas kernel ``tcnn_tpu/ops/fused_adam.py:adam_step_fused``.
The kernel (``csrc/adam_step.cu``) applies tiny-cuda-nn's Adam to the flat
parameter vector in one pass and in place. Its plain version is
``optimizers.adam.AdamOptimizer._step_plain``; ``AdamOptimizer.step`` picks
between the two by the device of the parameters.
"""

from __future__ import annotations

import ctypes

import torch

# Launches of the CUDA kernel (incremented once per launch, nowhere else).
LAUNCHES = 0


class AdamHyperparams(ctypes.Structure):
    """Mirror of ``AdamHyperparams`` in ``csrc/adam_step.cu``."""

    _fields_ = [
        ("loss_scale", ctypes.c_float),
        ("beta1", ctypes.c_float),
        ("beta2", ctypes.c_float),
        ("epsilon", ctypes.c_float),
        ("one_minus_beta1", ctypes.c_float),
        ("one_minus_beta2", ctypes.c_float),
        ("lr_matrix", ctypes.c_float),
        ("lr_non_matrix", ctypes.c_float),
        ("l2_reg", ctypes.c_float),
        ("non_matrix_l2_reg", ctypes.c_float),
        ("relative_decay", ctypes.c_float),
        ("absolute_decay", ctypes.c_float),
        ("weight_clip", ctypes.c_float),
        ("gradient_clip", ctypes.c_float),
        ("adabound", ctypes.c_int32),
        ("optimize_matrix", ctypes.c_int32),
        ("optimize_non_matrix", ctypes.c_int32),
        ("skip_zero_grad", ctypes.c_int32),
        ("n", ctypes.c_int64),
        ("n_matrix", ctypes.c_int64),
    ]


def hyperparams_of(opt, n: int, n_matrix: int, loss_scale: float) -> AdamHyperparams:
    """The kernel's struct from an ``AdamOptimizer``. Differences such as
    ``1 - beta1`` are taken in double and then rounded to fp32, as the
    plain version's Python-scalar arithmetic does."""
    lr = float(opt.base_learning_rate)
    return AdamHyperparams(
        loss_scale=float(loss_scale),
        beta1=float(opt.beta1),
        beta2=float(opt.beta2),
        epsilon=float(opt.epsilon),
        one_minus_beta1=1.0 - float(opt.beta1),
        one_minus_beta2=1.0 - float(opt.beta2),
        lr_matrix=lr,
        lr_non_matrix=lr * float(opt.non_matrix_learning_rate_factor),
        l2_reg=float(opt.l2_reg),
        non_matrix_l2_reg=float(opt.non_matrix_l2_reg),
        relative_decay=float(opt.relative_weight_decay),
        absolute_decay=float(opt.absolute_weight_decay),
        weight_clip=float(opt.weight_clipping_magnitude),
        gradient_clip=float(opt.gradient_clipping_magnitude),
        adabound=int(bool(opt.adabound)),
        optimize_matrix=int(bool(opt.optimize_matrix_params)),
        optimize_non_matrix=int(bool(opt.optimize_non_matrix_params)),
        skip_zero_grad=int(bool(opt.skip_zero_grad_non_matrix_params)),
        n=int(n),
        n_matrix=int(n_matrix),
    )


def adam_step(
    params: torch.Tensor,
    grads: torch.Tensor,
    first_moments: torch.Tensor,
    second_moments: torch.Tensor,
    param_steps: torch.Tensor,
    step: torch.Tensor,
    hp: AdamHyperparams,
) -> None:
    """One Adam step on CUDA tensors, in place: ``params``, both moments and
    ``param_steps`` are updated where they lie. ``step`` is the 0-d int32
    global step count after this step's increment, on the device."""
    n = params.numel()
    for name, t, dtype in (
        ("params", params, torch.float32), ("grads", grads, torch.float32),
        ("first_moments", first_moments, torch.float32), ("second_moments", second_moments, torch.float32),
        ("param_steps", param_steps, torch.int32),
    ):
        if t.device.type != "cuda" or t.device != params.device or t.dtype != dtype:
            raise ValueError(f"adam_step: {name} must be a {dtype} tensor on the device of params")
        if t.shape != (n,) or not t.is_contiguous():
            raise ValueError(f"adam_step: {name} must be contiguous of shape ({n},), got {tuple(t.shape)}")
    if step.device != params.device or step.dtype != torch.int32 or step.numel() != 1:
        raise ValueError("adam_step: step must be a one-element int32 tensor on the device of params")
    if hp.n != n:
        raise ValueError(f"adam_step: hyperparameters are for {hp.n} parameters, got {n}")
    global LAUNCHES
    from ._build import kernel

    err = kernel("adam_step", "tcnn_adam_step", [ctypes.c_void_p] * 8)(
        params.data_ptr(), grads.data_ptr(), first_moments.data_ptr(), second_moments.data_ptr(),
        param_steps.data_ptr(), step.data_ptr(), ctypes.addressof(hp),
        torch.cuda.current_stream(params.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"adam_step: CUDA launch failed (cudaError {err})")
    LAUNCHES += 1
