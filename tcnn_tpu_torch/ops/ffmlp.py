"""Fully fused MLP forward and backward: the CUDA kernels' wrappers, their
plain versions and the autograd Function that binds them.

Replaces the Pallas kernels ``tcnn_tpu/ops/ffmlp.py:mlp_forward_pallas`` and
``mlp_backward_pallas`` (bound by the custom VJP ``ffmlp_apply``). The
forward kernel (``csrc/ffmlp_fwd.cu``) runs the whole MLP for a tile of rows
in one launch: weights staged once in shared memory, activations kept on
chip between layers. Numerics are those of the plain chain
``ffmlp_forward_plain``: bf16 operands, exact products, fp32 sums,
activation in fp32, then a round to bf16 before the next layer. The
backward kernel (``csrc/ffmlp_bwd.cu``) recomputes that forward and walks
the layers in reverse, as ``ffmlp_backward_plain`` writes out: bf16 deltas,
fp32 products, the weight gradient summed over the batch in fp32 and
rounded to bf16 once, the input gradient rounded to bf16.

``ffmlp_forward`` and ``ffmlp_backward`` dispatch on the device of ``x``: a
CPU tensor takes the plain version, a CUDA tensor launches the kernel or
raises. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from ..common import Activation
from ..networks.activations import ACTIVATION_CODES, activation_backward, activation_fn

# Launches of the CUDA kernels (each incremented once per launch of its
# wrapper's kernel, nowhere else): the forward and the backward.
LAUNCHES = 0
BWD_LAUNCHES = 0

FFMLP_WIDTHS = (16, 32, 64, 128)


def ffmlp_forward_plain(
    x: torch.Tensor,
    weights: Sequence[torch.Tensor],
    activation: Activation,
    output_activation: Activation,
) -> torch.Tensor:
    """The matmul chain. ``x`` (B, in) and each row-major ``weights[i]``
    (fan_out, fan_in) hold compute-dtype values; the products are taken in
    fp32 (exact for bf16 operands) so that the activation sees the fp32 sum
    before the one rounding per layer. A bf16 ``matmul`` would round before
    the activation instead, which differs for every activation except ReLU
    and None."""
    dt = x.dtype
    h = x
    n = len(weights)
    for i, w in enumerate(weights):
        z = h.to(torch.float32) @ w.to(torch.float32).T
        act = output_activation if i == n - 1 else activation
        h = activation_fn(z, act).to(dt)
    return h


def ffmlp_backward_plain(
    x: torch.Tensor,
    g: torch.Tensor,
    weights: Sequence[torch.Tensor],
    activation: Activation,
    output_activation: Activation,
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The backward of the chain with the JAX fused backward's rounding
    places (tcnn_tpu/ops/ffmlp.py:_mlp_bwd_kernel and _ffmlp_bwd): the
    forward recomputed with fp32 pre-activations z; delta = act'(z) * g in
    fp32; per layer in reverse d16 = round(delta), dW = d16^T h summed over
    the batch in fp32 and rounded once, dh = d16 W in fp32; dx = round(dh).
    Not autograd of the chain, whose rounding places differ. Returns (dx,
    [dW...]) in the dtype of ``x``, each dW shaped like its weight."""
    dt = x.dtype
    n = len(weights)
    hs = [x]
    zs = []
    h = x
    for i, w in enumerate(weights):
        z = h.to(torch.float32) @ w.to(torch.float32).T
        zs.append(z)
        if i < n - 1:
            h = activation_fn(z, activation).to(dt)
            hs.append(h)
    delta = activation_backward(g.to(torch.float32), zs[-1], output_activation)
    dws: List[torch.Tensor] = [None] * n
    for i in range(n - 1, -1, -1):
        d16 = delta.to(dt).to(torch.float32)
        dws[i] = (d16.T @ hs[i].to(torch.float32)).to(dt)
        dh = d16 @ weights[i].to(torch.float32)
        if i > 0:
            delta = activation_backward(dh, zs[i - 1], activation)
    return dh.to(dt), dws


def _lib(name: str, symbol: str, argtypes):
    from ._build import load_library

    lib = load_library(name)
    if not getattr(lib, "_tcnn_bound", False):
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib._tcnn_bound = True
    return lib


def _check_shapes(in_width: int, shapes: Sequence[Tuple[int, int]]) -> Tuple[int, int, int]:
    """(width, n_hidden_layers, out_width) of a layer-shape list the kernel
    takes, or ValueError."""
    if not shapes:
        raise ValueError("ffmlp_forward: no layers")
    if shapes[0][1] != in_width:
        raise ValueError(f"ffmlp_forward: first layer takes {shapes[0][1]} inputs, x has {in_width}")
    out_width = shapes[-1][0]
    n_hidden = len(shapes) - 1
    width = shapes[0][0] if n_hidden else out_width
    for i, (rows, cols) in enumerate(shapes):
        want_cols = in_width if i == 0 else width
        want_rows = out_width if i == n_hidden else width
        if (rows, cols) != (want_rows, want_cols):
            raise ValueError(f"ffmlp_forward: layer {i} has shape {(rows, cols)}, expected {(want_rows, want_cols)}")
    if n_hidden and width not in FFMLP_WIDTHS:
        raise ValueError(f"ffmlp_forward: width {width} not in {FFMLP_WIDTHS}")
    if in_width % 16 or out_width % 16:
        raise ValueError(f"ffmlp_forward: input {in_width} and output {out_width} widths must be multiples of 16")
    return width, n_hidden, out_width


_FWD_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def _kernel_operands(what: str, x: torch.Tensor, weights: Sequence[torch.Tensor]):
    """Checks what the kernels take; returns (width, n_hidden, out_width,
    flat weights). The weights go as one contiguous buffer in flat-parameter
    order, which the kernels stage into shared memory with one copy loop."""
    if x.dim() != 2 or x.dtype != torch.bfloat16 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{what}: x must be a contiguous, 16-byte aligned 2-D bfloat16 tensor")
    width, n_hidden, out_width = _check_shapes(x.shape[1], [tuple(w.shape) for w in weights])
    for w in weights:
        if w.device != x.device or w.dtype != torch.bfloat16:
            raise ValueError(f"{what}: weights must be bfloat16 on the device of x")
    flat = torch.cat([w.reshape(-1) for w in weights]).contiguous()
    return width, n_hidden, out_width, flat


def ffmlp_forward(
    x: torch.Tensor,
    weights: Sequence[torch.Tensor],
    activation: Activation,
    output_activation: Activation,
) -> torch.Tensor:
    """Fused MLP forward. ``x``: (B, in) bf16; ``weights``: row-major bf16
    matrices [(w, in), (w, w)..., (out_p, w)] (or one (out_p, in) matrix for
    zero hidden layers). Returns (B, out_p) bf16."""
    if x.device.type == "cpu":
        return ffmlp_forward_plain(x, weights, activation, output_activation)
    if x.device.type != "cuda":
        raise ValueError(f"ffmlp_forward: unsupported device {x.device}")
    width, n_hidden, out_width, flat = _kernel_operands("ffmlp_forward", x, weights)
    batch = x.shape[0]
    out = torch.empty((batch, out_width), dtype=torch.bfloat16, device=x.device)
    if batch == 0:
        return out
    global LAUNCHES
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib("ffmlp_fwd", "tcnn_ffmlp_forward", _FWD_ARGS).tcnn_ffmlp_forward(
        x.data_ptr(), flat.data_ptr(), out.data_ptr(),
        batch, x.shape[1], width, n_hidden, out_width,
        ACTIVATION_CODES[activation], ACTIVATION_CODES[output_activation],
        stream,
    )
    if err != 0:
        raise RuntimeError(f"ffmlp_forward: CUDA launch failed (cudaError {err})")
    LAUNCHES += 1
    return out


def ffmlp_backward(
    x: torch.Tensor,
    g: torch.Tensor,
    weights: Sequence[torch.Tensor],
    activation: Activation,
    output_activation: Activation,
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Fused MLP backward. ``x`` (B, in) and the output gradient ``g`` (B,
    out_p) bf16, ``weights`` as for ``ffmlp_forward``. Returns (dx (B, in),
    [dW...]) bf16, each dW shaped like its weight."""
    if x.device.type == "cpu":
        return ffmlp_backward_plain(x, g, weights, activation, output_activation)
    if x.device.type != "cuda":
        raise ValueError(f"ffmlp_backward: unsupported device {x.device}")
    width, n_hidden, out_width, flat = _kernel_operands("ffmlp_backward", x, weights)
    batch = x.shape[0]
    if (
        g.shape != (batch, out_width) or g.dtype != torch.bfloat16 or g.device != x.device
        or not g.is_contiguous()
    ):
        raise ValueError(f"ffmlp_backward: g must be a contiguous ({batch}, {out_width}) bfloat16 tensor on the device of x")
    dx = torch.empty_like(x)
    dw32 = torch.empty(flat.numel(), dtype=torch.float32, device=x.device)
    dw16 = torch.empty_like(flat)
    global BWD_LAUNCHES
    err = _lib("ffmlp_bwd", "tcnn_ffmlp_backward", _BWD_ARGS).tcnn_ffmlp_backward(
        x.data_ptr(), g.data_ptr(), flat.data_ptr(), dx.data_ptr(), dw32.data_ptr(), dw16.data_ptr(),
        batch, x.shape[1], width, n_hidden, out_width,
        ACTIVATION_CODES[activation], ACTIVATION_CODES[output_activation],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"ffmlp_backward: CUDA launch failed (cudaError {err})")
    BWD_LAUNCHES += 1
    sizes = [w.numel() for w in weights]
    return dx, [d.view(w.shape) for d, w in zip(dw16.split(sizes), weights)]


class FfmlpFunction(torch.autograd.Function):
    """Differentiable fused MLP (first order): the forward is
    ``ffmlp_forward``, the backward ``ffmlp_backward``, or with ``plain``
    their plain versions on any device. The counterpart of the JAX
    package's ``ffmlp_apply``; its residuals are x and the weights, the
    backward recomputes the activations.

    ``FfmlpFunction.apply(x, activation, output_activation, plain, *weights)``
    """

    @staticmethod
    def forward(ctx, x, activation, output_activation, plain, *weights):
        ctx.acts = (activation, output_activation)
        ctx.plain = bool(plain)
        ctx.save_for_backward(x, *weights)
        fwd = ffmlp_forward_plain if plain else ffmlp_forward
        return fwd(x, list(weights), activation, output_activation)

    @staticmethod
    def backward(ctx, g):
        if torch.is_grad_enabled():
            raise NotImplementedError(
                "FfmlpFunction: the fused MLP has no double backward yet "
                "(ROADMAP.md, Queue 1 item 4: module API and second order)"
            )
        x, *weights = ctx.saved_tensors
        bwd = ffmlp_backward_plain if ctx.plain else ffmlp_backward
        dx, dws = bwd(x, g.to(x.dtype).contiguous(), weights, *ctx.acts)
        return (dx, None, None, None, *dws)
