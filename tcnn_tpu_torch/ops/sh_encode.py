"""Spherical-harmonics encoding: the CUDA kernels' wrappers, their plain
versions and the autograd Function that binds them.

The kernels (``csrc/sh_encode.cu``) replace the XLA computation of the JAX
package's ``SphericalHarmonicsEncoding.apply``
(tcnn_tpu/encodings/spherical_harmonics.py:106) and its autodiff, as the
reference computes the basis in one kernel (encodings/spherical_harmonics.h).
``tcnn_sh_forward`` writes the padding columns and then the degree^2 values
of each sample, in bf16 or fp32; ``tcnn_sh_backward_input`` carries the
three partial derivatives through the same recurrences and contracts them
with dL/dy; ``tcnn_sh_backward_backward`` is that gradient's own vjp (the
second order of a loss on dL/dx), from the closed-form second partials.
The first two have two routes, one C entry point each, picked by the pure
function ``route``: "vector", where a row is a whole number of 16-byte
vectors (at most 24) and the row-vector tensor (the forward's output, the
backward's dL/dy) is 16-byte aligned (a warp's rows written or read as
16-byte vectors, with no block barrier: the NeRF path's degree 3 with 7
padding columns in bf16), and "staged" for every other width (a block's
rows staged in shared memory behind a barrier). ``ROUTE_LAUNCHES`` counts
the launches by (kernel, route). The plain version ``sh_encode_plain``
evaluates ``sh_enc``, the JAX package's recurrences in the same order, in
torch; the input gradient's plain version is its autograd, and the double
backward's (``sh_backward_backward_plain``) autograd of that.

Every wrapper dispatches on the device of ``x``: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, Tuple

import torch

from .grid_encode import _autograd_of

# Launches of the CUDA kernels (each incremented once per launch of its
# wrapper's kernel, nowhere else): the forward and the input gradient.
LAUNCHES = 0
BWD_LAUNCHES = 0
# Launches of the double backward's kernel, and the plain double backwards
# run on a CUDA tensor (the kernel's comparisons and every order past the
# second run them; a path whose second order is the kernel's runs none).
BWDBWD_LAUNCHES = 0
PLAIN_BWDBWD_ON_CARD = 0
# The same launches by (kernel, route): ("forward" | "backward", "vector" |
# "staged"), the route ``route`` picked.
ROUTE_LAUNCHES: Dict[Tuple[str, str], int] = {}

# The C entry point of each (kernel, route).
SYMBOLS = {
    ("forward", "vector"): "tcnn_sh_forward_vector",
    ("forward", "staged"): "tcnn_sh_forward",
    ("backward", "vector"): "tcnn_sh_backward_input_vector",
    ("backward", "staged"): "tcnn_sh_backward_input",
}
BWDBWD_SYMBOL = "tcnn_sh_backward_backward"
VECTOR_BYTES = 16
# The vector route's widest row (csrc/sh_encode.cu:kMaxRowVectors vectors):
# its forward stages 128 rows in at most 48 KB of shared memory.
VECTOR_MAX_ROW_BYTES = 24 * VECTOR_BYTES

MAX_DEGREE = 8

_FWD_ARGS = [
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
]
_BWD_ARGS = [
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]
_BWDBWD_ARGS = [
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p,
]


def k_lm(l: int, m: int) -> float:
    """The normalisation sqrt((2l+1) (l-|m|)! / (4 pi (l+|m|)!))."""
    m = abs(m)
    return math.sqrt((2 * l + 1) * math.factorial(l - m) / (4 * math.pi * math.factorial(l + m)))


def sh_enc(degree: int, x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> List[torch.Tensor]:
    """The real SH basis functions 0..degree^2-1 at (x, y, z), level-major
    with m = -l..l: the JAX package's ``sh_enc``
    (tcnn_tpu/encodings/spherical_harmonics.py:42-88), the same recurrences
    in the same order, with the Condon-Shortley sign folded into
    q_m^m = (-1)^m (2m-1)!!. Differentiable to any order."""
    if degree < 1 or degree > MAX_DEGREE:
        raise ValueError(f"SH degree must be in [1, {MAX_DEGREE}]")
    one = torch.ones_like(x)
    # A_m = Re((x + iy)^m), B_m = Im((x + iy)^m)
    a = [one]
    b = [torch.zeros_like(x)]
    for m in range(1, degree):
        a.append(x * a[m - 1] - y * b[m - 1])
        b.append(x * b[m - 1] + y * a[m - 1])
    # q[l][m] = P_l^m(z) / sin^m(theta), a polynomial in z.
    q = [[None] * degree for _ in range(degree)]
    dfact = 1.0  # (2m-1)!!
    for m in range(degree):
        sign = -1.0 if m % 2 else 1.0
        q[m][m] = sign * dfact * one
        if m + 1 < degree:
            q[m + 1][m] = (2 * m + 1) * z * q[m][m]
        for l in range(m + 2, degree):
            q[l][m] = ((2 * l - 1) * z * q[l - 1][m] - (l + m - 1) * q[l - 2][m]) / (l - m)
        dfact *= 2 * m + 1
    out = []
    for l in range(degree):
        for m in range(-l, l + 1):
            am = abs(m)
            k = k_lm(l, am)
            if m == 0:
                out.append(k * q[l][0])
            elif m > 0:
                out.append(math.sqrt(2.0) * k * q[l][am] * a[am])
            else:
                out.append(math.sqrt(2.0) * k * q[l][am] * b[am])
    return out


def sh_encode_plain(x: torch.Tensor, degree: int, n_to_pad: int, pad_value: float = 1.0,
                    out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(B, n_to_pad + degree^2): the padding, then the SH values of ``x``
    (B, 3) in [0, 1]^3 remapped to [-1, 1]^3, cast to ``out_dtype``."""
    x = x.to(torch.float32)
    vals = sh_enc(degree, x[:, 0] * 2.0 - 1.0, x[:, 1] * 2.0 - 1.0, x[:, 2] * 2.0 - 1.0)
    y = torch.stack(vals, dim=1)
    if n_to_pad > 0:
        y = torch.cat([torch.full((y.shape[0], n_to_pad), pad_value, dtype=y.dtype, device=y.device), y], dim=1)
    return y.to(out_dtype)


def _plain_vjp(x: torch.Tensor, dy: torch.Tensor, degree: int, n_to_pad: int, create_graph: bool) -> torch.Tensor:
    """dL/dx by autograd of the fp32 plain version at ``x`` (which must
    require grad); zeros where the output does not depend on x (degree 1)."""
    with torch.enable_grad():
        y = sh_encode_plain(x, degree, n_to_pad, 1.0, torch.float32)
    if not y.requires_grad:
        return torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    (dx,) = torch.autograd.grad(y, x, dy.to(torch.float32), create_graph=create_graph)
    return dx


def sh_backward_input_plain(x: torch.Tensor, dy: torch.Tensor, degree: int, n_to_pad: int) -> torch.Tensor:
    """dL/dx (B, 3) fp32 from dL/dy (B, n_to_pad + degree^2): autograd of
    the fp32 plain version."""
    xx = x.detach().to(torch.float32).requires_grad_(True)
    return _plain_vjp(xx, dy, degree, n_to_pad, create_graph=False)


def _operand(t: torch.Tensor, create: bool) -> torch.Tensor:
    """A saved input as a vjp takes it: as it is where it is part of the
    graph under grad mode (the result then differentiates further), else
    detached; fp32, requiring grad."""
    if create and t.requires_grad:
        return t.to(torch.float32)
    return t.detach().to(torch.float32).requires_grad_(True)


def sh_backward_backward_plain(x: torch.Tensor, dy: torch.Tensor, c: torch.Tensor, degree: int, n_to_pad: int,
                               need_x: bool = True, need_dy: bool = True):
    """The vjp of dL/dx (``sh_backward_input``) at (x, dL/dy) with the
    cotangent ``c`` (B, 3) of dL/dx: (d/dx (B, 3), d/d(dL/dy) (B, n_to_pad +
    degree^2)), fp32, each None where ``need_x`` / ``need_dy`` does not ask
    for it and zeros where it vanishes; autograd of the plain vjp, built
    with ``create_graph`` under grad mode where an input requires grad, so
    that it differentiates further with respect to x, dL/dy and c."""
    global PLAIN_BWDBWD_ON_CARD
    if x.device.type == "cuda":
        PLAIN_BWDBWD_ON_CARD += 1
    create = torch.is_grad_enabled() and any(t.requires_grad for t in (x, dy, c))
    with torch.enable_grad():
        xx, dyy = _operand(x, create), _operand(dy, create)
        dx = _plain_vjp(xx, dyy, degree, n_to_pad, create_graph=True)
        targets = [t for t, w in ((xx, need_x), (dyy, need_dy)) if w]
        got = iter(torch.autograd.grad(dx, targets, c.to(torch.float32), allow_unused=True, create_graph=create)
                   if dx.requires_grad and targets else [])
    d_x = next(got, None) if need_x else None
    d_dy = next(got, None) if need_dy else None
    if need_x and d_x is None:  # degrees 1-2: dL/dx does not depend on x
        d_x = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    if need_dy and d_dy is None:  # degree 1: dL/dx is 0 whatever dL/dy
        d_dy = torch.zeros(dy.shape, dtype=torch.float32, device=dy.device)
    return d_x, d_dy


def _check_x(what: str, x: torch.Tensor) -> torch.Tensor:
    """``x`` as the kernels read it: fp32, 3 columns of unit stride, rows
    at any stride."""
    if x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"{what}: x must be (B, 3), got {tuple(x.shape)}")
    x = x.to(torch.float32)
    if x.stride(1) != 1 or x.stride(0) < 3:
        x = x.contiguous()
    return x


def route(degree: int, n_to_pad: int, itemsize: int, address: int) -> str:
    """The route of a call whose row-vector tensor (the forward's output,
    the backward's dL/dy) holds rows of ``n_to_pad + degree^2`` elements of
    ``itemsize`` bytes from ``address``: "vector" where a row is a whole
    number of 16-byte vectors, at most ``VECTOR_MAX_ROW_BYTES``, and the
    tensor starts on a 16-byte boundary, else "staged"."""
    row_bytes = (int(n_to_pad) + int(degree) ** 2) * int(itemsize)
    whole = row_bytes % VECTOR_BYTES == 0 and row_bytes <= VECTOR_MAX_ROW_BYTES
    return "vector" if whole and int(address) % VECTOR_BYTES == 0 else "staged"


def _count(kernel: str, which: str) -> None:
    ROUTE_LAUNCHES[(kernel, which)] = ROUTE_LAUNCHES.get((kernel, which), 0) + 1


def _check_shape(what: str, degree: int, n_to_pad: int):
    if not 1 <= int(degree) <= MAX_DEGREE or int(n_to_pad) < 0:
        raise ValueError(f"{what}: degree must be in [1, {MAX_DEGREE}] and n_to_pad >= 0")


def _launch(what: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError {err})")


def sh_encode(x: torch.Tensor, degree: int, n_to_pad: int, pad_value: float = 1.0,
              out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The SH encoding of ``x`` (B, 3): on a CUDA ``x`` the kernel
    ``tcnn_sh_forward`` writes (B, n_to_pad + degree^2) in bf16 or fp32
    (another ``out_dtype`` is cast from its fp32 output), on the route
    ``route`` picks; on the CPU the plain version."""
    if x.device.type == "cpu":
        return sh_encode_plain(x, degree, n_to_pad, pad_value, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"sh_encode: unsupported device {x.device}")
    _check_shape("sh_encode", degree, n_to_pad)
    x = _check_x("sh_encode", x)
    kernel_dtype = out_dtype if out_dtype in (torch.bfloat16, torch.float32) else torch.float32
    width = int(n_to_pad) + int(degree) ** 2
    out = torch.empty((x.shape[0], width), dtype=kernel_dtype, device=x.device)
    if x.shape[0]:
        from ._build import kernel, stream

        which = route(degree, n_to_pad, out.element_size(), out.data_ptr())
        _launch("sh_encode", kernel("sh_encode", SYMBOLS[("forward", which)], _FWD_ARGS)(
            x.data_ptr(), x.stride(0), out.data_ptr(), x.shape[0], int(degree), int(n_to_pad), width,
            float(pad_value), int(kernel_dtype == torch.bfloat16), stream(x.get_device()),
        ))
        global LAUNCHES
        LAUNCHES += 1
        _count("forward", which)
    return out.to(out_dtype)


def sh_backward_input(x: torch.Tensor, dy: torch.Tensor, degree: int, n_to_pad: int) -> torch.Tensor:
    """dL/dx (B, 3) fp32 from dL/dy (B, n_to_pad + degree^2): on a CUDA
    ``x`` the kernel ``tcnn_sh_backward_input`` (dL/dy bf16 or fp32; another
    dtype is cast to fp32, a non-contiguous one made contiguous), on the
    route ``route`` picks for dL/dy; on the CPU the plain version."""
    if x.device.type == "cpu":
        return sh_backward_input_plain(x, dy, degree, n_to_pad)
    if x.device.type != "cuda":
        raise ValueError(f"sh_backward_input: unsupported device {x.device}")
    _check_shape("sh_backward_input", degree, n_to_pad)
    x = _check_x("sh_backward_input", x)
    width = int(n_to_pad) + int(degree) ** 2
    if dy.shape != (x.shape[0], width) or dy.device != x.device:
        raise ValueError(f"sh_backward_input: dL/dy must be ({x.shape[0]}, {width}) on the device of x")
    if dy.dtype not in (torch.bfloat16, torch.float32):
        dy = dy.to(torch.float32)
    dy = dy.contiguous()
    dx = torch.empty((x.shape[0], 3), dtype=torch.float32, device=x.device)
    if x.shape[0]:
        from ._build import kernel, stream

        which = route(degree, n_to_pad, dy.element_size(), dy.data_ptr())
        _launch("sh_backward_input", kernel("sh_encode", SYMBOLS[("backward", which)], _BWD_ARGS)(
            x.data_ptr(), x.stride(0), dy.data_ptr(), int(dy.dtype == torch.bfloat16), dx.data_ptr(), x.shape[0],
            int(degree), int(n_to_pad), width, stream(x.get_device()),
        ))
        global BWD_LAUNCHES
        BWD_LAUNCHES += 1
        _count("backward", which)
    return dx


def sh_backward_backward(x: torch.Tensor, dy: torch.Tensor, c: torch.Tensor, degree: int, n_to_pad: int,
                         need_x: bool = True, need_dy: bool = True):
    """The vjp of dL/dx at (x, dL/dy) with the cotangent ``c`` (B, 3) of
    dL/dx: (d/dx (B, 3) fp32, d/d(dL/dy) in dL/dy's dtype, zeros in the
    padding columns), each None where ``need_x`` / ``need_dy`` does not ask
    for it. On a CUDA ``x`` the kernel ``tcnn_sh_backward_backward`` (dL/dy
    bf16 or fp32, another dtype cast to fp32; x, dL/dy and c read at any row
    stride); on the CPU the plain version."""
    if x.device.type == "cpu":
        d_x, d_dy = sh_backward_backward_plain(x, dy, c, degree, n_to_pad, need_x, need_dy)
        return d_x, None if d_dy is None else d_dy.to(dy.dtype)
    if x.device.type != "cuda":
        raise ValueError(f"sh_backward_backward: unsupported device {x.device}")
    _check_shape("sh_backward_backward", degree, n_to_pad)
    x = _check_x("sh_backward_backward", x)
    batch, width = x.shape[0], int(n_to_pad) + int(degree) ** 2
    if dy.shape != (batch, width) or c.shape != (batch, 3) or dy.device != x.device or c.device != x.device:
        raise ValueError(f"sh_backward_backward: dL/dy must be ({batch}, {width}) and c ({batch}, 3) on the device "
                         f"of x")
    if dy.dtype not in (torch.bfloat16, torch.float32):
        dy = dy.to(torch.float32)
    if dy.stride(1) != 1 or dy.stride(0) < width:
        dy = dy.contiguous()
    c = c.to(torch.float32)
    if c.stride(1) != 1 or c.stride(0) < 3:
        c = c.contiguous()
    d_x = torch.empty((batch, 3), dtype=torch.float32, device=x.device) if need_x else None
    d_dy = torch.empty((batch, width), dtype=dy.dtype, device=x.device) if need_dy else None
    if batch and (need_x or need_dy):
        from ._build import kernel, stream

        _launch("sh_backward_backward", kernel("sh_encode", BWDBWD_SYMBOL, _BWDBWD_ARGS)(
            x.data_ptr(), x.stride(0), dy.data_ptr(), dy.stride(0), int(dy.dtype == torch.bfloat16), c.data_ptr(),
            c.stride(0), d_x.data_ptr() if need_x else None, d_dy.data_ptr() if need_dy else None, batch,
            int(degree), int(n_to_pad), width, int(bool(need_x)), int(bool(need_dy)), stream(x.get_device()),
        ))
        global BWDBWD_LAUNCHES
        BWDBWD_LAUNCHES += 1
    return d_x, d_dy


class ShEncodeFunction(torch.autograd.Function):
    """The SH encoding, differentiable with respect to the positions: the
    forward is ``sh_encode``, the backward ``ShBackwardFunction`` (the
    kernel ``sh_backward_input``), or with ``plain`` their plain versions on
    any device.

    ``ShEncodeFunction.apply(x, degree, n_to_pad, pad_value, out_dtype, plain)``
    """

    @staticmethod
    def forward(ctx, x, degree, n_to_pad, pad_value, out_dtype, plain):
        ctx.meta = (int(degree), int(n_to_pad), bool(plain))
        ctx.save_for_backward(x)
        fwd = sh_encode_plain if plain else sh_encode
        return fwd(x, degree, n_to_pad, pad_value, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return (None,) * 6
        dx = ShBackwardFunction.apply(x, dy, *ctx.meta)
        return dx.to(x.dtype), None, None, None, None, None


class ShBackwardFunction(torch.autograd.Function):
    """The encoding's first backward as a differentiable function of (x,
    dL/dy): its forward is ``sh_backward_input`` (or its plain version with
    ``plain``), so the first-order dL/dx always comes from the kernel on the
    card; its backward, needed only when a gradient is itself
    differentiated, is ``ShBackwardBackwardFunction``: the double-backward
    kernel on the card, and every further order autograd of the plain
    version (the JAX package's ``SphericalHarmonicsEncoding.apply`` is jnp,
    which ``jax.grad`` differentiates to any order).

    ``ShBackwardFunction.apply(x, dy, degree, n_to_pad, plain)``
    """

    @staticmethod
    def forward(ctx, x, dy, degree, n_to_pad, plain):
        ctx.meta = (degree, n_to_pad, plain)
        ctx.save_for_backward(x, dy)
        bwd = sh_backward_input_plain if plain else sh_backward_input
        return bwd(x, dy, degree, n_to_pad)

    @staticmethod
    def backward(ctx, ddx):
        x, dy = ctx.saved_tensors
        need_x, need_dy = ctx.needs_input_grad[:2]
        if not (need_x or need_dy):
            return None, None, None, None, None
        d_x, d_dy = ShBackwardBackwardFunction.apply(x, dy, ddx, *ctx.meta, need_x, need_dy)
        return (
            None if d_x is None else d_x.to(x.dtype),
            None if d_dy is None else d_dy.to(dy.dtype),
            None, None, None,
        )


class ShBackwardBackwardFunction(torch.autograd.Function):
    """The input gradient's vjp as a differentiable function of (x, dL/dy,
    c): its forward is ``sh_backward_backward`` (the kernel on the card, or
    with ``plain`` its plain version on any device); its backward, the third
    order and every order after it, autograd of the plain version
    recomputed from the saved inputs, as ``GridEncodeThirdOrderFunction``
    takes the grid's fourth.

    ``ShBackwardBackwardFunction.apply(x, dy, c, degree, n_to_pad, plain,
    need_x, need_dy)`` -> (d/dx or None, d/d(dL/dy) or None)
    """

    @staticmethod
    def forward(ctx, x, dy, c, degree, n_to_pad, plain, need_x, need_dy):
        ctx.meta = (degree, n_to_pad, need_x, need_dy)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dy, c)
        fn = sh_backward_backward_plain if plain else sh_backward_backward
        return fn(x, dy, c, degree, n_to_pad, need_x, need_dy)

    @staticmethod
    def backward(ctx, g_x, g_dy):
        x, dy, c = ctx.saved_tensors
        if g_x is None and g_dy is None:
            return (None,) * 8
        degree, n_to_pad, need_x, need_dy = ctx.meta

        def fn(xx, yy, cc):
            return sh_backward_backward_plain(xx, yy, cc, degree, n_to_pad, need_x, need_dy)

        d = _autograd_of(fn, (x, dy, c), ctx.needs_input_grad[:3], (g_x, g_dy))
        return d[0], d[1], d[2], None, None, None, None, None
