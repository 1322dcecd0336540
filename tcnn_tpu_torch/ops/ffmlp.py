"""Fully fused MLP forward and backward: the CUDA kernels' wrappers, their
plain versions and the autograd Function that binds them.

Replaces the Pallas kernels ``tcnn_tpu/ops/ffmlp.py:mlp_forward_pallas`` and
``mlp_backward_pallas`` (bound by the custom VJP ``ffmlp_apply``). The
forward kernel (``csrc/ffmlp_fwd.cu``) runs the whole MLP for a tile of rows
in one launch: weights staged once in shared memory, activations kept on
chip between layers. Numerics are those of the plain chain
``ffmlp_forward_plain``: bf16 operands, exact products, fp32 sums,
activation in fp32, then a round to bf16 before the next layer. The
backward (``csrc/ffmlp_bwd.cu``) computes what ``ffmlp_backward_plain``
writes out: bf16 deltas, fp32 products, the weight gradient summed over the
batch in fp32 and rounded to bf16 once, the input gradient rounded to bf16.
It is two launches: a walk kernel that recomputes the forward, walks the
layers in reverse and writes dx and every layer's delta D_l and input H_l
to scratch (``ffmlp_backward_walk_plain``), then a split-K tensor-core
product dW_l = D_l^T H_l with a fixed-order reduce of its partials
(``ffmlp_weight_grad_plain``), so the same inputs give the same bits.

The packed-I/O pair ``ffmlp_forward_packed`` / ``ffmlp_backward_packed``
replaces ``mlp_forward_pallas_packed`` and ``mlp_backward_pallas_packed``
(K7/K8). On the TPU a ``(B, w < 128)`` array pads its lanes to 128 in HBM, so
those kernels carry G = 128/w samples per 128-lane row and multiply by
G-block-diagonal weights. On the card a row-major ``(B/G, 128)`` tensor is
byte for byte the compact ``(B, w)`` tensor: there is no padding to avoid, so
K7/K8 launch the fused kernels above on the ``(B, w)`` view, with counters of
their own. Their plain versions are the JAX construction written out
independently: ``kron(eye(G), W^T)`` on the packed layout.

Every wrapper dispatches on the device of ``x``: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises. There is no fallback
from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from ..common import Activation
from ..networks.activations import ACTIVATION_CODES, activation_backward, activation_fn

# Launches of the CUDA kernels (each incremented once per launch of its
# wrapper's kernel, nowhere else): the forward and the backward (K2, whose
# parts count on their own too: the walk, and the weight-gradient product
# with its reduce), the same two launched by the packed-I/O wrappers (K7,
# K8), and the earlier atomic backward kept for timing (``_ffmlp_backward_atomic``).
LAUNCHES = 0
BWD_LAUNCHES = 0
WALK_LAUNCHES = 0
DW_LAUNCHES = 0
PACKED_LAUNCHES = 0
PACKED_BWD_LAUNCHES = 0
ATOMIC_LAUNCHES = 0

FFMLP_WIDTHS = (16, 32, 64, 128)

# The weight-gradient product's tiling (csrc/ffmlp_bwd.cu): batch rows a K
# tile, output rows and columns a block, and the split count's aim: about
# four blocks per SM of an H100 (132 SMs), each over at least four K tiles.
DW_TILE_K = 32
DW_TILE_MN = 64
DW_TARGET_BLOCKS = 528
DW_MIN_TILES = 4


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def dw_split(batch: int, shapes: Sequence[Tuple[int, int]]) -> Tuple[int, int, int]:
    """(rows_padded, tiles_per_split, splits) of the weight-gradient product
    for ``batch`` rows and the layers' (fan_out, fan_in) ``shapes``: the
    batch rounded up to whole K tiles, split into ``splits`` ranges of
    ``tiles_per_split`` K tiles (the last one shorter). A function of the
    shapes alone, so the sum order, and the bits, are the same every call."""
    rows_padded = _cdiv(batch, DW_TILE_K) * DW_TILE_K
    k_tiles = rows_padded // DW_TILE_K
    jobs = sum(_cdiv(m, DW_TILE_MN) * _cdiv(n, DW_TILE_MN) for m, n in shapes)
    per_job = max(1, _cdiv(DW_TARGET_BLOCKS, jobs))
    tiles_per_split = max(DW_MIN_TILES, _cdiv(k_tiles, per_job))
    return rows_padded, tiles_per_split, max(1, _cdiv(k_tiles, tiles_per_split))


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


def ffmlp_backward_walk_plain(
    x: torch.Tensor,
    g: torch.Tensor,
    weights: Sequence[torch.Tensor],
    activation: Activation,
    output_activation: Activation,
) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
    """The walk of the backward with the JAX fused backward's rounding
    places (tcnn_tpu/ops/ffmlp.py:_mlp_bwd_kernel): the forward recomputed
    with fp32 pre-activations z; delta = act'(z) * g in fp32; per layer in
    reverse d16 = round(delta), dh = d16 W in fp32; dx = round(dh). Returns
    (dx, ds, hs): dx in the dtype of ``x``; ds[i] layer i's d16 (B,
    fan_out) and hs[i] its input (B, fan_in; hs[0] is x), both in the dtype
    of ``x`` (what the walk kernel writes to its scratch)."""
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
    ds: List[torch.Tensor] = [None] * n
    for i in range(n - 1, -1, -1):
        ds[i] = delta.to(dt)
        dh = ds[i].to(torch.float32) @ weights[i].to(torch.float32)
        if i > 0:
            delta = activation_backward(dh, zs[i - 1], activation)
    return dh.to(dt), ds, hs


def ffmlp_weight_grad_plain(
    ds: Sequence[torch.Tensor], hs: Sequence[torch.Tensor], rows_per_split: int
) -> List[torch.Tensor]:
    """The split-K weight gradient: per layer, fp32 partials D^T H over
    consecutive ranges of ``rows_per_split`` batch rows, summed in range
    order and rounded once to the dtype of ``ds``. (fan_out, fan_in) each."""
    out = []
    for d, h in zip(ds, hs):
        acc = torch.zeros((d.shape[1], h.shape[1]), dtype=torch.float32, device=d.device)
        for lo in range(0, d.shape[0], rows_per_split):
            acc = acc + d[lo : lo + rows_per_split].to(torch.float32).T @ h[lo : lo + rows_per_split].to(torch.float32)
        out.append(acc.to(d.dtype))
    return out


def ffmlp_backward_plain(
    x: torch.Tensor,
    g: torch.Tensor,
    weights: Sequence[torch.Tensor],
    activation: Activation,
    output_activation: Activation,
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The backward of the chain with the JAX fused backward's rounding
    places (tcnn_tpu/ops/ffmlp.py:_mlp_bwd_kernel and _ffmlp_bwd): the walk
    of ``ffmlp_backward_walk_plain``, and dW = d16^T h summed over the whole
    batch in fp32 and rounded once. Not autograd of the chain, whose
    rounding places differ. Returns (dx, [dW...]) in the dtype of ``x``,
    each dW shaped like its weight."""
    dx, ds, hs = ffmlp_backward_walk_plain(x, g, weights, activation, output_activation)
    return dx, [(d.to(torch.float32).T @ h.to(torch.float32)).to(x.dtype) for d, h in zip(ds, hs)]


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
_WALK_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_WALK_SCRATCH_ARGS = [ctypes.c_int] * 4 + [ctypes.c_void_p]
_DW_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_ATOMIC_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


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


def _check(what: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError {err})")


def _launch_forward(what: str, x, weights, activation, output_activation) -> torch.Tensor:
    """Checks the operands and launches ``csrc/ffmlp_fwd.cu``; raises if the
    launch fails."""
    from ._build import kernel

    width, n_hidden, out_width, flat = _kernel_operands(what, x, weights)
    batch = x.shape[0]
    out = torch.empty((batch, out_width), dtype=torch.bfloat16, device=x.device)
    if batch == 0:
        return out
    _check(what, kernel("ffmlp_fwd", "tcnn_ffmlp_forward", _FWD_ARGS)(
        x.data_ptr(), flat.data_ptr(), out.data_ptr(),
        batch, x.shape[1], width, n_hidden, out_width,
        ACTIVATION_CODES[activation], ACTIVATION_CODES[output_activation],
        torch.cuda.current_stream(x.device).cuda_stream,
    ))
    return out


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
    out = _launch_forward("ffmlp_forward", x, weights, activation, output_activation)
    if x.shape[0]:
        global LAUNCHES
        LAUNCHES += 1
    return out


def _backward_operands(what: str, x, g, weights):
    """Checks the backward's operands; returns (width, n_hidden, out_width,
    flat weights)."""
    width, n_hidden, out_width, flat = _kernel_operands(what, x, weights)
    batch = x.shape[0]
    if (
        g.shape != (batch, out_width) or g.dtype != torch.bfloat16 or g.device != x.device
        or not g.is_contiguous()
    ):
        raise ValueError(f"{what}: g must be a contiguous ({batch}, {out_width}) bfloat16 tensor on the device of x")
    return width, n_hidden, out_width, flat


def _walk_z_floats(what: str, in_width: int, dims) -> int:
    """The fp32 count of the walk's global z scratch for these shapes on the
    current device (``tcnn_ffmlp_bwd_walk_scratch``; 0 when the z tiles stay
    in shared memory)."""
    from ._build import kernel

    n = ctypes.c_longlong(0)
    _check(what, kernel("ffmlp_bwd", "tcnn_ffmlp_bwd_walk_scratch", _WALK_SCRATCH_ARGS)(
        in_width, *dims, ctypes.addressof(n)))
    return n.value


def _walk(what: str, x, g, flat, dims, act_codes, rows_padded: int):
    """Launches the walk (``tcnn_ffmlp_bwd_walk``) for a non-empty batch:
    returns (dx, D scratch, H scratch)."""
    from ._build import kernel

    global WALK_LAUNCHES
    width, n_hidden, out_width = dims
    dx = torch.empty_like(x)
    d_scr = torch.empty(rows_padded * (n_hidden * width + out_width), dtype=torch.bfloat16, device=x.device)
    h_scr = torch.empty(rows_padded * n_hidden * width, dtype=torch.bfloat16, device=x.device)
    z_floats = _walk_z_floats(what, x.shape[1], dims)
    z_scr = torch.empty(z_floats, dtype=torch.float32, device=x.device)
    _check(what, kernel("ffmlp_bwd", "tcnn_ffmlp_bwd_walk", _WALK_ARGS)(
        x.data_ptr(), g.data_ptr(), flat.data_ptr(), dx.data_ptr(), d_scr.data_ptr(), h_scr.data_ptr(),
        z_scr.data_ptr(), z_floats, x.shape[0], rows_padded, x.shape[1], width, n_hidden, out_width, *act_codes,
        torch.cuda.current_stream(x.device).cuda_stream,
    ))
    WALK_LAUNCHES += 1
    return dx, d_scr, h_scr


def _weight_grad(what: str, x, d_scr, h_scr, flat, dims, split) -> torch.Tensor:
    """Launches the split-K weight-gradient product and its reduce
    (``tcnn_ffmlp_bwd_dw``): returns dW flat, bf16, in the weights' layout."""
    from ._build import kernel

    global DW_LAUNCHES
    width, n_hidden, out_width = dims
    rows_padded, tiles_per_split, splits = split
    partial = torch.empty(splits * flat.numel(), dtype=torch.float32, device=x.device)
    dw16 = torch.empty_like(flat)
    _check(what, kernel("ffmlp_bwd", "tcnn_ffmlp_bwd_dw", _DW_ARGS)(
        x.data_ptr(), d_scr.data_ptr(), h_scr.data_ptr(), partial.data_ptr(), dw16.data_ptr(),
        x.shape[0], rows_padded, x.shape[1], width, n_hidden, out_width, tiles_per_split, splits,
        torch.cuda.current_stream(x.device).cuda_stream,
    ))
    DW_LAUNCHES += 1
    return dw16


def _unflatten(dw16: torch.Tensor, weights) -> List[torch.Tensor]:
    sizes = [w.numel() for w in weights]
    return [d.view(w.shape) for d, w in zip(dw16.split(sizes), weights)]


def _launch_backward(what: str, x, g, weights, activation, output_activation):
    """Checks the operands and launches ``csrc/ffmlp_bwd.cu``: the walk
    (unless the batch is empty) and the weight gradient; raises if a launch
    fails. Returns (dx, [dW...])."""
    width, n_hidden, out_width, flat = _backward_operands(what, x, g, weights)
    dims = (width, n_hidden, out_width)
    split = dw_split(x.shape[0], [tuple(w.shape) for w in weights])
    codes = (ACTIVATION_CODES[activation], ACTIVATION_CODES[output_activation])
    if x.shape[0]:
        dx, d_scr, h_scr = _walk(what, x, g, flat, dims, codes, split[0])
    else:
        dx, d_scr, h_scr = torch.empty_like(x), x, x
    return dx, _unflatten(_weight_grad(what, x, d_scr, h_scr, flat, dims, split), weights)


def _ffmlp_backward_atomic(x, g, weights, activation, output_activation):
    """The earlier backward kernel (``tcnn_ffmlp_backward_atomic``: dW summed
    with shared-memory atomics, layer groups re-launched when the fp32
    partial does not fit). Kept only so that chip_smoke.py can time the new
    design against it in one call (run-to-run medians drift too far to
    compare across calls) and one on-card test can hold the two against
    each other; no path of the port calls it. CUDA tensors only. Returns
    (dx, [dW...])."""
    from ._build import kernel

    global ATOMIC_LAUNCHES
    width, n_hidden, out_width, flat = _backward_operands("_ffmlp_backward_atomic", x, g, weights)
    dx = torch.empty_like(x)
    dw32 = torch.empty(flat.numel(), dtype=torch.float32, device=x.device)
    dw16 = torch.empty_like(flat)
    _check("_ffmlp_backward_atomic", kernel("ffmlp_bwd", "tcnn_ffmlp_backward_atomic", _ATOMIC_ARGS)(
        x.data_ptr(), g.data_ptr(), flat.data_ptr(), dx.data_ptr(), dw32.data_ptr(), dw16.data_ptr(),
        x.shape[0], x.shape[1], width, n_hidden, out_width,
        ACTIVATION_CODES[activation], ACTIVATION_CODES[output_activation],
        torch.cuda.current_stream(x.device).cuda_stream,
    ))
    ATOMIC_LAUNCHES += 1
    return dx, _unflatten(dw16, weights)


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
    out = _launch_backward("ffmlp_backward", x, g, weights, activation, output_activation)
    global BWD_LAUNCHES
    BWD_LAUNCHES += 1
    return out


def packed_group(in_width: int, weights: Sequence[torch.Tensor]) -> int:
    """Samples per 128-lane row of the packed-I/O path, G = 128/in_width,
    when the MLP is narrow-uniform (every hidden width equals in_width and
    divides 128); 1 when packing does not apply. ``weights`` are row-major
    (fan_out, fan_in) (tcnn_tpu/ops/ffmlp.py:packed_group reads the
    transposed layout)."""
    width = weights[0].shape[0] if weights else 0
    if in_width >= 128 or in_width <= 0 or 128 % in_width != 0:
        return 1
    if width != in_width or any(w.shape[0] != width for w in weights[:-1]):
        return 1
    return 128 // in_width


def _packed_group(x_packed: torch.Tensor, weights: Sequence[torch.Tensor]) -> int:
    """G for a packed batch, or the JAX package's ValueError."""
    if x_packed.dim() != 2 or x_packed.shape[1] != 128:
        raise ValueError(f"x_packed must be (batch/G, 128), got {tuple(x_packed.shape)}")
    in_width = weights[0].shape[1]
    G = packed_group(in_width, weights)
    if G <= 1:
        raise ValueError(
            "packed path needs a narrow uniform MLP (in/hidden width dividing 128); "
            f"got in={in_width}, widths={[w.shape[0] for w in weights]}"
        )
    return G


def _block_diag(w: torch.Tensor, G: int) -> torch.Tensor:
    """kron(eye(G), W^T) in fp32 for a row-major (fan_out, fan_in) ``w``:
    (G*fan_in, G*fan_out), the JAX kernels' ``_kernel_block_diag``."""
    return torch.kron(torch.eye(G, dtype=torch.float32, device=w.device), w.to(torch.float32).T.contiguous())


def _diag_sum(dw: torch.Tensor, G: int) -> torch.Tensor:
    """(G*a, G*b) -> (a, b): the sum of the diagonal blocks, in block order
    (tcnn_tpu/ops/ffmlp.py:_kernel_diag_sum)."""
    a, b = dw.shape[0] // G, dw.shape[1] // G
    acc = dw[:a, :b]
    for k in range(1, G):
        acc = acc + dw[k * a : (k + 1) * a, k * b : (k + 1) * b]
    return acc


def ffmlp_forward_packed_plain(
    x_packed: torch.Tensor,
    weights: Sequence[torch.Tensor],
    activation: Activation,
    output_activation: Activation,
) -> torch.Tensor:
    """The packed-I/O forward as the JAX kernel computes it
    (``_mlp_kernel_packed``): every layer multiplies the packed rows (G
    samples per row) by G-block-diagonal weights, fp32 products, the
    activation in fp32, one bf16 rounding per layer. (rows, 128) ->
    (rows, G*out_p)."""
    G = _packed_group(x_packed, weights)
    dt = x_packed.dtype
    h = x_packed
    n = len(weights)
    for i, w in enumerate(weights):
        z = h.to(torch.float32) @ _block_diag(w, G)
        h = activation_fn(z, output_activation if i == n - 1 else activation).to(dt)
    return h


def ffmlp_backward_packed_plain(
    x_packed: torch.Tensor,
    g_packed: torch.Tensor,
    weights: Sequence[torch.Tensor],
    activation: Activation,
    output_activation: Activation,
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The packed-I/O backward as the JAX kernel and its wrapper compute it
    (``_mlp_bwd_kernel_packed``, ``_ffmlp_packed_bwd``): the block-diagonal
    forward recomputed, then per layer in reverse d16 = bf16(delta), the
    block-diagonal dW = h^T d16 reduced by ``_diag_sum`` in fp32 and rounded
    to bf16 once, dh = d16 W_bd^T in fp32; dx = bf16(dh). Returns (dx
    (rows, 128), [dW...] shaped like the row-major weights)."""
    G = _packed_group(x_packed, weights)
    dt = x_packed.dtype
    n = len(weights)
    wbd = [_block_diag(w, G) for w in weights]
    hs, zs = [x_packed], []
    h = x_packed
    for i in range(n):
        z = h.to(torch.float32) @ wbd[i]
        zs.append(z)
        if i < n - 1:
            h = activation_fn(z, activation).to(dt)
            hs.append(h)
    delta = activation_backward(g_packed.to(torch.float32), zs[-1], output_activation)
    dws: List[torch.Tensor] = [None] * n
    for i in range(n - 1, -1, -1):
        d16 = delta.to(dt).to(torch.float32)
        dws[i] = _diag_sum(hs[i].to(torch.float32).T @ d16, G).T.to(dt)
        dh = d16 @ wbd[i].T
        if i > 0:
            delta = activation_backward(dh, zs[i - 1], activation)
    return dh.to(dt), dws


def _unpacked(x_packed: torch.Tensor, G: int) -> torch.Tensor:
    """The compact (B, 128/G) view of a contiguous packed batch."""
    if not x_packed.is_contiguous():
        raise ValueError("x_packed must be contiguous (the kernels read its compact (B, in_width) view)")
    return x_packed.view(x_packed.shape[0] * G, 128 // G)


def ffmlp_forward_packed(
    x_packed: torch.Tensor,
    weights: Sequence[torch.Tensor],
    activation: Activation,
    output_activation: Activation,
) -> torch.Tensor:
    """Packed-I/O forward (K7). ``x_packed``: (B/G, 128) bf16 with G =
    128/in_width samples per row, i.e. the compact (B, in_width) batch;
    ``weights`` as for ``ffmlp_forward`` of a narrow-uniform MLP. Returns
    (B/G, G*out_p) bf16. On the card: ``csrc/ffmlp_fwd.cu`` on the (B,
    in_width) view (the same bytes), no block-diagonal weights."""
    G = _packed_group(x_packed, weights)
    if x_packed.device.type == "cpu":
        return ffmlp_forward_packed_plain(x_packed, weights, activation, output_activation)
    if x_packed.device.type != "cuda":
        raise ValueError(f"ffmlp_forward_packed: unsupported device {x_packed.device}")
    rows = x_packed.shape[0]
    out = _launch_forward("ffmlp_forward_packed", _unpacked(x_packed, G), weights, activation, output_activation)
    if rows:
        global PACKED_LAUNCHES
        PACKED_LAUNCHES += 1
    return out.view(rows, -1)


def ffmlp_backward_packed(
    x_packed: torch.Tensor,
    g_packed: torch.Tensor,
    weights: Sequence[torch.Tensor],
    activation: Activation,
    output_activation: Activation,
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Packed-I/O backward (K8). ``x_packed`` (B/G, 128) and ``g_packed``
    (B/G, G*out_p) bf16. Returns (dx (B/G, 128), [dW...]) bf16; dW summed
    over the batch in fp32 and rounded once. On the card:
    ``csrc/ffmlp_bwd.cu`` on the (B, in_width) and (B, out_p) views."""
    G = _packed_group(x_packed, weights)
    if x_packed.device.type == "cpu":
        return ffmlp_backward_packed_plain(x_packed, g_packed, weights, activation, output_activation)
    if x_packed.device.type != "cuda":
        raise ValueError(f"ffmlp_backward_packed: unsupported device {x_packed.device}")
    rows = x_packed.shape[0]
    if g_packed.dim() != 2 or g_packed.shape[0] != rows or g_packed.shape[1] % G or not g_packed.is_contiguous():
        raise ValueError(f"ffmlp_backward_packed: g_packed must be a contiguous ({rows}, G*out) tensor")
    g = g_packed.view(rows * G, g_packed.shape[1] // G)
    dx, dws = _launch_backward("ffmlp_backward_packed", _unpacked(x_packed, G), g, weights, activation,
                               output_activation)
    global PACKED_BWD_LAUNCHES
    PACKED_BWD_LAUNCHES += 1
    return dx.view(rows, 128), dws


def _chain_backward(ctx, x, g, weights):
    """The backward under ``create_graph``: autograd of the plain chain
    (``ffmlp_forward_plain``: fp32 products, bf16 rounding per layer),
    recomputed from the saved inputs, so that the gradients it returns are
    themselves differentiable. The JAX package does the same for any
    second-order trace of the fused MLP: ``FullyFusedMLP.apply`` routes it
    to the differentiable XLA chain (tcnn_tpu/networks/fully_fused.py:
    145-162). Returns the gradients of (x, *weights), None where
    ``ctx.needs_input_grad`` says none is needed."""
    wanted = [ctx.needs_input_grad[0]] + list(ctx.needs_input_grad[4:])
    inputs = [t for t, w in zip([x, *weights], wanted) if w]
    with torch.enable_grad():
        out = ffmlp_forward_plain(x, weights, *ctx.acts)
    grads = iter(torch.autograd.grad(out, inputs, g.to(out.dtype), create_graph=True))
    return [next(grads) if w else None for w in wanted]


class FfmlpFunction(torch.autograd.Function):
    """Differentiable fused MLP: the forward is ``ffmlp_forward``, the
    backward ``ffmlp_backward``, or with ``plain`` their plain versions on
    any device. The counterpart of the JAX package's ``ffmlp_apply``; its
    residuals are x and the weights, the backward recomputes the
    activations. A backward that must itself be differentiable
    (``create_graph=True``, e.g. an eikonal loss) takes the chain instead
    (``_chain_backward``), as the JAX package does.

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
        x, *weights = ctx.saved_tensors
        if torch.is_grad_enabled():
            # Second order: the differentiable chain, as JAX's
            # FullyFusedMLP.apply routes second-order traces
            # (tcnn_tpu/networks/fully_fused.py:145-162).
            dx, *dws = _chain_backward(ctx, x, g, weights)
            return (dx, None, None, None, *dws)
        bwd = ffmlp_backward_plain if ctx.plain else ffmlp_backward
        dx, dws = bwd(x, g.to(x.dtype).contiguous(), weights, *ctx.acts)
        return (dx, None, None, None, *dws)


class FfmlpPackedFunction(torch.autograd.Function):
    """Differentiable packed-I/O fused MLP, the counterpart of the JAX
    package's ``ffmlp_apply_packed``: the forward is
    ``ffmlp_forward_packed`` (K7), the backward ``ffmlp_backward_packed``
    (K8), or with ``plain`` their plain versions on any device. Under
    ``create_graph`` the backward takes the chain on the unpacked views,
    as ``FfmlpFunction`` does.

    ``FfmlpPackedFunction.apply(x_packed, activation, output_activation,
    plain, *weights)``
    """

    @staticmethod
    def forward(ctx, x_packed, activation, output_activation, plain, *weights):
        ctx.acts = (activation, output_activation)
        ctx.plain = bool(plain)
        ctx.save_for_backward(x_packed, *weights)
        fwd = ffmlp_forward_packed_plain if plain else ffmlp_forward_packed
        return fwd(x_packed, list(weights), activation, output_activation)

    @staticmethod
    def backward(ctx, g):
        x, *weights = ctx.saved_tensors
        if torch.is_grad_enabled():
            batch = x.numel() // weights[0].shape[1]
            dx, *dws = _chain_backward(ctx, x.reshape(batch, -1), g.reshape(batch, -1), weights)
            return (None if dx is None else dx.reshape(x.shape), None, None, None, *dws)
        bwd = ffmlp_backward_packed_plain if ctx.plain else ffmlp_backward_packed
        dx, dws = bwd(x, g.to(x.dtype).contiguous(), weights, *ctx.acts)
        return (dx, None, None, None, *dws)
