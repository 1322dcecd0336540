"""The spherical-harmonics kernels at the NeRF path's shapes, on the card.

``tcnn_sh_forward`` and ``tcnn_sh_backward_input`` through their public
wrappers (``ops.sh_encode.sh_encode`` / ``sh_backward_input``) at B = 2^18,
degree 3, 7 padding columns, bf16 output and bf16 dL/dy of width 16, the
directions the strided ``(B, 6)[:, 3:]`` view a Composite hands over. Three
times of each:

- device ms, cold: calls rotate over a ring of ``RING`` input and output
  sets (14.7 MB a set forward, 17.8 MB backward: 118 / 142 MB in all,
  beyond the 50 MB L2), so each call finds its buffers out of L2. Read two
  ways: the kernel's own duration under torch.profiler (mean of ``4 *
  RING`` back-to-back calls; the number the records use), and
  ``probe_rows.device_ms`` (CUDA events around one call queued behind a
  spin kernel, so the wrapper's host time is hidden; median of ``--reps``),
  beside the same events around a one-cycle spin kernel: the events' own
  floor, which a kernel of a few microseconds does not rise far above;
- device ms, warm: the same, one set every call, so the inputs come from L2
  (where the NeRF step's grid lookup has just read the same rows); a warm
  reading under the bytes bound is L2's rate, not a share of HBM's;
- call ms, as ``chip_smoke.py`` records it: CUDA events over 10
  back-to-back calls on one set, median of 7.

Each beside its bound: the bytes the call must move (the 12-byte position
read once, the 16 bf16 columns written; backward: the position and the 9 SH
columns of dL/dy read, 12 bytes of dL/dx written) over the H100's 3.35 TB/s;
and beside the rate it reaches on the bytes a cold call does move (the
positions' 32-byte sectors, 24 bytes a row, and the whole 32-byte dL/dy
rows) and that of three yardsticks over the same ring, PyTorch's own
kernels: ``copy_`` of the (B, 16) bf16 rows, ``fill_`` of such rows and
``clone`` of the strided positions.
The double backward (the input gradient's vjp, which a penalty on dL/dx
differentiates) is timed two ways: as the call a user makes, ``torch.
autograd.grad`` of ``ShBackwardFunction``'s dL/dx in (positions, dL/dy)
with a cotangent c (every device op of the call under the profiler, so
that a checkout whose second order is autograd of the plain vjp is timed
the same way), and, where the checkout has it, the kernel
``tcnn_sh_backward_backward`` alone through ``sh_backward_backward``,
beside its plain version; at the NeRF shapes and at degree 8 with fp32
dL/dy and no padding (2^18 rows of 64 columns), each beside its bound (the
positions, the SH columns of dL/dy and c read, d/dx and the whole
d/d(dL/dy) row written; the operations ``bwdbwd_ops`` counts).
With ``--ptxas`` the ``sh_encode`` library's registers and spills for every
kernel (degrees 1-8, each route). With ``--nerf S1,S2`` the NeRF sample
(``samples.nerf_synthetic 600 8192 --seed S``) for each seed: ms a step and
served frames/s.

Only the package's public wrappers are used, so the script runs from the
root of a checkout of an earlier commit as well (copy it there, with
``utils/profiling.py`` where that checkout lacks it): that is how a change
is compared with its parent in one call (parent, change, change, parent).

Usage: python -m tcnn_tpu_torch.benchmarks.sh_times [--reps 50] [--ptxas]
       [--nerf 0,1]

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json

BATCH = 2**18
DEGREE = 3
PAD = 7
WIDTH = PAD + DEGREE * DEGREE
RING = 8
HBM_BYTES_S = 3.35e12  # one H100 SXM (NVIDIA's data sheet)
# What each call must move: forward the position and the bf16 row;
# backward the position, the SH columns of dL/dy and dL/dx.
BYTES = {"forward": BATCH * (12 + 2 * WIDTH), "backward": BATCH * (12 + 2 * DEGREE * DEGREE + 12)}
# What each call moves to and from HBM when cold: the 32-byte sectors of
# the (B, 6) rows (24 bytes a row), the whole dL/dy rows, the outputs.
SECTOR_BYTES = {"forward": BATCH * (24 + 2 * WIDTH), "backward": BATCH * (24 + 2 * WIDTH + 12)}
PEAK_FP32_OPS_S = 67e12  # one H100 SXM, fp32 outside the tensor cores
# The double backward's two shapes: (degree, padding columns, dL/dy dtype
# name, strided positions).
BWDBWD_SHAPES = {"nerf": (DEGREE, PAD, "bfloat16", True), "degree 8 fp32": (8, 0, "float32", False)}


def bwdbwd_bytes(degree: int, pad: int, itemsize: int) -> int:
    """Bytes a double-backward row must move: the 12-byte position, the
    degree^2 SH columns of dL/dy and the 12-byte c read; the 12-byte d/dx
    and the whole (pad + degree^2) row of d/d(dL/dy) written."""
    return 12 + itemsize * degree * degree + 12 + 12 + itemsize * (pad + degree * degree)


def bwdbwd_ops(degree: int) -> int:
    """fp32 operations a row of ``tcnn_sh_backward_backward`` does, counted
    from its loops: 6 for each A_m, B_m; for each m the recurrences (3 at l
    = m + 1, 18 for q, q', q'' at each l >= m + 2), 16 for the first and
    second partials and J's (c_x, c_y) columns, 24 for each l (the six
    Hessian sums and two d(dL/dy) values), 33 for the m's share of H c; 9
    for the factors and the remap."""
    ops = 6 * (degree - 1) + 9
    for m in range(degree):
        ops += (3 if m + 1 < degree else 0) + 18 * max(degree - m - 2, 0) + 16 + 24 * (degree - m) + 33
    return ops


def _rotating(call, sets):
    """A call that takes the next of ``sets`` each time and keeps its
    output alive until that set comes round again, so an output buffer too
    is reused only every len(sets) + 1 calls."""
    outs = [None] * len(sets)
    state = {"k": 0}

    def fn():
        k = state["k"] % len(sets)
        state["k"] += 1
        outs[k] = call(*sets[k])

    return fn


def _kernel_ms(fn, n, marker):
    """Mean device ms a call of the profiled kernels whose name holds
    ``marker``, over ``n`` back-to-back calls under torch.profiler."""
    from ..utils.profiling import profile_steps

    _, _, _, kernels = profile_steps(fn, n=n)
    ms = sum(t for name, t in kernels if marker in name)
    if ms <= 0:
        raise RuntimeError(f"sh_times: the profiler recorded no kernel named like {marker!r}")
    return ms


def times(reps: int = 50, seed: int = 7) -> dict:
    """{"forward" | "backward": {"cold_ms", "warm_ms" (the kernel under the
    profiler), "cold_event_ms", "warm_event_ms" (events behind a spin),
    "call_ms", "bound_ms", "share_cold", "share_warm", "sector_bytes",
    "cold_tb_s"}, each yardstick: {"cold_ms", "warm_ms", "sector_bytes",
    "cold_tb_s"}, "event_floor_ms", "routes"} at the NeRF path's shapes;
    ``cold_tb_s`` is the bytes a cold call moves over its cold time."""
    import torch

    from ..ops import sh_encode as sh
    from .grid_ab_times import _event_ms
    from .probe_rows import device_ms

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    sets = [(torch.rand((BATCH, 6), generator=gen, device=dev)[:, 3:],
             torch.randn((BATCH, WIDTH), generator=gen, device=dev).to(torch.bfloat16)) for _ in range(RING)]
    calls = {
        "forward": (lambda x, dy: sh.sh_encode(x, DEGREE, PAD, 1.0, torch.bfloat16), "sh_forward"),
        "backward": (lambda x, dy: sh.sh_backward_input(x, dy, DEGREE, PAD), "sh_backward_input"),
    }
    out = {}
    with torch.no_grad():
        for what, (call, marker) in calls.items():
            cold, warm = _rotating(call, sets), _rotating(call, sets[:1])
            bound = BYTES[what] / HBM_BYTES_S * 1e3
            rec = {
                "cold_ms": _kernel_ms(cold, 4 * RING, marker),
                "warm_ms": _kernel_ms(warm, 4 * RING, marker),
                "cold_event_ms": device_ms(cold, dev, reps),
                "warm_event_ms": device_ms(warm, dev, reps),
                "call_ms": _event_ms(warm, iters=10),
                "bound_ms": bound,
                "bound_by": "bytes",
                "sector_bytes": SECTOR_BYTES[what],
            }
            rec["share_cold"] = bound / rec["cold_ms"]
            rec["share_warm"] = bound / rec["warm_ms"]
            out[what] = rec
        # Yardsticks: PyTorch's own copy kernels over the same ring, what
        # the card does with such bytes (reads and writes, writes alone,
        # the strided positions' sectors read).
        yardsticks = {
            "copy_ of the (B, 16) bf16 rows": (lambda x, dy: torch.empty_like(dy).copy_(dy), BATCH * 64),
            "fill_ of (B, 16) bf16 rows": (lambda x, dy: torch.empty_like(dy).fill_(1.0), BATCH * 32),
            "clone of the (B, 6)[:, 3:] positions": (lambda x, dy: x.clone(), BATCH * 36),
        }
        for name, (call, n_bytes) in yardsticks.items():
            cold, warm = _rotating(call, sets), _rotating(call, sets[:1])
            out[name] = {"cold_ms": _kernel_ms(cold, 4 * RING, ""), "warm_ms": _kernel_ms(warm, 4 * RING, ""),
                         "sector_bytes": n_bytes}
    for rec in out.values():
        rec["cold_tb_s"] = rec["sector_bytes"] / rec["cold_ms"] / 1e9
    out["event_floor_ms"] = device_ms(lambda: torch.cuda._sleep(1), dev, reps)
    out["routes"] = dict((f"{k[0]} {k[1]}", v) for k, v in getattr(sh, "ROUTE_LAUNCHES", {}).items())
    for name, shape in BWDBWD_SHAPES.items():
        out[f"double_backward {name}"] = double_backward_times(*shape, seed=seed)
    return out


def double_backward_times(degree: int, pad: int, dtype_name: str, strided: bool, seed: int = 7) -> dict:
    """The double backward at 2^18 rows: {"autograd_cold_ms",
    "autograd_warm_ms" (every device op of ``torch.autograd.grad`` of
    ``ShBackwardFunction``'s dL/dx in (positions, dL/dy) with cotangent c,
    under the profiler), "autograd_call_ms" (CUDA events over 10 calls),
    and, where the checkout has ``sh_backward_backward``, "kernel_cold_ms",
    "kernel_warm_ms", "kernel_call_ms", "plain_ms" (its plain version's call
    time); "bound_ms", "bound_by", "bytes", "ops"}; cold: a ring of
    ``RING`` input sets."""
    import torch

    from ..ops import sh_encode as sh
    from .grid_ab_times import _event_ms

    dev = torch.device("cuda")
    dtype = getattr(torch, dtype_name)
    width = pad + degree * degree
    gen = torch.Generator(device=dev).manual_seed(seed + degree)
    sets = []
    for _ in range(RING):
        wide = torch.rand((BATCH, 6), generator=gen, device=dev)
        x = wide[:, 3:] if strided else wide[:, :3].contiguous()
        dy = torch.randn((BATCH, width), generator=gen, device=dev).to(dtype)
        sets.append((x, dy, torch.randn((BATCH, 3), generator=gen, device=dev)))
    graphs = []
    for x, dy, c in sets:
        xl, dyl = x.detach().requires_grad_(True), dy.detach().requires_grad_(True)
        with torch.enable_grad():
            graphs.append((sh.ShBackwardFunction.apply(xl, dyl, degree, pad, False), xl, dyl, c))
    itemsize = torch.empty((), dtype=dtype).element_size()
    n_bytes, ops = BATCH * bwdbwd_bytes(degree, pad, itemsize), BATCH * bwdbwd_ops(degree)
    bound_bytes, bound_ops = n_bytes / HBM_BYTES_S * 1e3, ops / PEAK_FP32_OPS_S * 1e3
    rec = {"bytes": n_bytes, "ops": ops, "bound_ms": max(bound_bytes, bound_ops),
           "bound_by": "bytes" if bound_bytes >= bound_ops else "operations"}

    def autograd_call(dx, xl, dyl, c):
        return torch.autograd.grad(dx, (xl, dyl), c, retain_graph=True)

    cold, warm = _rotating(autograd_call, graphs), _rotating(autograd_call, graphs[:1])
    rec.update(autograd_cold_ms=_kernel_ms(cold, 4 * RING, ""), autograd_warm_ms=_kernel_ms(warm, 4 * RING, ""),
               autograd_call_ms=_event_ms(warm, iters=10))
    if hasattr(sh, "sh_backward_backward"):
        with torch.no_grad():
            call = lambda x, dy, c: sh.sh_backward_backward(x, dy, c, degree, pad)  # noqa: E731
            cold, warm = _rotating(call, sets), _rotating(call, sets[:1])
            rec.update(kernel_cold_ms=_kernel_ms(cold, 4 * RING, "sh_backward_backward"),
                       kernel_warm_ms=_kernel_ms(warm, 4 * RING, "sh_backward_backward"),
                       kernel_call_ms=_event_ms(warm, iters=10),
                       plain_ms=_event_ms(lambda: sh.sh_backward_backward_plain(*sets[0], degree, pad), iters=3))
        rec["share_cold"] = rec["bound_ms"] / rec["kernel_cold_ms"]
    return rec


def ptxas() -> dict:
    """{readable kernel name: [registers, spill store bytes, spill load
    bytes]} of the ``sh_encode`` library, built if it is not."""
    from ..ops import _build
    from .grid_ab_times import _kernel
    from .grid_second_order_times import demangle, parse_ptxas

    path = _build.build_library("sh_encode")
    report = parse_ptxas(path.with_suffix(".log").read_text())
    readable = demangle(report)
    return {_kernel(readable[fn]): [r["registers"], r["spill_stores"], r["spill_loads"]] for fn, r in report.items()}


def nerf(seeds) -> dict:
    """The NeRF sample's ms a step, served frames/s and validation PSNR at
    600 steps of 8192 rays, one run a seed."""
    from ..samples import nerf_synthetic

    out = {}
    for s in seeds:
        r = nerf_synthetic.main(["600", "8192", "--seed", str(s)])
        out[str(s)] = {"ms_per_step": r["ms_per_step"], "fps": r["fps"], "psnr_db": r["psnr_db"]}
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=50, help="calls behind a spin kernel for each device time")
    parser.add_argument("--ptxas", action="store_true", help="also the library's registers and spills")
    parser.add_argument("--nerf", default="", help="comma-separated seeds of NeRF sample runs")
    args = parser.parse_args(argv)
    import torch

    from . import card_label

    if not torch.cuda.is_available():
        raise SystemExit("sh_times: needs a CUDA device")
    dev = torch.device("cuda")
    result = {"device": card_label(dev), "ptxas": ptxas() if args.ptxas else None, "times": times(args.reps)}
    result["nerf"] = nerf(int(s) for s in args.nerf.split(",")) if args.nerf else None
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
