"""The fused-MLP forward (K1, and K7 on its packed view) and the Adam step (K3) at the main path's shapes, on the card.

Times, in one process, with CUDA events:

- K1 (``ops.ffmlp.ffmlp_forward``, ReLU hidden, no output activation) at
  the flagship network 32 -> 64 x 2 -> 16 on 2^18 rows (a training step or
  a served batch) and 2^20 rows (the 1024^2 raster), and at
  ``bench_image``'s 128 -> 128 x 5 -> 16 on 2^18 rows; K7
  (``ffmlp_forward_packed``) at 64 -> 64 x 3 -> 64 on 2^20 rows, the
  packed MLP protocol's widest shape. The weights are views of one bf16
  buffer, as a network's layers are;
- K3 through ``AdamOptimizer.step`` (the global step's increment and the
  kernel) and through ``ops.fused_adam.adam_step`` alone, at the flagship's
  715,760 parameters and the 3D model's 13,051,984 (``bench --protocol
  3d``), both with the flagship's hyperparameters (7,168 matrix entries,
  10% of the other gradients exactly zero);

each as call ms (events over back-to-back calls: what a loop of calls
costs, the host's issue included where it is the longer) and device ms
(``probe_rows.device_ms``: events around one call queued behind a spin
kernel, the device's work alone), beside its bound (bytes over 3.35 TB/s or
operations over the bf16 / fp32 peak, the larger), and K3's host
microseconds a step call (host clock, no sync). Then the compiler's report
of both libraries (ptxas registers and spills of ``ffmlp_forward_kernel``
and ``adam_step_kernel``).

With ``--end-to-end``, the paths that run them: ``FrozenServer.raster(1024)``
and ``FrozenServer.__call__`` at 2^18 points of the flagship model
(synchronised host ms, median of 11), the flagship training step at 2^18
(synchronised ms, median of ``--steps`` steps; device-busy ms, idle share
and K1's and K3's device ms a step under torch.profiler over 10 steps) and
the SDF step (``grid_second_order_times.time_sdf``).

Only the package's public wrappers and modules are used, so the script runs
from the root of a checkout of an earlier commit as well (copy it there,
with ``utils/profiling.py`` where that checkout lacks it): that is how a
change is compared with its parent in one call.

Usage: python -m tcnn_tpu_torch.benchmarks.ffmlp_adam_times [--reps 20]
       [--seed 0] [--end-to-end] [--steps 50]

One JSON line per measurement; the last line holds them all.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from ..common import Activation
from ..ops import _build, ffmlp, fused_adam
from ..optimizers import AdamOptimizer
from . import bench_device, card_label, sync, timed_blocks
from ..utils.profiling import profile_steps
from .grid_second_order_times import demangle, parse_ptxas, time_sdf
from .probe_rows import device_ms

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense), as
# chip_smoke.py bounds every kernel.
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "fp32": 67e12}
# name -> (batch, in, width, hidden layers, out).
K1_SHAPES = {
    "flagship B=2^18 32->64x2->16": (2**18, 32, 64, 2, 16),
    "raster B=2^20 32->64x2->16": (2**20, 32, 64, 2, 16),
    "bench_image B=2^18 128->128x5->16": (2**18, 128, 128, 5, 16),
}
K7_SHAPE = ("packed B=2^20 64->64x3->64", (2**20, 64, 64, 3, 64))
# name -> (parameters, matrix parameters).
ADAM_SIZES = {"flagship 715,760": (715_760, 7_168), "3D model 13,051,984": (13_051_984, 7_168)}
ADAM_HYPERPARAMS = {"learning_rate": 1e-2, "beta1": 0.9, "beta2": 0.99, "epsilon": 1e-15, "l2_reg": 1e-6}
LOSS_SCALE = 128.0
REPORTED = ("ffmlp_forward_kernel", "adam_step_kernel")


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=20, help="calls per timed block")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--end-to-end", action="store_true",
                        help="also time the serving calls, the flagship training step and the SDF step")
    parser.add_argument("--steps", type=int, default=50, help="synchronised steps timed with --end-to-end")
    return parser


def emit(rec: dict) -> dict:
    print(json.dumps(rec), flush=True)
    return rec


def bound(n_bytes: float, n_ops: float, kind: str):
    """(ms, "bytes" or "operations"): the larger of the bytes over the HBM
    rate and the operations over the peak rate of their type."""
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = n_ops / PEAK_OPS_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def layer_shapes(in_w: int, width: int, n_hidden: int, out_w: int):
    """The row-major (fan_out, fan_in) weight shapes of the MLP."""
    if n_hidden == 0:
        return [(out_w, in_w)]
    return [(width, in_w)] + [(width, width)] * (n_hidden - 1) + [(out_w, width)]


def k1_bound(batch: int, in_w: int, width: int, n_hidden: int, out_w: int):
    """x read and the output written once (bf16), the weights read once;
    2 operations a weight a row in bf16."""
    n_w = sum(a * b for a, b in layer_shapes(in_w, width, n_hidden, out_w))
    return bound(batch * (in_w + out_w) * 2 + n_w * 2, 2 * batch * n_w, "bf16")


def adam_bound(n: int):
    """Params, gradients, both moments and the step counts read, all but
    the gradients written (36 bytes); ~20 fp32 operations an entry."""
    return bound(n * 36, n * 20, "fp32")


def mlp_operands(shape, dev, gen):
    """(x, weights) of a K1 shape: uniform x in [-1, 1]; weights uniform at
    the xavier scale, views of one bf16 buffer."""
    batch, in_w, width, n_hidden, out_w = shape
    shapes = layer_shapes(in_w, width, n_hidden, out_w)
    parts = [(torch.rand(r * c, generator=gen, device=dev) * 2 - 1) * (6.0 / (r + c)) ** 0.5 for r, c in shapes]
    flat = torch.cat(parts).to(torch.bfloat16)
    ws, off = [], 0
    for r, c in shapes:
        ws.append(flat[off:off + r * c].view(r, c))
        off += r * c
    x = (torch.rand((batch, in_w), generator=gen, device=dev) * 2 - 1).to(torch.bfloat16)
    return x, ws


def adam_operands(n: int, n_matrix: int, dev, seed: int):
    rng = np.random.default_rng(seed)
    g = rng.normal(0, 1, n).astype(np.float32) * LOSS_SCALE
    g[n_matrix:][rng.random(n - n_matrix) < 0.1] = 0.0
    opt = AdamOptimizer(ADAM_HYPERPARAMS)
    opt.allocate(n, [(1, n_matrix)])
    params = torch.from_numpy(rng.normal(0, 0.3, n).astype(np.float32)).to(dev)
    return opt, opt.init_state(dev), params, torch.from_numpy(g).to(dev)


def timed(fn, dev, reps: int) -> dict:
    return {"call_ms": timed_blocks(fn, dev, reps)[0], "device_ms": device_ms(fn, dev, 21)}


def host_us(fn, dev, n: int = 500) -> float:
    for _ in range(20):
        fn()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / n
    sync(dev)
    return us


def time_mlp(args, dev, card) -> list:
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    relu, none = Activation.ReLU, Activation.NONE
    cases = {}
    for name, shape in K1_SHAPES.items():
        x, ws = mlp_operands(shape, dev, gen)
        cases[name] = ("K1", shape, lambda x=x, ws=ws: ffmlp.ffmlp_forward(x, ws, relu, none))
    name, shape = K7_SHAPE
    x, ws = mlp_operands(shape, dev, gen)
    xp = x.view(-1, 128)
    cases[name] = ("K7", shape, lambda xp=xp, ws=ws: ffmlp.ffmlp_forward_packed(xp, ws, relu, none))
    runs = {k: [] for k in cases}
    with torch.no_grad():
        for k in list(cases) + list(cases)[::-1]:
            runs[k].append(timed(cases[k][2], dev, args.reps))
    records = []
    for k, (kernel, shape, _) in cases.items():
        b = k1_bound(*shape)
        records.append(emit({
            "what": kernel, "shape": k, "card": card, "bound_ms": b[0], "bound_by": b[1],
            **{m: statistics.mean(r[m] for r in runs[k]) for m in ("call_ms", "device_ms")}}))
    return records


def time_adam(args, dev, card) -> list:
    records = []
    for name, (n, n_matrix) in ADAM_SIZES.items():
        opt, state, params, grads = adam_operands(n, n_matrix, dev, args.seed)
        hp = fused_adam.hyperparams_of(opt, n, n_matrix, LOSS_SCALE)
        fns = {
            "AdamOptimizer.step": lambda: opt.step(state, params, grads, LOSS_SCALE),
            "adam_step": lambda: fused_adam.adam_step(params, grads, state["first_moments"], state["second_moments"],
                                                      state["param_steps"], state["step"], hp),
        }
        runs = {k: [] for k in fns}
        for k in list(fns) + list(fns)[::-1]:
            runs[k].append(timed(fns[k], dev, args.reps))
        b = adam_bound(n)
        rec = {"what": "K3", "shape": name, "card": card, "bound_ms": b[0], "bound_by": b[1],
               "host_us": {"AdamOptimizer.step": host_us(fns["AdamOptimizer.step"], dev)}}
        for k in fns:
            rec[k] = {m: statistics.mean(r[m] for r in runs[k]) for m in ("call_ms", "device_ms")}
        records.append(emit(rec))
        del opt, state, params, grads
    return records


def compiler_report() -> dict:
    """{library: {readable kernel name: registers and spills}} for the K1
    and K3 kernels."""
    out = {}
    for name, path in _build.build_libraries(("ffmlp_fwd", "adam_step")).items():
        log = path.with_suffix(".log")
        ptxas = parse_ptxas(log.read_text()) if log.exists() else {}
        names = sorted(n for n in ptxas if any(k in n for k in REPORTED))
        readable = demangle(names)
        out[name] = {readable[n]: ptxas[n] for n in names}
    return out


def _synced_ms(fn, dev, n: int) -> float:
    ms = []
    for _ in range(n):
        sync(dev)
        t0 = time.perf_counter()
        fn()
        sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms)


def time_end_to_end(args, dev, card) -> list:
    """The serving calls and the flagship training step of the flagship
    model (random parameters from the seed), then the SDF step."""
    import tcnn_tpu_torch as tt
    from __graft_entry__ import FLAGSHIP_CONFIG

    from ..utils.sampling import stratified_uniform

    m = tt.create_from_config(2, 3, FLAGSHIP_CONFIG, seed=args.seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def batch():
        x = stratified_uniform(2**18, 2, gen)
        return x, torch.stack([torch.sin(6 * x[:, 0]), torch.cos(5 * x[:, 1]), x[:, 0] * x[:, 1]], 1)

    for _ in range(10):
        m.training_step(*batch())
    server = m.trainer.freeze_serving()
    points = torch.rand((2**18, 2), generator=gen, device=dev)
    rec = {"what": "end to end", "card": card,
           "FrozenServer.raster(1024) ms": _synced_ms(lambda: server.raster(1024), dev, 11),
           "FrozenServer(2^18 points) ms": _synced_ms(lambda: server(points), dev, 11),
           "training_step ms": _synced_ms(lambda: m.training_step(*batch()), dev, args.steps)}
    wall, busy, idle, kernels = profile_steps(lambda: m.training_step(*batch()))

    def device(name):
        return sum(v for k, v in kernels if name in k)

    rec["training_step profile"] = {"wall_ms": wall, "busy_ms": busy, "idle_share": idle,
                                    "K1_ms": device("ffmlp_forward_kernel"), "K3_ms": device("adam_step_kernel"),
                                    "largest": kernels[:10]}
    records = [emit(rec)]
    del m, server
    records += time_sdf(argparse.Namespace(batch=2**18, seed=args.seed, sdf_steps=args.steps), dev, card)
    return records


def main(argv=None) -> list:
    args = build_parser().parse_args(argv)
    dev = bench_device("cuda")
    card = card_label(dev)
    report = compiler_report()
    records = time_mlp(args, dev, card) + time_adam(args, dev, card)
    records.append(emit({"what": "K1 and K3 compiler report", "kernels": report}))
    if args.end_to_end:
        records += time_end_to_end(args, dev, card)
    print(json.dumps({"records": records}))
    return records


if __name__ == "__main__":
    main(sys.argv[1:])
    sys.exit(0)
