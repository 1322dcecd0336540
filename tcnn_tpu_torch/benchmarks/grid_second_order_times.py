"""The grid's input gradient (G1) and double backward (G2) at the SDF path's shapes, on the card.

The SDF path is the module API on the 3D model (the root ``bench.py``'s
``--protocol 3d`` encoding: 16 levels of F = 2, 2^19-row hashed levels, 52
MB of table) with an eikonal term, which differentiates the lookup twice.
Times, in one process, with CUDA events, at ``--batch`` uniform points, bf16
dy of the encoding's width and the table gradient's classes of that batch:

- G1 (``ops.grid_encode.grid_backward_input``), G2 with the input-gradient
  cotangent only (the eikonal path) and with the table-gradient cotangent
  too (``grid_backward_backward``), beside the 3D lookup (``grid_encode``:
  it reads G1's rows) and the 3D table gradient (``grid_backward``: with
  the lookup it does G2's gathers and adds), each twice, in order and then
  in reverse;
- variants made from the inputs alone: every level shrunk to one row
  (``row0``: every corner reads its level's first row, an L1 hit, the
  index arithmetic kept) and G2 with no table scatter (no class table);
- the compiler's report of the built library: ptxas registers and spills
  and the SASS instruction count of each G1 and G2 kernel;
- with ``--sdf-steps N``, the SDF step itself (``modules.NetworkWithInputEncoding``
  on the 3D model, L2 + 0.1 eikonal on a sphere SDF, ``torch.optim.Adam``):
  the synchronised ms/step (median of N steps) and, under torch.profiler
  over 10 steps, the device-busy ms, the idle share and G1's and G2's
  device ms a step.

Only the package's public wrappers and modules are used, so the script runs
from the root of a checkout of an earlier commit as well (copy it there,
with ``utils/profiling.py`` where that checkout lacks it): that is how a
change is compared with its parent in one call.

Usage: python -m tcnn_tpu_torch.benchmarks.grid_second_order_times
       [--batch 262144] [--reps 20] [--sdf-steps 0] [--seed 0]

One JSON line per measurement; the last line holds them all.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from ..encodings import create_encoding
from ..ops import _build
from ..ops import grid_encode as ge
from ..utils.profiling import profile_steps  # noqa: F401  (also imported from here)
from . import bench_device, card_label, sync, timed_blocks
from .grid_bwd_plans import ENCODING_3D
from .lookup_scatter_times import parse_sass

# The module-API slice's network on the 3D model (chip_smoke.py's NET3D).
NETWORK_3D = {"otype": "FullyFusedMLP", "n_neurons": 64, "n_hidden_layers": 2, "activation": "ReLU",
              "output_activation": "None"}
EIKONAL_WEIGHT = 0.1
# The kernels whose compiler report is kept (names as ptxas and cuobjdump
# print them, mangled).
REPORTED = ("grid_backward_input_kernel", "grid_backward_backward_kernel")


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=2**18, help="uniform points")
    parser.add_argument("--reps", type=int, default=20, help="calls per timed block")
    parser.add_argument("--sdf-steps", type=int, default=0, help="time the SDF step over this many steps (0: not)")
    parser.add_argument("--seed", type=int, default=0)
    return parser


def emit(rec: dict) -> dict:
    print(json.dumps(rec), flush=True)
    return rec


def row0_levels(levels: torch.Tensor) -> torch.Tensor:
    """The level table with every level one row long (the same offsets):
    every corner index is then 0 mod 1, so every corner reads its level's
    first row, and the index arithmetic still runs."""
    t = levels.cpu().numpy().view(np.uint32).copy()
    t[:, 1] = 1  # size
    t[:, 4 + ge.MAX_DIMS:4 + 2 * ge.MAX_DIMS] = 0  # per-dim factors mod the size
    t[:, -2:] = 0  # reciprocal of the size: a mask
    return torch.from_numpy(t.view(np.int32)).to(levels.device)


def inputs(batch: int, dev, seed: int) -> dict:
    """The SDF path's operands of G1 and G2 on the 3D model: positions,
    random table, bf16 dy, both cotangents, the level table (also in its
    ``row0`` form), the class table and plan of a ``batch`` batch."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    enc = create_encoding(3, ENCODING_3D, alignment=16)
    W = enc.padded_output_width
    classes = enc.gradient_classes(batch)
    levels = enc._levels_on(dev)
    return {
        "enc": enc,
        "x": torch.rand((batch, 3), generator=gen, device=dev),
        "params": torch.rand((enc.n_params,), generator=gen, device=dev) * 2 - 1,
        "dy": torch.randn((batch, W), generator=gen, device=dev).to(torch.bfloat16),
        "cgx": torch.randn((batch, 3), generator=gen, device=dev),
        "cgp": torch.randn((enc.n_params,), generator=gen, device=dev),
        "levels": levels,
        "levels_row0": row0_levels(levels),
        "classes": torch.from_numpy(classes).to(dev),
        "plan": ge.backward_plan(enc.level_table(), enc.n_features_per_level, batch, classes),
    }


def cases(t: dict, plain: bool = False) -> dict:
    """name -> call, on the operands of ``inputs``; with ``plain`` also G1's
    and G2's (cgx only) plain versions."""
    x, dy, p, lv, lv0, cls = t["x"], t["dy"], t["params"], t["levels"], t["levels_row0"], t["classes"]
    cgx, cgp = t["cgx"], t["cgp"]
    F, W, lin = t["enc"].n_features_per_level, t["enc"].padded_output_width, ge.INTERP_LINEAR
    out = {
        "lookup": lambda: ge.grid_encode(x, p, lv, F, W, lin, torch.bfloat16),
        "table gradient": lambda: ge.grid_backward(x, dy, lv, F, lin, cls, t["plan"]),
        "G1": lambda: ge.grid_backward_input(x, dy, p, lv, F, lin),
        "G2 cgx": lambda: ge.grid_backward_backward(x, dy, p, lv, F, lin, cls, None, cgx),
        "G2 cgx+cgp": lambda: ge.grid_backward_backward(x, dy, p, lv, F, lin, cls, cgp, cgx),
        "G1 row0": lambda: ge.grid_backward_input(x, dy, p, lv0, F, lin),
        "G2 cgx, no scatter": lambda: ge.grid_backward_backward(x, dy, p, lv, F, lin, None, None, cgx),
        "G2 cgx, row0, no scatter": lambda: ge.grid_backward_backward(x, dy, p, lv0, F, lin, None, None, cgx),
        "lookup row0": lambda: ge.grid_encode(x, p, lv0, F, W, lin, torch.bfloat16),
    }
    if plain:
        out["G1 plain"] = lambda: ge.grid_backward_input_plain(x, dy, p, lv, F, lin)
        out["G2 cgx plain"] = lambda: ge.grid_backward_backward_plain(x, dy, p, lv, F, lin, cls, None, cgx)
    return out


def parse_ptxas(log: str) -> dict:
    """``-Xptxas -v`` output -> {function: {"registers": n, "spill_stores":
    bytes, "spill_loads": bytes}}."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {"registers": None, "spill_stores": 0, "spill_loads": 0})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[name]["spill_stores"], out[name]["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def demangle(names) -> dict:
    """mangled -> readable names by the toolkit's ``cu++filt`` (the mangled
    name itself where it is missing)."""
    names = list(names)
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cu++filt")
    try:
        text = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True, check=True).stdout
        readable = text.splitlines()
        if len(readable) == len(names):
            return dict(zip(names, readable))
    except (OSError, subprocess.SubprocessError):
        pass
    return {n: n for n in names}


def compiler_report(lib_path) -> dict:
    """{readable kernel name: registers, spills, SASS instructions and the
    subroutines it calls} for the G1 and G2 kernels of the library."""
    log = lib_path.with_suffix(".log")
    ptxas = parse_ptxas(log.read_text()) if log.exists() else {}
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = parse_sass(subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True, text=True).stdout)
    names = sorted(n for n in set(ptxas) | set(sass) if any(k in n for k in REPORTED))
    readable = demangle(names)
    return {readable[n]: {**ptxas.get(n, {}), **sass.get(n, {})} for n in names}


def time_kernels(args, dev, card, plain: bool = False) -> list:
    """One record per case of ``cases``: the mean of its two timings (in
    order, then in reverse; each the median of 3 blocks of ``args.reps``
    calls, CUDA events); the plain versions once, 2 calls a block."""
    t = inputs(args.batch, dev, args.seed)
    fns = cases(t, plain)
    kernels = [k for k in fns if not k.endswith("plain")]
    times = {k: [] for k in fns}
    with torch.no_grad():
        for name in kernels + kernels[::-1]:
            times[name].append(timed_blocks(fns[name], dev, args.reps)[0])
        for name in fns:
            if name.endswith("plain"):
                times[name].append(timed_blocks(fns[name], dev, 2)[0])
    rec = {"what": "grid second order", "samples": args.batch, "card": card,
           "acc": t["enc"].gradient_classes(args.batch)[:, 1].tolist(),
           "ms": {k: statistics.mean(v) for k, v in times.items()}}
    return [emit(rec)]


def sphere_sdf(x):
    """The analytic SDF the slice fits: a sphere of radius 0.3 at the
    centre of the unit cube."""
    return (x - 0.5).norm(dim=1, keepdim=True) - 0.3


def sdf_step(opt, f_of, x, target):
    """One step of L2 + EIKONAL_WEIGHT mean((|grad_x f| - 1)^2), the
    gradient taken with create_graph so that the loss differentiates it
    again."""
    opt.zero_grad(set_to_none=True)
    x = x.requires_grad_(True)
    f = f_of(x)
    (g,) = torch.autograd.grad(f, x, torch.ones_like(f), create_graph=True)
    loss = ((f - target) ** 2).mean() + EIKONAL_WEIGHT * ((g.norm(dim=1) - 1) ** 2).mean()
    loss.backward()
    opt.step()
    return loss.detach()


# The curvature term's weight: mean |H v|^2 against the L2 and eikonal
# terms, H the Hessian of the field in x and v a random unit direction a
# sample (a curvature regulariser of neural-SDF work).
CURVATURE_WEIGHT = 1e-8


def curvature_step(opt, f_of, x, target, v):
    """One step of ``sdf_step``'s loss plus CURVATURE_WEIGHT mean(|H v|^2),
    H v the Hessian-vector product that two autograd.grad(create_graph=True)
    calls give: the loss holds a second derivative in x, so its gradient in
    the parameters is a third derivative (the grid's: autograd of its plain
    double backward). Returns (the loss, its curvature term), detached."""
    opt.zero_grad(set_to_none=True)
    x = x.requires_grad_(True)
    f = f_of(x)
    (g,) = torch.autograd.grad(f, x, torch.ones_like(f), create_graph=True)
    (hv,) = torch.autograd.grad((g * v).sum(), x, create_graph=True)
    curvature = (hv * hv).sum(dim=1).mean()
    loss = ((f - target) ** 2).mean() + EIKONAL_WEIGHT * ((g.norm(dim=1) - 1) ** 2).mean() + CURVATURE_WEIGHT * curvature
    loss.backward()
    opt.step()
    return loss.detach(), curvature.detach()


def time_sdf(args, dev, card) -> list:
    """The SDF step at ``args.batch``: synchronised ms/step (median of
    ``args.sdf_steps`` steps after 10), then 10 steps under the profiler."""
    from .. import modules

    m = modules.NetworkWithInputEncoding(3, 1, ENCODING_3D, NETWORK_3D, seed=args.seed)
    opt = torch.optim.Adam(m.parameters(), lr=1e-3, betas=(0.9, 0.99), eps=1e-15)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)

    def step():
        x = torch.rand((args.batch, 3), generator=gen, device=dev)
        return sdf_step(opt, m, x, sphere_sdf(x))

    for _ in range(10):
        step()
    ms = []
    for _ in range(args.sdf_steps):
        sync(dev)
        t0 = time.perf_counter()
        step()
        sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    wall, busy, idle, kernels = profile_steps(step)

    def device(name):
        return sum(v for k, v in kernels if name + "<" in k or name + "(" in k)

    rec = {"what": "sdf step", "samples": args.batch, "card": card, "synced_ms": statistics.median(ms),
           "profile": {"wall_ms": wall, "busy_ms": busy, "idle_share": idle,
                       "G1_ms": device("grid_backward_input_kernel"),
                       "G2_ms": device("grid_backward_backward_kernel"),
                       "largest": kernels[:12]}}
    return [emit(rec)]


def main(argv=None) -> list:
    args = build_parser().parse_args(argv)
    dev = bench_device("cuda")
    card = card_label(dev)
    names = ("grid_fwd", "grid_bwd", "grid_input_grad") + (("ffmlp_fwd", "ffmlp_bwd") if args.sdf_steps > 0 else ())
    lib = _build.build_libraries(names)["grid_input_grad"]
    records = time_kernels(args, dev, card)
    records.append(emit({"what": "grid second order compiler report", "library": lib.name,
                         "kernels": compiler_report(lib)}))
    if args.sdf_steps > 0:
        records += time_sdf(args, dev, card)
    print(json.dumps({"records": records}))
    return records


if __name__ == "__main__":
    main(sys.argv[1:])
    sys.exit(0)
