"""The grid lookup and the row scatter at the main path's shapes, on the card.

Times, in one process, with CUDA events:

- the all-levels grid lookup (``ops.grid_encode.grid_encode``, and the
  earlier kernel ``grid_encode_v1`` where the package has it) at four
  shapes: the flagship encoding (``__graft_entry__.FLAGSHIP_CONFIG``'s) on a
  stratified batch and on uniform points, the 3D model (the root
  ``bench.py``'s ``--protocol 3d`` encoding) on uniform points, each at
  ``--batch`` samples, and the flagship on the 1024^2 tile-center raster;
- the compiler's report of the built lookup library: ptxas registers and
  spills, and from ``cuobjdump -sass`` each lookup kernel's instruction
  count and the subroutines it calls;
- the row scatter (``ops.scatter_rows.scatter_rows``) at 2^18 rows of 4
  into 64 slots (fp32), at the P3 probe's shapes (2^18 rows of 8 into
  4,096 and 32,768 slots, fp32) and at P19's (8,192 rows of 8 into 65,536
  slots, bf16-rounded rows), beside ``index_add_`` of the same (rounded)
  rows: device ms a call (``probe_rows.device_ms``: events around one call
  queued behind a spin kernel) and call ms (events over back-to-back
  calls), and the wrapper's host microseconds a call (host clock, no sync).

Only the package's public kernel wrappers are used, so the script runs
from the root of a checkout of an earlier commit as well (copy it there):
that is how a change is compared with its parent in one call.

Usage: python -m tcnn_tpu_torch.benchmarks.lookup_scatter_times [--batch 262144]
       [--raster 1024] [--reps 20]

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
from ..ops import scatter_rows as sr
from ..utils.sampling import raster_centers_torch, stratified_uniform
from . import bench_device, card_label, sync, timed_blocks
from .grid_bwd_plans import ENCODING_3D, FLAGSHIP_ENCODING
from .probe_rows import device_ms


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=2**18, help="samples (a perfect square: the stratified batch)")
    parser.add_argument("--raster", type=int, default=1024, help="side of the served raster")
    parser.add_argument("--reps", type=int, default=20, help="calls per timed block")
    parser.add_argument("--seed", type=int, default=0)
    return parser


def emit(rec: dict) -> dict:
    print(json.dumps(rec), flush=True)
    return rec


def lookup_inputs(batch: int, raster: int, dev, seed: int):
    """name -> (encoding, positions, level table, params)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    flagship = create_encoding(2, FLAGSHIP_ENCODING, alignment=16)
    enc3 = create_encoding(3, ENCODING_3D, alignment=16)
    params = {id(e): torch.rand((e.n_params,), generator=gen, device=dev) * 2 - 1 for e in (flagship, enc3)}
    sides = (raster, raster)
    out = {
        "flagship stratified": (flagship, stratified_uniform(batch, 2, gen, device=dev), flagship._levels_on(dev)),
        "flagship uniform": (flagship, torch.rand((batch, 2), generator=gen, device=dev), flagship._levels_on(dev)),
        "3D model uniform": (enc3, torch.rand((batch, 3), generator=gen, device=dev), enc3._levels_on(dev)),
        f"flagship raster {raster}^2": (flagship, raster_centers_torch(raster, 2, dev),
                                        flagship._levels_on(dev, raster_sides=sides)),
    }
    return {k: (e, x, lv, params[id(e)]) for k, (e, x, lv) in out.items()}


def parse_sass(sass: str) -> dict:
    """``cuobjdump -sass`` text -> {function: {"instructions": n, "calls":
    [targets]}}."""
    kernels, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            kernels[name] = {"instructions": 0, "calls": set()}
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/\s+\S", line):
            kernels[name]["instructions"] += 1
            c = re.search(r"CALL\S*\s+[^;]*?\(?([A-Za-z_$][\w$]*)\)?\s*;", line)
            if c:
                kernels[name]["calls"].add(c.group(1))
    return {k: {"instructions": v["instructions"], "calls": sorted(v["calls"])} for k, v in kernels.items()}


def compiler_report(lib_path) -> dict:
    """ptxas registers and spills of the library's kernels, and per lookup
    kernel the SASS instruction count and the subroutines it calls."""
    log = lib_path.with_suffix(".log")
    ptxas = [ln.strip() for ln in log.read_text().splitlines() if "registers" in ln or "spill" in ln] \
        if log.exists() else []
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True, text=True).stdout
    return {"ptxas": ptxas, "sass": {k: v for k, v in parse_sass(sass).items() if "grid_forward" in k}}


def time_lookups(args, dev, card):
    inputs = lookup_inputs(args.batch, args.raster, dev, args.seed)
    kernels = ["grid_encode"] + (["grid_encode_v1"] if hasattr(ge, "grid_encode_v1") else [])
    lib_path = _build.build_library("grid_fwd")
    records = []
    with torch.no_grad():
        for shape, (enc, x, levels, params) in inputs.items():
            F, W, interp = enc.n_features_per_level, enc.padded_output_width, ge.INTERP_LINEAR
            fns = {name: (lambda w=getattr(ge, name): w(x, params, levels, F, W, interp, torch.bfloat16))
                   for name in kernels}
            # Each kernel twice, in order and then in reverse.
            times = {k: [] for k in fns}
            for name in list(fns) + list(fns)[::-1]:
                times[name].append(timed_blocks(fns[name], dev, args.reps)[0])
            rec = {"what": "lookup", "shape": shape, "samples": int(x.shape[0]), "card": card,
                   "ms": {k: statistics.mean(v) for k, v in times.items()}}
            records.append(emit(rec))
    report = compiler_report(lib_path)
    records.append(emit({"what": "lookup compiler report", "library": lib_path.name, **report}))
    return records


def scatter_cases(dev, seed: int):
    r = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(a).to(dev)

    cases = {"2^18 x 4 into 64, fp32": (t(r.integers(0, 64, 2**18).astype(np.int32)),
                                          t(r.normal(size=(2**18, 4)).astype(np.float32)), 64, sr.CONTRIB_NONE)}
    for S in (4096, 32768):
        cases[f"P3 rmw 2^18 x 8 into {S}, fp32"] = (t(r.integers(0, S, 2**18).astype(np.int32)),
                                                    t(r.normal(size=(2**18, 8)).astype(np.float32)), S,
                                                    sr.CONTRIB_NONE)
    idx3 = r.integers(0, 1024 * 32, (2, 4, 1024))
    flat = (idx3 + np.arange(2)[:, None, None] * 1024 * 32).reshape(-1).astype(np.int32)
    cases["P19 8192 x 8 into 65536, RN"] = (t(flat), t(r.normal(size=(8192, 8)).astype(np.float32)), 65536,
                                            sr.CONTRIB_RN)
    return cases


def time_scatters(args, dev, card):
    records = []
    for shape, (idx, rows, size, contrib) in scatter_cases(dev, args.seed).items():
        idx64 = idx.long()
        rounded = sr.round_contributions(rows, contrib)
        fns = {
            "scatter_rows": lambda: sr.scatter_rows(idx, rows, size, contrib),
            "index_add_": lambda: torch.zeros((size, rows.shape[1]), device=dev).index_add_(0, idx64, rounded),
        }
        rec = {"what": "scatter", "shape": shape, "card": card, "device_ms": {}, "call_ms": {}, "host_us": {}}
        for name in list(fns) + list(fns)[::-1]:
            rec["device_ms"].setdefault(name, []).append(device_ms(fns[name], dev, 21))
            rec["call_ms"].setdefault(name, []).append(timed_blocks(fns[name], dev, args.reps)[0])
        for name, fn in fns.items():
            n = 500
            for _ in range(20):
                fn()
            sync(dev)
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            rec["host_us"][name] = (time.perf_counter() - t0) * 1e6 / n
            sync(dev)
        for key in ("device_ms", "call_ms"):
            rec[key] = {k: statistics.mean(v) for k, v in rec[key].items()}
        records.append(emit(rec))
    return records


def main(argv=None) -> list:
    args = build_parser().parse_args(argv)
    dev = bench_device("cuda")
    card = card_label(dev)
    _build.build_libraries(("grid_fwd", "grid_bwd"))
    records = time_lookups(args, dev, card) + time_scatters(args, dev, card)
    print(json.dumps({"records": records}))
    return records


if __name__ == "__main__":
    main(sys.argv[1:])
    sys.exit(0)
