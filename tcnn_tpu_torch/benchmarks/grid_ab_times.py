"""The lookup and the table gradient at the flagship (B = 2^18, stratified
and uniform points) and on the 3D model (uniform points), through the
public wrappers, and with ``--ptxas`` the grid libraries' build seconds and
every kernel's registers and spills. Card only.

Prints one JSON line ``{"times": {...}, "ptxas": {...}}``: CUDA events,
median of 7 runs of 20 calls each, bf16 output and dL/dy, each encoding in
its own training classes. For a parent-beside-change pair, copy this file
into the parent's ``tcnn_tpu_torch/benchmarks/`` and run it from both roots
in turns (parent, change, change, parent) in one call:

    python -m tcnn_tpu_torch.benchmarks.grid_ab_times [--ptxas]
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

FLAGSHIP = {"otype": "HashGrid", "n_levels": 16, "n_features_per_level": 2, "log2_hashmap_size": 15,
            "base_resolution": 16, "per_level_scale": 1.5, "hash": "CoherentAdditive", "gather_strategy": "stratified"}
MODEL_3D = {"otype": "HashGrid", "n_levels": 16, "n_features_per_level": 2, "log2_hashmap_size": 19,
            "base_resolution": 16, "per_level_scale": 1.5, "hash": "CoherentAdditive"}
BATCH = 2**18


def _event_ms(fn, iters=20, reps=7):
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def times(seed: int = 5) -> dict:
    import torch

    from ..encodings import create_encoding
    from ..ops import grid_encode as ge
    from ..utils.sampling import stratified_uniform

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for name, cfg, d in (("flagship", FLAGSHIP, 2), ("3D model", MODEL_3D, 3)):
        enc = create_encoding(d, cfg, alignment=16)
        enc.output_dtype = torch.bfloat16
        params = torch.rand((enc.n_params,), generator=gen, device=dev) * 2 - 1
        dy = torch.randn((BATCH, enc.padded_output_width), generator=gen, device=dev).bfloat16()
        points = {"uniform": torch.rand((BATCH, d), generator=gen, device=dev)}
        if d == 2:
            points["stratified"] = stratified_uniform(BATCH, 2, gen, device=dev)
        levels = enc._levels_on(dev)
        classes = torch.from_numpy(enc.gradient_classes(BATCH)).to(dev)
        plan = ge.backward_plan(enc.level_table(), enc.n_features_per_level, BATCH, classes)
        for label, x in points.items():
            with torch.no_grad():
                out[f"{name} {label} lookup"] = _event_ms(lambda: enc.apply(params, x))
                out[f"{name} {label} table gradient"] = _event_ms(
                    lambda: ge.grid_backward(x, dy, levels, enc.n_features_per_level, ge.INTERP_LINEAR, classes, plan))
    return out


def _kernel(readable: str) -> str:
    """A demangled kernel name without its return type and parameters."""
    name = readable.replace("void ", "", 1).replace("<unnamed>::", "")
    return name.split(">(")[0] + ">" if ">(" in name else name.split("(")[0]


def ptxas() -> dict:
    """Builds grid_fwd and grid_bwd together (unless built) and reads each
    kernel's registers and spills from the compiler's report."""
    from concurrent.futures import ThreadPoolExecutor

    from ..ops import _build
    from .grid_second_order_times import demangle, parse_ptxas

    def build(name):
        t0 = time.perf_counter()
        path = _build.build_library(name)
        return path, time.perf_counter() - t0

    with ThreadPoolExecutor(2) as pool:
        built = dict(zip(("grid_fwd", "grid_bwd"), pool.map(build, ("grid_fwd", "grid_bwd"))))
    out = {}
    for name, (path, seconds) in built.items():
        report = parse_ptxas(path.with_suffix(".log").read_text())
        readable = demangle(report)
        out[name] = {"build_s": seconds, "kernels": {
            _kernel(readable[fn]): [r["registers"], r["spill_stores"], r["spill_loads"]] for fn, r in report.items()}}
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ptxas", action="store_true", help="also the build seconds, registers and spills")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("grid_ab_times: needs a CUDA device")
    result = {"ptxas": ptxas() if args.ptxas else None}
    result["times"] = times()
    result["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
