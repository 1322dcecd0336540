"""P11 (``probe_gather_dot``) and P13 (``probe_gather`` TILE_SUM) at the
shapes of ``benchmarks.probe_rows``, on the card.

The inputs are the probe run's own (``benchmarks.probe_rows.build_cases`` at
its defaults, B = 2^17 indices into an (S = 2^15, F = 8) table, numpy seed
0; P11's w (8, 128)). Each kernel is first checked against its plain
version (P11 within ``DOT_TOL`` of max |plain|, P13 bitwise), then timed:

- device ms: the kernel's own duration under torch.profiler, the mean
  over its launches in ``--calls`` back-to-back calls (``kernel_ms``;
  ``profiled_calls``: the launches the profiler recorded), and every device
  activity of a call (``call_device_ms``: an output's fill too);
- ``event_ms``: ``probe_rows.device_ms``, CUDA events around one call
  queued behind a spin kernel, as ``probe_rows`` records it (the events' own
  floor, ``event_floor_ms``, is the same around a one-cycle spin);
- ``call_ms``: CUDA events over 10 back-to-back calls, median of 7 (the
  host's time a call or the device's, the larger);
- the bytes bound: ``probe_rows``' bytes (indices, each distinct table
  element, w, the output, once each) over the H100's 3.35 TB/s;
- P13's order bound: its sum is a chain of TILE dependent fp32 adds a
  (tile, feature), all chains at once, so no schedule takes less than
  TILE x FADD_CYCLES cycles of the SM clock. ``sm_clock_mhz`` is what
  ``nvidia-smi --query-gpu=clocks.sm`` reads while P13 runs in a loop;
- P11's two-call yardstick, as information: ``torch.index_select`` of the
  rows, then ``torch.matmul`` with w in fp32 (``library_device_ms``: both
  calls' device time under the profiler).

``--save PATH`` writes both outputs (``torch.save``); ``--compare PATH``
holds them bit for bit against such a file. ``--ptxas`` adds the
``probe_rows`` library's registers and spills. Only the package's public
wrappers and ``probe_rows``' cases are used, so the script runs from the root
of a checkout of an earlier commit too (copy it into that checkout's
``tcnn_tpu_torch/benchmarks/``): that is how a change and its parent are
compared in one call, in turns.

Usage: python -m tcnn_tpu_torch.benchmarks.probe_times [--calls 200]
       [--reps 50] [--save PATH] [--compare PATH] [--ptxas]

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import threading

# Cycles of one dependent fp32 add on Hopper (the FADD pipeline's latency).
FADD_CYCLES = 4
# The profiler's kernel names of the two probes (the names of both the
# earlier kernels and these hold them).
MARKERS = {"P11": "gather_dot", "P13": "gather_tile_sum"}


def probe_cases(dev):
    """{"P11": Case, "P13": Case}: ``probe_rows``' cases at its defaults."""
    from . import probe_rows as drv

    args = drv.build_parser().parse_args(["--only", "fused_dot,load_only"])
    return {c.p: c for c in drv.build_cases(args, dev)}


def sm_clock_mhz(fn, seconds: float = 1.0, reads: int = 3) -> float:
    """The median of ``reads`` SM clocks (MHz) that nvidia-smi reads while
    another thread calls ``fn`` in a loop for about ``seconds``."""
    import time

    import torch

    stop = threading.Event()

    def loop():
        t0 = time.perf_counter()
        while not stop.is_set() and time.perf_counter() - t0 < seconds + 5:
            fn()
        torch.cuda.synchronize()

    worker = threading.Thread(target=loop)
    worker.start()
    values = []
    try:
        time.sleep(0.2)
        for _ in range(reads):
            out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                                 capture_output=True, text=True, check=True, timeout=60).stdout
            values.append(float(out.splitlines()[torch.cuda.current_device()].strip()))
            time.sleep(seconds / reads)
    finally:
        stop.set()
        worker.join()
    return statistics.median(values)


def _profiled(fn, calls, marker):
    """(the marker's kernels' device ms a call, every device activity's ms
    a call, the marker's kernel launches the profiler recorded) over
    ``calls`` back-to-back calls under torch.profiler. A call's time is the
    sum over kernel names of each name's mean duration (every probe call
    launches each of its kernels once), so a profile that records only
    some of the launches still gives a call's time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            total, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (total + (e.time_range.end - e.time_range.start) / 1e3, n + 1)
    mean = {name: total / n for name, (total, n) in by_name.items()}
    own = [name for name in mean if marker in name]
    if not own:
        raise RuntimeError(f"probe_times: the profiler recorded no kernel named like {marker!r}")
    return sum(mean[n] for n in own), sum(mean.values()), min(by_name[n][1] for n in own)


def times(calls: int = 200, reps: int = 50) -> dict:
    """{"P11" | "P13": {...}, "event_floor_ms", "outputs"}: each kernel
    checked against its plain version, then its times and bounds (see the
    module's docstring); "outputs" the two kernels' outputs on the card."""
    import torch

    from ..ops import probe_rows as pr
    from . import probe_rows as drv
    from .grid_ab_times import _event_ms

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = probe_cases(dev)
    out, outputs = {}, {}
    with torch.no_grad():
        for p, case in cases.items():
            err = drv.check_case(case)
            outputs[p] = case.run()
            kernel_ms, call_device_ms, recorded = _profiled(case.run, calls, MARKERS[p])
            b_ms, by = drv.bound_ms(case.n_bytes, case.n_ops)
            rec = {"label": case.label, "max_abs_err": err, "kernel_ms": kernel_ms, "call_device_ms": call_device_ms,
                   "profiled_calls": recorded, "event_ms": drv.device_ms(case.run, dev, reps), "call_ms": _event_ms(case.run, 10),
                   "plain_ms": _event_ms(case.plain, 3, 3), "bound_ms": b_ms, "bound_by": by,
                   "n_bytes": case.n_bytes, "shape": {k: case.shape[k] for k in ("B", "S", "F")}}
            rec["bound_share"] = b_ms / kernel_ms
            out[p] = rec
        p13 = out["P13"]
        p13["sm_clock_mhz"] = sm_clock_mhz(cases["P13"].run)
        p13["order_bound_ms"] = pr.TILE * FADD_CYCLES / (p13["sm_clock_mhz"] * 1e6) * 1e3
        table, idx, w = dot_inputs(dev)
        if not torch.equal(pr.probe_gather_dot(table, idx, w), outputs["P11"]):
            raise AssertionError("probe_times: dot_inputs are not probe_rows' P11 inputs")
        lib = lambda: torch.matmul(torch.index_select(table, 0, idx), w)  # noqa: E731
        if not bool(((lib() - outputs["P11"]).abs() <= drv.DOT_TOL * outputs["P11"].abs().max()).all()):
            raise AssertionError("probe_times: index_select then matmul disagrees with P11")
        lib_dev = _profiled(lib, calls, "")[1]  # each of its kernels once a call
        out["P11"].update(library="index_select + matmul", library_device_ms=lib_dev, library_call_ms=_event_ms(lib, 10))
    out["event_floor_ms"] = drv.device_ms(lambda: torch.cuda._sleep(1), dev, reps)
    out["outputs"] = outputs
    return out


def dot_inputs(dev, log_b: int = 17, log_s: int = 15, F: int = 8):
    """P11's (table, idx, w) as ``probe_rows`` draws them at its defaults: one
    numpy generator of seed 0, the table, the indices, then w."""
    import numpy as np
    import torch

    r = np.random.default_rng(0)
    table = r.standard_normal((1 << log_s, F)).astype(np.float32)
    idx = r.integers(0, 1 << log_s, (1 << log_b,)).astype(np.int32)
    w = r.standard_normal((F, 128)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev) for a in (table, idx, w))


def ptxas() -> dict:
    """{readable kernel name: [registers, spill store bytes, spill load
    bytes]} of the ``probe_rows`` library, built if it is not."""
    from ..ops import _build
    from .grid_ab_times import _kernel
    from .grid_second_order_times import demangle, parse_ptxas

    path = _build.build_library("probe_rows")
    report = parse_ptxas(path.with_suffix(".log").read_text())
    readable = demangle(report)
    return {_kernel(readable[fn]): [r["registers"], r["spill_stores"], r["spill_loads"]] for fn, r in report.items()}


def compare(outputs: dict, path: str) -> dict:
    """{"P11" | "P13": True where ``outputs`` equals the saved output bit for
    bit}."""
    import torch

    saved = torch.load(path)
    return {p: bool(torch.equal(outputs[p].cpu(), saved[p])) for p in outputs}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--calls", type=int, default=200, help="back-to-back calls under the profiler")
    parser.add_argument("--reps", type=int, default=50, help="calls behind a spin kernel for the event times")
    parser.add_argument("--save", default=None, help="write the two outputs to this file")
    parser.add_argument("--compare", default=None, help="hold the two outputs bit for bit against this file")
    parser.add_argument("--ptxas", action="store_true", help="also the library's registers and spills")
    args = parser.parse_args(argv)
    import torch

    from . import card_label

    if not torch.cuda.is_available():
        raise SystemExit("probe_times: needs a CUDA device")
    result = times(args.calls, args.reps)
    outputs = result.pop("outputs")
    if args.save:
        torch.save({p: t.cpu() for p, t in outputs.items()}, args.save)
    result["bitwise_as_saved"] = compare(outputs, args.compare) if args.compare else None
    result["device"] = card_label(torch.device("cuda"))
    result["ptxas"] = ptxas() if args.ptxas else None
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
