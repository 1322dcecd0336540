"""The probe kernels furthest from their bounds, at the shapes of
``benchmarks.probe_rows``, on the card: P11 (``probe_gather_dot``), P13
(``probe_gather`` TILE_SUM), P14 (``probe_scatter`` STORE_LAST), P17 (the
transposed, feature-major gather at S2 = 2^10 and 2^15), P2's SHARED
gather, P6 / P7 (L2, 1 / 8 rows a thread), P8 / P9 (ASYNC, 16 / 64 rows in
flight), P18 (SHARED, bf16), P10 /
P15 (WINDOW, aligned), P12 (COPY) and P16 (ROW over two tables).

The inputs are the probe run's own (``benchmarks.probe_rows.build_cases``
at its defaults: B = 2^17 indices into an (S = 2^15, F = 8) table, numpy
seed 0; P11's w (8, 128); P2 at S = 2^12). Each kernel is first checked
against its plain version (P11 within ``DOT_TOL`` of max |plain|, the rest
bitwise), then timed:

- device ms: the kernel's own duration under torch.profiler, the mean
  over its launches in ``--calls`` back-to-back calls (``kernel_ms``;
  ``profiled_calls``: the launches the profiler recorded), and every device
  activity of a call (``call_device_ms``: an output's fill too;
  ``by_kernel``: each activity's ms a call by name);
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
- P17's random-sector floor: what B x F scalar reads from L2 take at the
  card's random-row rate (``sector_ns``: the ns a row of the sweep's L2
  gather of 2^24 rows of F = 2, one 32-byte sector a row, from a 2^15-row
  table, by CUDA events over back-to-back calls);
- P11's two-call yardstick, as information: ``torch.index_select`` of the
  rows, then ``torch.matmul`` with w in fp32 (``library_device_ms``: both
  calls' device time under the profiler);
- the L2 route's yardstick of P2, P18, P8 and P9, as information: the same
  ROW gather through ``gather_rows_l2`` (``probe_gather`` from L2) on the
  same inputs, its output bitwise the probe's, its kernel's device time
  under the profiler (``l2_kernel_ms``).

``--save PATH`` writes the SHA-256 of every output's bytes (JSON; P11's
output alone is 64 MiB); ``--compare PATH`` holds them bit for bit against
such a file. ``--ptxas`` adds the
``probe_rows`` library's registers and spills. Only the package's public
wrappers and ``probe_rows``' cases are used, so the script runs from the root
of a checkout of an earlier commit too (copy it into that checkout's
``tcnn_tpu_torch/benchmarks/``): that is how a change and its parent are
compared in one call, in turns.

``--plane-sweep`` adds P17 through every layout of the plane-staged route
(``plane_sweep``; a checkout that has the route).

Usage: python -m tcnn_tpu_torch.benchmarks.probe_times [--calls 200]
       [--reps 50] [--save PATH] [--compare PATH] [--ptxas] [--only KEYS]
       [--plane-sweep]

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
# Profiles of one function taken before giving up when none records its
# kernels (late in a long process the profiler may record none).
PROFILE_ATTEMPTS = 3
# The probes timed: key -> (the probe's name in ``probe_rows``, a part of
# the case's label that picks it, a part of its kernels' names under the
# profiler; the names of both the earlier kernels and these hold it).
PROBES = {
    "P11": ("fused_dot", "", "gather_dot"),
    "P13": ("load_only", "", "gather_tile_sum"),
    "P14": ("store_only", "", "store_last"),
    "P17 S2=2^10": ("dyngather_sel", "S2^10 ", "gather"),
    "P17 S2=2^15": ("dyngather_sel", "S2^15 ", "gather"),
    "P2 S=2^12": ("brk", "S=4096", "gather_rows_shared"),
    "P6": ("sp_serial", "", "gather_rows_l2"),
    "P7": ("sp_unroll8", "", "gather_rows_l2"),
    "P8": ("bs_dma_k", "", "gather_rows_async"),
    "P9": ("manual_dma", "", "gather_rows_async"),
    "P18": ("onehot_mxu", "", "gather_rows"),
    "P10": ("ds8", "", "gather_rows_l2"),
    "P15": ("ds8_aligned", "", "gather_rows_l2"),
    "P12": ("static_copy", "", "gather_rows_l2"),
    "P16": ("two_stream", "", "gather_rows_l2"),
}


def row_inputs(dev, key):
    """(table, idx, flags) of the ROW gather of probe ``key`` (P2 S=2^12,
    P18, P8, P9) as ``probe_rows`` draws them at its defaults: P2's from the
    generator of seed 0 that first draws P1-P4's S = 4,096 table and its
    2^18 indices; P8's and P9's the (2^15, 8) table and 2^17 indices of a
    second generator of seed 0, P18's that table's first 1,024 rows, its
    indices mod 1,024, rounded to bf16."""
    import numpy as np
    import torch

    from ..ops import probe_rows as pr

    r = np.random.default_rng(0)
    if key.startswith("P2"):
        table = r.normal(size=(4096, 8)).astype(np.float32)
        idx = r.integers(0, 4096, 2**18).astype(np.int32)
        return torch.from_numpy(table).to(dev), torch.from_numpy(idx).to(dev), 0
    table = torch.from_numpy(r.standard_normal((2**15, 8)).astype(np.float32)).to(dev)
    idx = torch.from_numpy(r.integers(0, 2**15, (2**17,)).astype(np.int32)).to(dev)
    if key == "P18":
        return table[:1024].contiguous(), idx % 1024, pr.FLAG_ROUND_BF16
    return table, idx, 0


# The probes with an L2 route yardstick (row_inputs).
ROW_PROBES = ("P2 S=2^12", "P18", "P8", "P9")


def probe_cases(dev, keys=None):
    """{key of PROBES: Case}: ``probe_rows``' cases at its defaults."""
    from . import probe_rows as drv

    keys = list(PROBES) if keys is None else list(keys)
    names = sorted({PROBES[k][0] for k in keys})
    cases = drv.build_cases(drv.build_parser().parse_args(["--only", ",".join(names)]), dev)
    out = {}
    for k in keys:
        name, part, _ = PROBES[k]
        out[k] = next(c for c in cases if c.name == name and part in c.label)
    return out


def sector_ns(dev, calls: int = 20) -> float:
    """Device ns a row of the sweep's L2 gather of 2^24 uniform rows of
    F = 2 (8 bytes: one 32-byte sector a row) from a 2^15-row table: the
    card's random-sector rate from L2. CUDA events over ``calls``
    back-to-back calls, median of 7: a call lasts ~0.1 ms, so the host's
    launches hide behind the device (and no profiler is needed, which late
    in a long process records only some launches, or none)."""
    from . import probe_rows as drv
    from .grid_ab_times import _event_ms

    case = next(c for c in drv.sweep_cases(dev, log_bs=(24,), sizes=(15,), feats=(2,), model_rows=())
                if c.label.startswith("gather") and c.source == "l2")
    drv.check_case(case)
    return _event_ms(case.run, calls) * 1e6 / case.rows


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


def _profiled(fn, calls, marker, by_kernel=None):
    """(the marker's kernels' device ms a call, every device activity's ms
    a call, the marker's kernel launches the profiler recorded) over
    ``calls`` back-to-back calls under torch.profiler. A call's time is the
    sum over kernel names of each name's mean duration times its launches a
    call (its recorded launches over the marker's, rounded: two fills of a
    call share a name), so a profile that records only some of the launches
    still gives a call's time; a profile that records none of the marker's
    is taken again, up to PROFILE_ATTEMPTS times. ``by_kernel``, a dict, receives each device
    activity's ms a call by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
                total, n = by_name.get(e.name, (0.0, 0))
                by_name[e.name] = (total + (e.time_range.end - e.time_range.start) / 1e3, n + 1)
        own = [name for name in by_name if marker in name]
        if own:
            break
    else:
        raise RuntimeError(f"probe_times: {PROFILE_ATTEMPTS} profiles recorded no kernel named like {marker!r}")
    recorded = min(by_name[n][1] for n in own)
    a_call = {name: total / n * max(1, round(n / recorded)) for name, (total, n) in by_name.items()}
    if by_kernel is not None:
        by_kernel.update(a_call)
    return sum(a_call[n] for n in own), sum(a_call.values()), recorded


def times(calls: int = 200, reps: int = 50, keys=None) -> dict:
    """{key of PROBES: {...}, "event_floor_ms", "sector_ns", "outputs"}:
    each kernel checked against its plain version, then its times and
    bounds (see the module's docstring); "outputs" the kernels' outputs on
    the card. ``keys``: the probes to time (default all)."""
    import torch

    from ..ops import probe_rows as pr
    from . import probe_rows as drv
    from .grid_ab_times import _event_ms

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = probe_cases(dev, keys)
    out, outputs = {}, {}
    with torch.no_grad():
        for p, case in cases.items():
            err = drv.check_case(case)
            outputs[p] = case.run()
            by_kernel = {}
            kernel_ms, call_device_ms, recorded = _profiled(case.run, calls, PROBES[p][2], by_kernel)
            b_ms, by = drv.bound_ms(case.n_bytes, case.n_ops)
            rec = {"label": case.label, "source": case.source, "max_abs_err": err, "kernel_ms": kernel_ms,
                   "call_device_ms": call_device_ms, "profiled_calls": recorded, "by_kernel": by_kernel,
                   "event_ms": drv.device_ms(case.run, dev, reps), "call_ms": _event_ms(case.run, 10),
                   "plain_ms": _event_ms(case.plain, 3, 3), "bound_ms": b_ms, "bound_by": by,
                   "n_bytes": case.n_bytes, "shape": {k: case.shape[k] for k in ("B", "S", "F")}}
            rec["bound_share"] = b_ms / kernel_ms
            out[p] = rec
        if "P13" in out:
            p13 = out["P13"]
            p13["sm_clock_mhz"] = sm_clock_mhz(cases["P13"].run)
            p13["order_bound_ms"] = pr.TILE * FADD_CYCLES / (p13["sm_clock_mhz"] * 1e6) * 1e3
        p17 = [p for p in out if p.startswith("P17")]
        if p17:
            out["sector_ns"] = sector_ns(dev)
            for p in p17:
                shape = out[p]["shape"]
                out[p]["sector_floor_ms"] = shape["B"] * shape["F"] * out["sector_ns"] * 1e-6
        for p in ROW_PROBES:
            if p not in out:
                continue
            table, idx, flags = row_inputs(dev, p)
            l2 = lambda t=table, i=idx, f=flags: pr.probe_gather(t, i, flags=f)  # noqa: E731
            if not torch.equal(l2(), outputs[p]):
                raise AssertionError(f"probe_times: the L2 route on row_inputs differs from {p}'s output")
            out[p]["l2_kernel_ms"] = _profiled(l2, calls, "gather_rows_l2")[0]
        if "P11" in out:
            table, idx, w = dot_inputs(dev)
            if not torch.equal(pr.probe_gather_dot(table, idx, w), outputs["P11"]):
                raise AssertionError("probe_times: dot_inputs are not probe_rows' P11 inputs")
            lib = lambda: torch.matmul(torch.index_select(table, 0, idx), w)  # noqa: E731
            if not bool(((lib() - outputs["P11"]).abs() <= drv.DOT_TOL * outputs["P11"].abs().max()).all()):
                raise AssertionError("probe_times: index_select then matmul disagrees with P11")
            lib_dev = _profiled(lib, calls, "")[1]  # each of its kernels once a call
            out["P11"].update(library="index_select + matmul", library_device_ms=lib_dev,
                              library_call_ms=_event_ms(lib, 10))
    out["event_floor_ms"] = drv.device_ms(lambda: torch.cuda._sleep(1), dev, reps)
    out["outputs"] = outputs
    return out


def plane_sweep(calls: int = 100, runs=(4, 8, 16, 33, 66, 132, 264)) -> list:
    """P17's two cases through the plane-staged route at every number of
    planes that divides F and fits a block and each count of sample runs in
    ``runs``: [{"S2", "planes", "runs", "grid", "kernel_ms", "bytes"}], each
    layout's output checked bitwise against the plain version first (the
    plan's own layout is the one ``probe_gather`` takes). Needs a checkout
    that has the route."""
    import torch

    from ..ops import probe_rows as pr

    dev = torch.device("cuda")
    n_sms = pr.sm_count(0)
    out = []
    with torch.no_grad():
        for key in ("P17 S2=2^10", "P17 S2=2^15"):
            case = probe_cases(dev, [key])[key]
            B, S, F = case.shape["B"], case.shape["S"], case.shape["F"]
            table, idx = p17_inputs(dev, S.bit_length() - 1)
            want = case.plain()
            if not torch.equal(pr.probe_gather_plain(table, idx, flags=pr.FLAG_TRANSPOSED | pr.FLAG_FEATURE_MAJOR), want):
                raise AssertionError("plane_sweep: p17_inputs are not probe_rows' P17 inputs")
            for planes in [p for p in range(1, F + 1) if F % p == 0 and pr.fits_shared(p * S)]:
                for n_runs in runs:
                    plan = pr.gather_plan(B, S, F, pr.MODE_ROW, pr.SOURCE_L2, pr.FLAG_TRANSPOSED | pr.FLAG_FEATURE_MAJOR,
                                          16, 16, n_sms, planes=planes, runs=n_runs)
                    res = torch.empty_like(want)

                    def run(plan=plan, res=res):
                        err = pr.kernel("probe_rows", "tcnn_probe_gather", pr._GATHER_ARGS)(
                            table.data_ptr(), None, idx.data_ptr(), res.data_ptr(), plan.args_ptr, pr.stream(0))
                        if err:
                            raise RuntimeError(f"plane_sweep: cudaError {err}")
                        return res

                    if not torch.equal(run(), want):
                        raise AssertionError(f"plane_sweep: {key} planes {planes} runs {n_runs} differs from plain")
                    out.append({"S2": S, "planes": planes, "runs": plan.runs, "grid": plan.grid,
                                "kernel_ms": _profiled(run, calls, "gather_planes")[0],
                                "bytes": pr.plane_bytes(B, S, F, planes, plan.runs)})
    return out


def p17_inputs(dev, log_s2: int, log_b: int = 17, log_s: int = 15, F: int = 8):
    """P17's (transposed table (F, S2), indices) as ``probe_rows`` draws
    them at its defaults: one numpy generator of seed 0, the (S, F) table,
    the indices; the table's first S2 rows transposed, the indices mod S2."""
    import numpy as np
    import torch

    r = np.random.default_rng(0)
    table = torch.from_numpy(r.standard_normal((1 << log_s, F)).astype(np.float32)).to(dev)
    idx = torch.from_numpy(r.integers(0, 1 << log_s, (1 << log_b,)).astype(np.int32)).to(dev)
    return table[: 1 << log_s2].t().contiguous(), idx % (1 << log_s2)


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


def digests(outputs: dict) -> dict:
    """{key: the SHA-256 of the output's bytes, its dtype and shape}."""
    import hashlib

    return {p: hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest() + f" {t.dtype} {tuple(t.shape)}"
            for p, t in outputs.items()}


def compare(outputs: dict, path: str) -> dict:
    """{key: True where ``outputs[key]`` equals the saved output bit for
    bit} over the keys both hold."""
    with open(path) as f:
        saved = json.load(f)
    return {p: d == saved[p] for p, d in digests(outputs).items() if p in saved}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--calls", type=int, default=200, help="back-to-back calls under the profiler")
    parser.add_argument("--reps", type=int, default=50, help="calls behind a spin kernel for the event times")
    parser.add_argument("--save", default=None, help="write the outputs to this file")
    parser.add_argument("--compare", default=None, help="hold the outputs bit for bit against this file")
    parser.add_argument("--only", default=None, help="comma-separated keys of PROBES (default all)")
    parser.add_argument("--ptxas", action="store_true", help="also the library's registers and spills")
    parser.add_argument("--plane-sweep", action="store_true", help="also P17's plane-staged layouts (plane_sweep)")
    args = parser.parse_args(argv)
    import torch

    from . import card_label

    if not torch.cuda.is_available():
        raise SystemExit("probe_times: needs a CUDA device")
    result = times(args.calls, args.reps, args.only.split(",") if args.only else None)
    outputs = result.pop("outputs")
    if args.save:
        with open(args.save, "w") as f:
            json.dump(digests(outputs), f)
    result["bitwise_as_saved"] = compare(outputs, args.compare) if args.compare else None
    result["device"] = card_label(torch.device("cuda"))
    result["ptxas"] = ptxas() if args.ptxas else None
    if args.plane_sweep:
        result["plane_sweep"] = plane_sweep()
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
