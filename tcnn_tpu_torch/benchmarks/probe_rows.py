"""Random row gather and scatter-add probes on the card.

The port of the JAX package's TPU probes (``benchmarks/probe_mosaic_gather.py``,
``probe_mosaic_gather2.py``, ``probe_r5_pallas_gather2.py``,
``probe_r5_pallas_gather3.py``, ``archive/probe_fk_bisect.py``): the same
functions (P1-P19) at the probes' default shapes, through the kernels of
``ops.probe_rows`` (and ``ops.scatter_rows`` for P19). Each variant is first
checked against its plain version, then timed; one line per variant in the
probes' form and one JSON line at the end. ``--sweep`` adds the gather and
the scatter-add at the grid's row widths (F = 2 and 8) over table sizes
S = 2^12, 2^15, 2^19 and 2^23 (64 MB at F = 2, beyond the 50 MB L2) for
every source, with the library calls beside them, and at the 3D model's
own table (6,522,408 rows of F = 2, 52 MB).

Usage: python -m tcnn_tpu_torch.benchmarks.probe_rows [--log-b 17]
       [--log-s 15] [--feat 8] [--reps 20] [--only sp_serial,ds8]
       [--sweep] [--device cuda]

Each line gives the kernel's call time (CUDA events over 3 blocks of
``--reps`` back-to-back calls, median: the larger of the host's time a call
and the device's), its plain version's, that of one PyTorch call computing
the same function where there is one (``index_select`` for a row gather,
``torch.gather`` for the per-lane gather, ``repeat`` for the static copy,
``index_add_`` for a scatter-add: the JAX probes' XLA reference points) and
the bound: the larger of the bytes this run's data needs (the indices read,
each distinct table element read, the output written, once each) over the
H100's 3.35 TB/s and the operations over its fp32 peak of 67 TFLOP/s
(NVIDIA's data sheet, SXM). On the card every line also gives the device
time a call of the kernel and of the library call (``device_ms``: CUDA
events around one call queued behind a spin kernel, so the host's time to
launch it is hidden; median of ``--reps``), which says whether a loss is the
host's or the device's: a call time of a few tens of microseconds is the
wrapper's host time. On the card the JSON also carries ``host_us``: the
host's microseconds a whole call at P5 C1's size, the wrapper beside
``torch.gather``.

Tolerances of the checks: every gather, the tile sum, the copy and
STORE_LAST bit-exact; ADD within 1e-6 of the sum of |contributions| per
entry (fp32 atomics add in any order); the gather-dot within 1e-5 of the
largest |plain| (fp32 products summed in another order than the matmul's).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from ..ops import probe_rows as pr
from ..ops import scatter_rows as sr
from . import bench_device, card_label, sync, timed_blocks

# The probes' own names, in P order (P1-P19).
NAMES = (
    "take", "brk", "rmw", "onehot", "take_along", "sp_serial", "sp_unroll8", "bs_dma_k", "manual_dma", "ds8",
    "fused_dot", "static_copy", "load_only", "store_only", "ds8_aligned", "two_stream", "dyngather_sel",
    "onehot_mxu", "fk_scatter",
)
ADD_TOL = 1e-6
DOT_TOL = 1e-5
# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM bytes/s and
# fp32 operations/s outside the tensor cores.
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12


@dataclass
class Case:
    """One probe variant: the kernel call, its plain version and how they
    compare."""

    name: str  # the probe's own name (NAMES), or "sweep"
    p: str  # P1 ... P19, or "sweep"
    label: str
    run: Callable[[], torch.Tensor]
    plain: Callable[[], torch.Tensor]
    rows: int  # rows of the call, for ns/row
    kernel: str  # probe_gather / probe_scatter / probe_gather_dot / scatter_rows
    n_bytes: int  # what this run's data needs: indices, distinct table elements, output
    n_ops: int = 0  # fp32 operations
    library: Optional[Callable[[], torch.Tensor]] = None  # one PyTorch call computing the same
    library_name: str = ""  # "": no single PyTorch call computes the same (PERF.md §6 says why)
    source: str = "l2"
    check: str = "exact"  # exact | add | dot
    abs_sum: Optional[Callable[[], torch.Tensor]] = None  # ADD: the sum of |contributions| per entry
    shape: dict = field(default_factory=dict)


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log-b", type=int, default=17)
    ap.add_argument("--log-s", type=int, default=15)
    ap.add_argument("--feat", type=int, default=8)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", default=None, help="comma-separated probe names: " + ",".join(NAMES))
    ap.add_argument("--sweep", action="store_true", help="also the grid-width sweep over S and sources")
    ap.add_argument("--device", default="cuda")
    return ap


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _distinct(v: torch.Tensor) -> int:
    return int(torch.unique(v).numel())


def _gather_bytes(table, idx, mode, flags, table2) -> int:
    """Bytes a gather needs from this run's data: the indices it reads, each
    distinct table element it reads and its output, once each."""
    S, F = (table.shape[1], table.shape[0]) if flags & pr.FLAG_TRANSPOSED else table.shape
    B = idx.shape[0]
    valid = idx[(idx >= 0) & (idx < S)]
    if mode == pr.MODE_LANE:
        lanes = torch.arange(F, device=idx.device)
        n_in, n_out = idx.numel() + _distinct(idx.long() * F + lanes), idx.numel()
    elif mode == pr.MODE_COPY:
        n_in, n_out = min(B, pr.TILE) * F, B * F
    elif mode == pr.MODE_WINDOW:
        start = idx[::8] & ~7 if flags & pr.FLAG_ALIGNED else idx[::8]
        rows = (start[:, None] + torch.arange(8, device=idx.device, dtype=idx.dtype)).reshape(-1)
        n_in, n_out = B // 8 + _distinct(rows[(rows >= 0) & (rows < S)]) * F, B * F
    elif mode == pr.MODE_TILE_SUM:
        n_in, n_out = B + _distinct(valid) * F, B // pr.TILE * 8 * F
    elif table2 is not None:
        n_in, n_out = B + (_distinct(idx[0::2]) + _distinct(idx[1::2])) * F, B * F
    else:
        n_in, n_out = B + _distinct(valid) * F, B * F
    return 4 * (n_in + n_out)


def _gather_case(name, p, label, table, idx, dev, source=pr.SOURCE_L2, **kw):
    """A probe_gather case; its plain version takes the same arguments. The
    library call: ``index_select`` for a plain row gather in range,
    ``torch.gather`` for the per-lane one, ``repeat`` of the first tile for
    the static copy."""
    plain_kw = {k: v for k, v in kw.items() if k in ("mode", "table2", "flags")}
    mode, flags = kw.get("mode", pr.MODE_ROW), kw.get("flags", 0)
    S = table.shape[1] if flags & pr.FLAG_TRANSPOSED else table.shape[0]
    library, library_name = None, ""
    if mode == pr.MODE_ROW and not flags and kw.get("table2") is None and bool(((idx >= 0) & (idx < S)).all()):
        library, library_name = (lambda: torch.index_select(table, 0, idx)), "index_select"
    elif mode == pr.MODE_LANE:
        idx64 = idx.long()
        library, library_name = (lambda: torch.gather(table, 0, idx64)), "torch.gather"
    elif mode == pr.MODE_COPY and not flags:
        n_tiles = idx.shape[0] // pr.TILE
        library, library_name = (lambda: table[:pr.TILE].repeat(n_tiles, 1)), "repeat"
    return Case(
        name, p, label,
        run=lambda: pr.probe_gather(table, idx, source=source, **kw),
        plain=lambda: pr.probe_gather_plain(table, idx, **plain_kw),
        rows=idx.numel(), kernel="probe_gather",
        n_bytes=_gather_bytes(table, idx, mode, flags, kw.get("table2")),
        library=library, library_name=library_name,
        source=pr.SOURCE_NAMES[source] + (f" x{kw['unroll']}" if kw.get("unroll") is not None else "")
        + (f" {kw['in_flight']} in flight" if source == pr.SOURCE_ASYNC else ""),
        shape={"S": S, "F": table.shape[0] if flags & pr.FLAG_TRANSPOSED else table.shape[1], "B": idx.shape[0],
               "touched": _distinct(idx)},
    )


def _add_case(name, p, label, idx, rows, size, kernel="probe_scatter", acc=pr.ACC_GLOBAL, contrib=sr.CONTRIB_NONE):
    """A scatter-add case; the library call is ``index_add_`` into zeros
    where the contributions are not rounded."""
    if kernel == "scatter_rows":
        run = lambda: sr.scatter_rows(idx, rows, size, contrib)  # noqa: E731
        plain = lambda: sr.scatter_rows_plain(idx, rows, size, contrib)  # noqa: E731
        source = "global (K5/K6 classes)"
    else:
        run = lambda: pr.probe_scatter(idx, rows, size, pr.OP_ADD, acc)  # noqa: E731
        plain = lambda: pr.probe_scatter_plain(idx, rows, size, pr.OP_ADD)  # noqa: E731
        source = "shared" if acc == pr.ACC_SHARED else "global"
    B, R = rows.shape
    library = None
    if contrib == sr.CONTRIB_NONE:
        def library():
            return torch.zeros((size, R), device=rows.device).index_add_(0, idx, rows)
    return Case(name, p, label, run, plain, rows=B, kernel=kernel, n_bytes=4 * (B + B * R + int(size) * R),
                n_ops=B * R, library=library, library_name="index_add_" if library else "", source=source,
                check="add",
                abs_sum=lambda: sr.scatter_rows_plain(idx, rows.abs(), size, contrib),
                shape={"S": int(size), "F": R, "B": B, "touched": _distinct(idx)})


def _shared_or_l2(S, F):
    return pr.SOURCE_SHARED if pr.fits_shared(S * F) else pr.SOURCE_L2


def build_cases(args, dev) -> List[Case]:
    """Every selected probe at its default shapes, on ``dev``; inputs from
    numpy seeds as in the probes."""
    want = set(args.only.split(",")) if args.only else None
    unknown = (want or set()) - set(NAMES)
    if unknown:
        raise SystemExit(f"probe_rows: unknown probes {sorted(unknown)}; choose from {', '.join(NAMES)}")

    def sel(name):
        return want is None or name in want

    cases: List[Case] = []
    # P1-P4 (probe_mosaic_gather.py:199-211): S in {4096, 32768}, F = 8, B = 2^18.
    r = np.random.default_rng(0)
    for S in (4096, 32768):
        table = _t(r.normal(size=(S, 8)).astype(np.float32), dev)
        idx = _t(r.integers(0, S, 2**18).astype(np.int32), dev)
        rows = _t(r.normal(size=(2**18, 8)).astype(np.float32), dev)
        if sel("take"):
            cases.append(_gather_case("take", "P1", f"P1 take S={S}", table, idx, dev))
        if sel("brk"):
            cases.append(_gather_case("brk", "P2", f"P2 brk S={S}", table, idx, dev, _shared_or_l2(S, 8)))
        if sel("rmw"):
            cases.append(_add_case("rmw", "P3", f"P3 rmw S={S}", idx, rows, S))
            if pr.fits_shared(S * 8):
                cases.append(_add_case("rmw", "P3", f"P3 rmw S={S}", idx, rows, S, acc=pr.ACC_SHARED))
            cases.append(_add_case("rmw", "P3", f"P3 rmw S={S} (K6 scatter_rows)", idx, rows, S, "scatter_rows"))
        if sel("onehot"):
            cases.append(_gather_case("onehot", "P4", f"P4 onehot S={S}", table, idx, dev))
    # P5 (probe_mosaic_gather2.py:73-81): take_along_axis, per lane or by row.
    if sel("take_along"):
        r = np.random.default_rng(0)
        for tag, S, R, B, per_lane in (("C1", 8, 128, 8, True), ("C2", 256, 128, 256, True),
                                       ("A1", 32768, 8, 2**18, False), ("A2", 4096, 8, 2**18, False),
                                       ("A3", 32768, 128, 2**15, True)):
            table = _t(r.normal(size=(S, R)).astype(np.float32), dev)
            if per_lane:
                idx = _t(r.integers(0, S, (B, R)).astype(np.int32), dev)
                cases.append(_gather_case("take_along", "P5", f"P5 {tag} table({S},{R}) per-lane", table, idx, dev,
                                          mode=pr.MODE_LANE))
            else:
                idx = _t(r.integers(0, S, (B, 1)).astype(np.int32)[:, 0], dev)
                cases.append(_gather_case("take_along", "P5", f"P5 {tag} table({S},{R}) rows", table, idx, dev))
    # P6-P11 (probe_r5_pallas_gather2.py) and P12-P18 (probe_r5_pallas_gather3.py):
    # B = 2^log_b rows of F from an (S, F) table, S = 2^log_s.
    B, S, F = 1 << args.log_b, 1 << args.log_s, args.feat
    r = np.random.default_rng(0)
    table_np = r.standard_normal((S, F)).astype(np.float32)
    idx_np = r.integers(0, S, (B,)).astype(np.int32)
    table, idx = _t(table_np, dev), _t(idx_np, dev)
    shp = f"B=2^{args.log_b} S=2^{args.log_s} F={F}"
    if sel("sp_serial"):  # one row at a time: from L2, one row a thread
        src = _shared_or_l2(S, F)
        cases.append(_gather_case("sp_serial", "P6", f"V1p sp_serial {shp}", table, idx, dev, src,
                                  **({"unroll": 1} if src == pr.SOURCE_L2 else {})))
    if sel("sp_unroll8"):
        cases.append(_gather_case("sp_unroll8", "P7", f"V2p sp_unroll8 {shp}", table, idx, dev, unroll=8))
    if sel("bs_dma_k"):
        cases.append(_gather_case("bs_dma_k", "P8", f"V3p bs_dma_k16 {shp}", table, idx, dev, pr.SOURCE_ASYNC,
                                  in_flight=16))
    if sel("manual_dma"):
        cases.append(_gather_case("manual_dma", "P9", f"V4p manual_dma {shp}", table, idx, dev, pr.SOURCE_ASYNC,
                                  in_flight=64))
    if sel("ds8"):
        idx5 = torch.clamp(idx, max=S - 8)
        cases.append(_gather_case("ds8", "P10", f"V5 ds8_consecutive {shp}", table, idx5, dev, mode=pr.MODE_WINDOW))
    if sel("fused_dot"):
        w = _t(r.standard_normal((F, pr.DOT_COLS)).astype(np.float32), dev)
        cases.append(Case("fused_dot", "P11", f"V6 fused_dot {shp}", lambda: pr.probe_gather_dot(table, idx, w),
                          lambda: pr.probe_gather_dot_plain(table, idx, w), B, "probe_gather_dot",
                          n_bytes=4 * (B + _distinct(idx) * F + F * pr.DOT_COLS + B * pr.DOT_COLS),
                          n_ops=2 * B * F * pr.DOT_COLS, check="dot", shape={"S": S, "F": F, "B": B}))
    if sel("static_copy"):
        cases.append(_gather_case("static_copy", "P12", f"C0 static_copy {shp}", table, idx, dev, mode=pr.MODE_COPY))
    if sel("load_only"):
        cases.append(_gather_case("load_only", "P13", f"C1 load_only {shp}", table, idx, dev,
                                  mode=pr.MODE_TILE_SUM))
    if sel("store_only"):
        j = torch.arange(B, device=dev, dtype=torch.int32)
        slots = (j // pr.TILE) * pr.TILE + idx % pr.TILE
        src_rows = table[(j % pr.TILE).long()].contiguous()
        cases.append(Case("store_only", "P14", f"C2 store_only {shp}",
                          lambda: pr.probe_scatter(slots, src_rows, B, pr.OP_STORE_LAST),
                          lambda: pr.probe_scatter_plain(slots, src_rows, B, pr.OP_STORE_LAST), B, "probe_scatter",
                          n_bytes=4 * (B + _distinct(slots) * F + B * F), source="store_last",
                          shape={"S": B, "F": F, "B": B}))
    if sel("ds8_aligned"):
        cases.append(_gather_case("ds8_aligned", "P15", f"C3 ds8_aligned {shp}", table, idx, dev,
                                  mode=pr.MODE_WINDOW, flags=pr.FLAG_ALIGNED))
    if sel("two_stream"):
        table2 = table + 1.0
        cases.append(_gather_case("two_stream", "P16", f"C4 two_stream {shp}", table, idx, dev, table2=table2))
    if sel("dyngather_sel"):
        for log_s2 in (10, args.log_s):
            S2 = 1 << log_s2
            t_t = table[:S2].t().contiguous()
            idx2 = idx % S2
            cases.append(_gather_case("dyngather_sel", "P17", f"C5 dyngather_sel_S2^{log_s2} {shp}", t_t, idx2, dev,
                                      flags=pr.FLAG_TRANSPOSED | pr.FLAG_FEATURE_MAJOR))
    if sel("onehot_mxu"):
        t3 = table[:1024].contiguous()
        idx3 = idx % 1024
        cases.append(_gather_case("onehot_mxu", "P18", f"C6 onehot_mxu_S2^10 {shp}", t3, idx3, dev,
                                  _shared_or_l2(1024, F), flags=pr.FLAG_ROUND_BF16))
    # P19 (archive/probe_fk_bisect.py:24-68): per grid step (2 of 4 x 1024
    # rows) bf16-rounded rows of 8 scatter-added into a (1024 x 32, 8) table.
    if sel("fk_scatter"):
        r = np.random.default_rng(0)
        grid, nsub, sub, hi, lo, R = 2, 4, 1024, 1024, 32, 8
        idx3 = r.integers(0, hi * lo, (grid, nsub, sub))
        rows = _t(r.normal(size=(grid * nsub * sub, R)).astype(np.float32), dev)
        flat = _t((idx3 + np.arange(grid)[:, None, None] * hi * lo).reshape(-1).astype(np.int32), dev)
        cases.append(_add_case("fk_scatter", "P19", "fk_bisect strip scatter (RN class)", flat, rows,
                               grid * hi * lo, "scatter_rows", contrib=sr.CONTRIB_RN))
    return cases


# The 3D model's table (the root bench.py's --protocol 3d encoding,
# log2_hashmap_size 19: 13,044,816 values, F = 2, 52 MB, more than the L2):
# the rows its lookup, table gradient, G1 and G2 read and add into.
MODEL_3D_ROWS = 6_522_408


def sweep_cases(dev, log_bs=(18, 24), sizes=(12, 15, 19, 23), feats=(2, 8), seed: int = 0,
                model_rows=(MODEL_3D_ROWS,)) -> List[Case]:
    """The gather and the ADD scatter at the grid's row widths: B = 2^log_b
    uniform indices into (2^s, F) tables, every source, and the library
    calls (``index_select``, ``index_add_``) beside them; then the same at
    the largest B and F = 2 into each table of ``model_rows`` rows (the 3D
    model's own). At B = 2^18 a call lasts about as long as its launch; B = 2^24 is
    the row count of the flagship lookup (2^18 samples x 16 levels x 4
    corners)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    points = [(b, 1 << s, f) for b in log_bs for s in sizes for f in feats] + [(log_bs[-1], int(S), 2) for S in model_rows]
    cases = []
    for log_b, S, F in points:
        B = 1 << log_b
        table = torch.randn((S, F), generator=gen, device=dev)
        idx = torch.randint(0, S, (B,), generator=gen, device=dev, dtype=torch.int32)
        rows = torch.randn((B, F), generator=gen, device=dev)
        size = f"2^{S.bit_length() - 1}" if S & (S - 1) == 0 else str(S)
        tag = f"S={size} F={F} B=2^{log_b}"
        sources = [(pr.SOURCE_L2, {}), (pr.SOURCE_L2, {"unroll": 8}), (pr.SOURCE_ASYNC, {"in_flight": 64})]
        if pr.fits_shared(S * F):
            sources.append((pr.SOURCE_SHARED, {}))
        for source, kw in sources:
            cases.append(_gather_case("sweep", "sweep", f"gather {tag}", table, idx, dev, source, **kw))
        cases.append(_add_case("sweep", "sweep", f"scatter-add {tag}", idx, rows, S))
        if pr.fits_shared(S * F):
            cases.append(_add_case("sweep", "sweep", f"scatter-add {tag}", idx, rows, S, acc=pr.ACC_SHARED))
    return cases


def check_case(case: Case) -> float:
    """Kernel against plain; raises on a mismatch; returns max |diff|."""
    got, want = case.run(), case.plain()
    if got.shape != want.shape:
        raise AssertionError(f"{case.label}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{case.label}: non-finite output")
    diff = (got - want).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if case.check == "exact":
        if not torch.equal(got, want):
            raise AssertionError(f"{case.label} [{case.source}]: not bit-exact (max|diff| {err:.3e})")
    elif case.check == "add":
        excess = float((diff - ADD_TOL * case.abs_sum()).max())
        if excess > 0:
            raise AssertionError(f"{case.label} [{case.source}]: beyond {ADD_TOL} of sum|contrib| by {excess:.3e}")
    else:
        scale = float(want.abs().max())
        if err > DOT_TOL * scale:
            raise AssertionError(f"{case.label}: max|diff| {err:.3e} > {DOT_TOL} x {scale:.3e}")
    return err


def device_ms(fn, dev: torch.device, reps: int, pad_cycles: int = 1_000_000) -> float:
    """Device ms a call of ``fn``: the median over ``reps`` calls of CUDA
    events recorded just before and just after the call, each call queued
    behind a spin kernel of ``pad_cycles`` clock cycles
    (``torch.cuda._sleep``, about 0.5 ms) so that the host's time to issue
    the call is hidden; the events then time only the device's work (the
    call's kernels and memsets and the gaps between them)."""
    fn()
    sync(dev)
    events = []
    for _ in range(reps):
        torch.cuda._sleep(pad_cycles)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    sync(dev)
    return statistics.median(start.elapsed_time(end) for start, end in events)


def host_us(dev: torch.device, n: int = 2000) -> dict:
    """Host microseconds a call (host clock over ``n`` calls, no sync) of
    the wrapper and of ``torch.gather`` at P5 C1's size (8 rows x 128 lanes
    from an (8, 128) table), where the device work is a few microseconds."""
    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.randn((8, 128), generator=gen, device=dev)
    idx = torch.randint(0, 8, (8, 128), generator=gen, device=dev, dtype=torch.int32)
    idx64 = idx.long()
    calls = {
        "probe_gather LANE (8, 128)": lambda: pr.probe_gather(table, idx, mode=pr.MODE_LANE),
        "torch.gather (8, 128)": lambda: torch.gather(table, 0, idx64),
    }
    out = {}
    for name, fn in calls.items():
        for _ in range(50):
            fn()
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out[name] = (time.perf_counter() - t0) * 1e6 / n
        sync(dev)
    return out


def bound_ms(n_bytes: int, n_ops: int = 0):
    """(ms, "bytes" or "operations"): the larger of the bytes over the HBM
    rate and the fp32 operations over their peak."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_S * 1e3, n_ops / FP32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def run_cases(cases: List[Case], dev, reps: int, out=sys.stdout) -> List[dict]:
    """Check each case, then time the kernel, its plain version and the
    library call; one line each. Cases with one label (the sources of one
    sweep point) share one timing of the plain version and library call."""
    records, shared = [], {}
    for case in cases:
        err = check_case(case)
        ms, blocks = timed_blocks(case.run, dev, reps)
        timed_dev = dev.type == "cuda"
        dev_ms = device_ms(case.run, dev, reps) if timed_dev else None
        key = (case.kernel, case.label)
        if key not in shared:
            shared[key] = (timed_blocks(case.plain, dev, reps)[0],
                           None if case.library is None else timed_blocks(case.library, dev, reps)[0],
                           device_ms(case.library, dev, reps) if timed_dev and case.library is not None else None)
        plain_ms, library_ms, library_dev_ms = shared[key]
        b_ms, by = bound_ms(case.n_bytes, case.n_ops)
        print(f"{case.label}: {ms:.3f} ms = {ms * 1e6 / case.rows:.2f} ns/row (blocks "
              f"{[round(b, 3) for b in blocks]}) [{case.kernel}, {case.source}]; plain {plain_ms:.3f} ms"
              + ("" if library_ms is None else f", {case.library_name} {library_ms:.3f} ms")
              + ("" if dev_ms is None else f"; device ms a call: kernel {dev_ms:.4f}"
                 + ("" if library_dev_ms is None else f", {case.library_name} {library_dev_ms:.4f}"))
              + f", bound {b_ms:.4f} ms ({by}); matches plain, max|diff| {err:.3e}", file=out, flush=True)
        records.append({"name": case.name, "p": case.p, "label": case.label, "kernel": case.kernel,
                        "source": case.source, "rows": case.rows, "ms": ms, "ns_per_row": ms * 1e6 / case.rows,
                        "blocks": blocks, "plain_ms": plain_ms, "library": case.library_name or None,
                        "library_ms": library_ms, "device_ms": dev_ms, "library_device_ms": library_dev_ms,
                        "bound_ms": b_ms, "bound_by": by, "max_abs_err": err, **case.shape})
    return records


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = bench_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False  # the gather-dot's plain product in full fp32
    cases = build_cases(args, dev)
    if args.sweep:
        cases += sweep_cases(dev)
    records = run_cases(cases, dev, args.reps)
    sync(dev)
    result = {
        "device": card_label(dev),
        "probes": records,
        "host_us": host_us(dev) if dev.type == "cuda" else None,
        "launches": {"probe_gather": pr.GATHER_LAUNCHES, "probe_scatter": pr.SCATTER_LAUNCHES,
                     "probe_gather_dot": pr.DOT_LAUNCHES, "scatter_rows": sr.LAUNCHES},
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
