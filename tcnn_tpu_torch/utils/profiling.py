"""Profiling and timing helpers (port of ``tcnn_tpu.utils.profiling``).

The reference has no tracer: it times loops on the wall clock with device
synchronisations around them. ``sync`` and ``time_fn`` do that with
``torch.cuda.synchronize``; ``trace`` records a ``torch.profiler`` trace;
``profile_steps`` reads the device's busy time and idle share of a step
from the profiler's device activities.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch

from ..optimizers.base import tree_leaves


def sync(value) -> float:
    """Wait for the device of the first tensor leaf of ``value`` and return
    that leaf's first element as a float (on the CPU: only the read)."""
    leaf = next(t for t in tree_leaves(value) if isinstance(t, torch.Tensor))
    if leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)
    return float(leaf.detach().reshape(-1)[0].to(torch.float32))


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2) -> float:
    """Mean seconds per call of ``fn(*args)`` over ``iters`` calls, after
    ``warmup`` calls, synchronised by ``sync`` of the output at both ends."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    if out is not None:
        sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    sync(out)
    return (time.perf_counter() - t0) / iters


@contextlib.contextmanager
def trace(log_dir: str = "tcnn_tpu_torch_trace"):
    """Record the CPU activity, and the CUDA activity where a card is
    present, under ``torch.profiler``; on exit write a Chrome trace
    (``trace.json``, open it in Perfetto or chrome://tracing) into
    ``log_dir``. Yields ``log_dir``. A profiler that cannot start raises."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def profile_steps(step, n=10):
    """Device time of ``n`` back-to-back calls of ``step`` under
    torch.profiler: (wall ms, device-busy ms, idle share, [(kernel, ms)]
    per call, largest first). Busy time is the union of the device
    activities' intervals."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    spans, by_name = [], {}
    for e in prof.events():
        # Device activities only; a user annotation (e.g. Optimizer.step)
        # spans other kernels and the gaps between them.
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / n
    if not spans:
        raise RuntimeError("profile: the profiler recorded no device activity")
    busy, end = 0.0, -1.0
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    busy = busy / 1e3 / n
    return wall, busy, 1.0 - busy / wall, sorted(by_name.items(), key=lambda kv: -kv[1])
