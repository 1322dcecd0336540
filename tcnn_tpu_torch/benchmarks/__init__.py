"""The port's benchmark entry points, each run as
``python -m tcnn_tpu_torch.benchmarks.<name>``: ``bench`` (the headline
image-fit protocols of the repo's ``bench.py``), ``bench_mlp``,
``bench_image``, ``probe_rows`` (the row gather and scatter probes),
``grid_bwd_plans`` (the table-gradient kernel's launch plans),
``lookup_scatter_times`` (the grid lookup and the row scatter at the main
path's shapes, against the earlier lookup kernel and ``index_add_``),
``grid_second_order_times`` (the grid's input gradient and double backward
at the SDF path's shapes, and the SDF step); ``ffmlp_adam_times``,
``grid_ab_times``, ``sh_times`` (the spherical-harmonics kernels' device
and call times at the NeRF path's shapes) and ``probe_times`` (the
redesigned probe kernels and the modes next in line at ``probe_rows``'
shapes, under the profiler beside their bounds) time kernels on the card
only; ``nerf_psnr_spread`` runs the NeRF sample many times a seed and counts
the runs under chip_smoke's per-run PSNR floor.
They run on the CUDA card (``--device cuda``, the default) and fail without
one; ``--device cpu`` (where an entry point takes it) runs the kernels'
plain versions, for tests only: its times are the CPU's. Nothing here runs at
import.

The helpers below are shared by the entry points.
"""

from __future__ import annotations

import statistics
import subprocess
import time

import torch


def bench_device(name: str) -> torch.device:
    """``name`` as a device; a CUDA device must exist (no CPU fallback)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError('tcnn_tpu_torch benchmarks: no CUDA device; pass --device cpu to run on the CPU')
    return dev


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def card_label(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them, or ``cpu``."""
    if dev.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip()
        return out.splitlines()[dev.index or 0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(dev)}, power limit not read"


def timed_blocks(fn, dev: torch.device, reps: int):
    """(median ms per call, [ms per call of each block]): 3 blocks of
    ``reps`` calls after one warm call; CUDA events on the card, the host
    clock on the CPU."""
    fn()
    sync(dev)
    blocks = []
    for _ in range(3):
        if dev.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            blocks.append(start.elapsed_time(end) / reps)
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            blocks.append((time.perf_counter() - t0) * 1e3 / reps)
    return statistics.median(blocks), blocks
