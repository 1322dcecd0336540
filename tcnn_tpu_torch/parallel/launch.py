"""Runs a function on every rank of a process group on one host.

``run_ranks(fn, world_size, *args)`` starts ``world_size`` processes
(``torch.multiprocessing`` spawn), joins them to one process group through
a ``file://`` store in a temporary directory (no port to pick), calls
``fn(rank, world_size, *args)`` in each and returns the ranks' results in
rank order. A rank that raises makes ``run_ranks`` raise. ``fn`` must be a
module-level function, and its results picklable (``torch.save``). The
ranks build no CUDA kernel: call ``ops._build.build_libraries`` first, in
the parent, so that they load what it built.
"""

from __future__ import annotations

import os
import tempfile
from typing import Callable, List

import torch
import torch.distributed as dist


def _rank_main(rank: int, fn: Callable, world_size: int, backend: str, store: str, out_dir: str, args) -> None:
    # The host's cores shared out, so that the ranks' CPU work does not
    # oversubscribe them.
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank, world_size=world_size)
    try:
        result = fn(rank, world_size, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


def run_ranks(fn: Callable, world_size: int, *args, backend: str = "gloo", tmp_dir=None) -> List:
    """``fn(rank, world_size, *args)`` on ``world_size`` spawned ranks of a
    ``backend`` process group; their results in rank order."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(dir=tmp_dir) as d:
        store = os.path.join(d, "store")
        mp.spawn(_rank_main, args=(fn, world_size, backend, store, d, args), nprocs=world_size, join=True)
        return [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False) for r in range(world_size)]
