"""MLP inference and training throughput (the port of the repo's
``benchmarks/bench_mlp.py:23-141``; reference protocol:
benchmarks/mlp/bench_mlp_ours.cu:64-137).

Batch 2^20, input = output = hidden width in {16, 32, 64, 128}, 3 hidden
layers, ReLU, PCG32 init (seed 1337), standard-normal bf16 inputs. Per
width and method, inference and training (the gradient of sum(out) with
respect to the params) in elements/s, the median of 3 blocks of ``--iters``
calls after a warm call (CUDA events on the card). Methods:

- ``fully_fused``: ``FullyFusedMLP.apply`` (the K1 forward and K2 backward
  kernels);
- ``fully_fused_packed``: ``FullyFusedMLP.apply_packed`` on (B/G, 128) rows
  (K7/K8), widths below 128;
- ``mlp_chain``: the plain chain ``networks.mlp.MLP`` under torch autograd
  (the JAX script's ``xla`` method).

The JAX script's ``fully_fused_cf`` is a TPU layout and is skipped. One JSON
line per measurement; ``--out`` also writes them as a JSON list.

Usage: python -m tcnn_tpu_torch.benchmarks.bench_mlp [--batch 1048576]
       [--iters 30] [--widths 16 32 64 128] [--out FILE] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from ..networks import MLP, FullyFusedMLP
from ..rng import make_rng
from . import bench_device, card_label, timed_blocks

METHODS = ("fully_fused", "fully_fused_cf", "mlp_chain", "fully_fused_packed")


def bench_one(width: int, batch: int, iters: int, method: str, train: bool, dev):
    """(median elements/s, the blocks' elements/s in ascending order): 3
    blocks of ``iters`` calls (benchmarks/bench_mlp.py:83-107)."""
    cls = MLP if method == "mlp_chain" else FullyFusedMLP
    net = cls(input_width=width, output_width=width, n_neurons=width, n_hidden_layers=3)
    params = torch.from_numpy(net.initialize_params(make_rng(1337))).to(dev)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((batch, width)).astype(np.float32))
    if method == "fully_fused_packed":
        G = 128 // width
        x, apply = x.reshape(batch // G, G * width), net.apply_packed
    else:
        apply = net.apply
    x = x.to(dev).to(torch.bfloat16)
    if train:
        p = params.clone().requires_grad_(True)

        def fn():
            return torch.autograd.grad(apply(p, x).float().sum(), p)[0]
    else:
        def fn():
            with torch.no_grad():
                return apply(params, x)
    if not bool(torch.isfinite(fn().float()).all()):
        raise RuntimeError(f"bench_mlp: non-finite output (width {width}, {method})")
    _, blocks = timed_blocks(fn, dev, iters)
    per_s = sorted(batch / ms * 1e3 for ms in blocks)
    return per_s[len(per_s) // 2], per_s


def build_parser():
    ap = argparse.ArgumentParser(description="MLP inference/training throughput of the port.")
    ap.add_argument("--batch", type=int, default=2**20)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--widths", type=int, nargs="+", default=[16, 32, 64, 128])
    ap.add_argument("--out", default=None, help="also write the results here as a JSON list")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> list:
    args = build_parser().parse_args(argv)
    dev = bench_device(args.device)
    results = []
    for width in args.widths:
        methods = ["fully_fused", "fully_fused_cf", "mlp_chain"] + (["fully_fused_packed"] if width < 128 else [])
        for method in methods:
            if method == "fully_fused_cf":
                print(f"# width {width}: fully_fused_cf skipped (a TPU layout)", file=sys.stderr)
                continue
            for train in (False, True):
                tput, blocks = bench_one(width, args.batch, args.iters, method, train, dev)
                entry = {
                    "width": width,
                    "method": method,
                    "mode": "training" if train else "inference",
                    "batch": args.batch,
                    "elements_per_second": round(tput, 1),
                    "blocks": [round(b, 1) for b in blocks],
                }
                print(json.dumps(entry), flush=True)
                results.append(entry)
    if args.out:
        Path(args.out).write_text(json.dumps(results, indent=2))
        print(f"# wrote {args.out}", file=sys.stderr)
    print(f"# card: {card_label(dev)}", file=sys.stderr)
    return results


if __name__ == "__main__":
    main()
