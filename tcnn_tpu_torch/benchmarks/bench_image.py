"""Image-fit throughput over a batch-size sweep (the port of the repo's
``benchmarks/bench_image.py:23-113``; reference protocol:
benchmarks/image/bench_ours.cu:188-223).

``CONFIG_ONEBLOB``: OneBlob with 64 bins + FullyFusedMLP 128 x 5,
RelativeL2, Adam 1e-2. For each batch 2^min_pow .. 2^max_pow: a fresh model,
one fixed batch of uniform positions (numpy seed 0) with the nearest pixel
of the sample's synthetic image (``samples.mlp_learning_an_image``) as
targets, ``--iters`` training steps and ``--iters`` inference calls after
one warm call each, timed on the host clock between synchronisations;
training and inference elements/s and the final loss (the returned entries
also carry the first step's loss). ``--baseline``
swaps in ``CutlassMLP`` (the port's plain chain ``networks.mlp.MLP``),
recorded as ``method: "mlp_chain"``; the kernels' runs are ``fully_fused``.
One JSON line per batch size; ``--out`` also writes them as a JSON list.

Usage: python -m tcnn_tpu_torch.benchmarks.bench_image [--min-pow 14]
       [--max-pow 21] [--iters 30] [--baseline] [--out FILE] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..config import create_from_config
from ..samples.mlp_learning_an_image import synthetic_image
from . import bench_device, card_label, sync

# The JAX script's keys of each JSON line (benchmarks/bench_image.py:102-108).
KEYS = ("batch", "training_elements_per_second", "inference_elements_per_second", "final_loss", "method")
CONFIG_ONEBLOB = {
    "loss": {"otype": "RelativeL2"},
    "optimizer": {"otype": "Adam", "learning_rate": 1e-2},
    # n_bins 64 as the reference's config_oneblob.json.
    "encoding": {"otype": "OneBlob", "n_bins": 64},
    "network": {
        "otype": "FullyFusedMLP",
        "activation": "ReLU",
        "output_activation": "None",
        "n_neurons": 128,
        "n_hidden_layers": 5,
    },
}


def build_parser():
    ap = argparse.ArgumentParser(description="Image-fit throughput of the port over a batch-size sweep.")
    ap.add_argument("--min-pow", type=int, default=14)
    ap.add_argument("--max-pow", type=int, default=21)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--baseline", action="store_true", help="the plain MLP chain instead of the fused kernels")
    ap.add_argument("--out", default=None, help="also write the results here as a JSON list")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> list:
    args = build_parser().parse_args(argv)
    dev = bench_device(args.device)
    config = json.loads(json.dumps(CONFIG_ONEBLOB))
    if args.baseline:
        config["network"]["otype"] = "CutlassMLP"
    img = synthetic_image()
    results = []
    for p in range(args.min_pow, args.max_pow + 1):
        batch = 1 << p
        model = create_from_config(2, 3, config, device=dev)
        trainer = model.trainer
        xy_np = np.random.default_rng(0).uniform(0, 1, (batch, 2)).astype(np.float32)
        px = np.minimum((xy_np * img.shape[0]).astype(np.int64), img.shape[0] - 1)
        xy = torch.from_numpy(xy_np).to(dev)
        target = torch.from_numpy(img[px[:, 1], px[:, 0]].astype(np.float32)).to(dev)

        first_loss = float(trainer.training_step(xy, target))
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(args.iters):
            loss = trainer.training_step(xy, target)
        sync(dev)
        train_tput = batch * args.iters / (time.perf_counter() - t0)

        with torch.no_grad():
            out = model.model.apply(trainer.params, xy)
            sync(dev)
            t0 = time.perf_counter()
            for _ in range(args.iters):
                out = model.model.apply(trainer.params, xy)
            sync(dev)
        infer_tput = batch * args.iters / (time.perf_counter() - t0)
        if not bool(torch.isfinite(out.float()).all()):
            raise RuntimeError(f"bench_image: non-finite inference output at batch {batch}")

        entry = {
            "batch": batch,
            "training_elements_per_second": round(train_tput, 1),
            "inference_elements_per_second": round(infer_tput, 1),
            "final_loss": float(loss),
            "method": "mlp_chain" if args.baseline else "fully_fused",
        }
        print(json.dumps(entry), flush=True)
        results.append(dict(entry, first_loss=first_loss))
    if args.out:
        Path(args.out).write_text(json.dumps([{k: e[k] for k in KEYS} for e in results], indent=2))
        print(f"# wrote {args.out}", file=sys.stderr)
    print(f"# card: {card_label(dev)}", file=sys.stderr)
    return results


if __name__ == "__main__":
    main()
