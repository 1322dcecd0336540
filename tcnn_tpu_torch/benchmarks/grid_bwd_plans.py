"""The table-gradient kernel's launch plan, swept on the card.

``ops.grid_encode.backward_plan`` lays out ``tcnn_grid_backward``: about
``BWD_TARGET_BLOCKS`` blocks of consecutive samples, and a shared-memory copy
of each level of at most ``BWD_PRIV_ROWS_PER_SAMPLE`` rows a block sample.
This entry point times the kernel under other values of the two (0 rows: no
level privatised) at the shapes ``chip_smoke.py`` times it at: the flagship
encoding (``__graft_entry__.FLAGSHIP_CONFIG``'s) on a stratified batch and on
uniform points, and the 3D model (the root ``bench.py``'s ``--protocol 3d``
encoding) on uniform points, each in its training classes, bf16 dy.

Usage: python -m tcnn_tpu_torch.benchmarks.grid_bwd_plans [--batch 262144]
       [--targets 132,264,528] [--rows 0,2,4] [--reps 20] [--device cuda]

One JSON line per (shape, variant): the plan (blocks, samples per block,
privatised levels), the time (CUDA events: each variant timed twice, the
variants in order and then in reverse, each time the median of 3 blocks of
``--reps`` calls; ``ms`` is the mean of the two) and the largest difference
from the default plan's gradient (the sums' order differs; the tests and
``chip_smoke.py`` hold the kernel to its plain version). ``--device cpu``
runs the plain version, for tests only: its times are the CPU's.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..encodings import create_encoding
from ..encodings.grid import _INTERP_CODES
from ..ops import grid_encode as ge
from ..utils.sampling import stratified_uniform
from . import bench_device, card_label, sync, timed_blocks

FLAGSHIP_ENCODING = {
    "otype": "HashGrid", "n_levels": 16, "n_features_per_level": 2, "log2_hashmap_size": 15,
    "base_resolution": 16, "per_level_scale": 1.5, "hash": "CoherentAdditive", "gather_strategy": "stratified",
}
ENCODING_3D = dict(FLAGSHIP_ENCODING, log2_hashmap_size=19, gather_strategy="auto")


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=2**18, help="samples (a perfect square: the stratified batch)")
    parser.add_argument("--targets", default="132,264,396,528,792,1056", help="BWD_TARGET_BLOCKS values")
    parser.add_argument("--rows", default="0,2,4,8", help="BWD_PRIV_ROWS_PER_SAMPLE values (0: no private level)")
    parser.add_argument("--reps", type=int, default=20, help="calls per timed block")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu (the plain version, for tests)")
    return parser


def shapes(batch: int, dev: torch.device, seed: int):
    """name -> (encoding, positions, dy): the three timed inputs."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    flagship = create_encoding(2, FLAGSHIP_ENCODING, alignment=16)
    enc3 = create_encoding(3, ENCODING_3D, alignment=16)

    def dy(enc):
        return torch.randn((batch, enc.padded_output_width), generator=gen, device=dev).to(torch.bfloat16)

    return {
        "flagship stratified": (flagship, stratified_uniform(batch, 2, gen, device=dev), dy(flagship)),
        "flagship uniform": (flagship, torch.rand((batch, 2), generator=gen, device=dev), dy(flagship)),
        "3D model uniform": (enc3, torch.rand((batch, 3), generator=gen, device=dev), dy(enc3)),
    }


def main(argv=None) -> list:
    args = build_parser().parse_args(argv)
    dev = bench_device(args.device)
    card = card_label(dev)
    targets = [int(v) for v in args.targets.split(",")]
    rows = [int(v) for v in args.rows.split(",")]
    records = []
    for name, (enc, x, dy) in shapes(args.batch, dev, args.seed).items():
        classes_np = enc.gradient_classes(args.batch)
        classes = torch.from_numpy(classes_np).to(dev)
        levels, lt, F = enc._levels_on(dev), enc.level_table(), enc.n_features_per_level
        interp = _INTERP_CODES[enc.interpolation_type]
        plans = {(t, r): ge.backward_plan(lt, F, args.batch, classes_np, t, r) for t in targets for r in rows}

        def run(plan):
            return ge.grid_backward(x, dy, levels, F, interp, classes, plan)

        ref = run(ge.backward_plan(lt, F, args.batch, classes_np))
        times = {key: [] for key in plans}
        with torch.no_grad():
            for key in list(plans) + list(reversed(list(plans))):
                times[key].append(timed_blocks(lambda: run(plans[key]), dev, args.reps)[0])
            for (target, per_sample), plan in plans.items():
                diff = float((run(plan) - ref).abs().max())
                sync(dev)
                record = {
                    "shape": name, "batch": args.batch, "target_blocks": target, "priv_rows_per_sample": per_sample,
                    "blocks": plan.blocks, "chunk": plan.chunk,
                    "privatised": [lvl for lvl, p in enumerate(plan.privatised) if p],
                    "ms": sum(times[(target, per_sample)]) / 2, "ms_runs": times[(target, per_sample)],
                    "max_abs_diff_vs_default": diff, "device": card,
                }
                print(json.dumps(record), flush=True)
                records.append(record)
    return records


if __name__ == "__main__":
    main(sys.argv[1:])
