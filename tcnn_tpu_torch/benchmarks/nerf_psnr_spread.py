"""How often one run of the NeRF sample reads under chip_smoke's per-run
validation PSNR floor, on the card.

Runs ``samples.nerf_synthetic`` at chip_smoke's settings (600 steps of
8192 rays, the sample's CONFIG) ``--repeats`` times for each seed of
``--seeds`` (chip_smoke's 0-4), one run after another in one process, and
prints one JSON line: every run's validation PSNR by seed, the runs under
``--floor`` (chip_smoke's 35 dB a run) and their share, and each seed's and
all runs' min, median and max. Atomics make two runs of one seed differ, so
the spread within a seed is run-to-run noise, and the share under the floor
is how often chip_smoke's NeRF check fails by chance on an unchanged path.

Usage: python -m tcnn_tpu_torch.benchmarks.nerf_psnr_spread [--repeats 10]
       [--seeds 0,1,2,3,4] [--floor 35] [--steps 600] [--rays 8192]
       [--device cuda]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import statistics


def summarize(psnrs: dict, floor: float) -> dict:
    """{seed: [dB, ...]} -> the runs under ``floor`` (seed, run, dB), their
    count and share, and min / median / max by seed and over all runs."""
    every = [v for runs in psnrs.values() for v in runs]
    under = [(seed, i, v) for seed, runs in psnrs.items() for i, v in enumerate(runs) if v < floor]

    def spread(values):
        return {"min": min(values), "median": statistics.median(values), "max": max(values)}

    return {"floor_db": floor, "runs": len(every), "under_floor": under, "n_under": len(under),
            "share_under": len(under) / len(every), "all": spread(every),
            "by_seed": {seed: spread(runs) for seed, runs in psnrs.items()}}


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--seeds", default="0,1,2,3,4")
    ap.add_argument("--floor", type=float, default=35.0)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--rays", type=int, default=8192)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    from ..samples import nerf_synthetic as ns
    from . import bench_device, card_label

    dev = bench_device(args.device)
    psnrs = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        for _ in range(args.repeats):
            with contextlib.redirect_stdout(io.StringIO()):
                res = ns.main([str(args.steps), str(args.rays), "--seed", str(seed), "--device", args.device])
            psnrs.setdefault(seed, []).append(res["psnr_db"])
    result = {"device": card_label(dev), "steps": args.steps, "rays": args.rays, "psnr_db": psnrs,
              **summarize(psnrs, args.floor)}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
