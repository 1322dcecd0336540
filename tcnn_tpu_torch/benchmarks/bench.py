"""Headline benchmark of the port: image-fit training throughput (the port
of the repo's ``bench.py``).

The protocol of the reference's flagship number (README.md:151-153,
samples/mlp_learning_an_image.cu): HashGrid (16 levels x 2 features) +
FullyFusedMLP 64 x 2, RelativeL2, Adam, batch 2^18; the metric is trained
samples per second. Baseline: 2.62e8 samples/s (1000 steps of batch 2^18 in
"a bit over 1 second" on an RTX 4090).

Each timed step generates its batch on the card from one
``torch.Generator`` (seed 0) and samples its targets: in 2D the nearest
pixel of a synthetic 512x512 texture (``bench_image``), in 3D
(``--protocol 3d``) an analytic density/colour field. ``--warmup`` steps,
then ``--timing-blocks`` blocks of steps, each closed by
``torch.cuda.synchronize()``; the reported number is the median block. The
2D default also measures the phase-locked sampler in the same process and
records it under ``secondary``. ``--serving`` times ``FrozenServer`` on the
1024^2 raster instead.

The parser, ``build_config``, ``resolve_mode_defaults`` and
``resolve_split_state`` are the root ``bench.py``'s (:40-261, :264-375,
:553-622), so one argv gives both packages the same config. Knobs that
change the function (the hash, the stratified raster-stride levels and
their ``--stratified-variants``, phase-locked snapping, the scatter
strategy's and ``--locked-rounding``'s gradient classes, the table dtype,
EMA) take effect; the TPU execution knobs (``--quad-build``, ``--layout``,
``--strat-accum``, ``--level-split``, ``--locked-fwd``, ``--split-state``)
are passed on as they are and logged as ignored. ``--steps-per-call N`` above 1
runs the steps through ``Trainer.training_steps(batch_fn, N)``: on the card
one captured CUDA graph of a step, batch included, replayed N times (a
``lax.scan`` in JAX, bench.py:485-530; on the CPU a loop). ``--device cpu`` runs the plain versions on the CPU, for tests.

Prints ONE JSON line on stdout (the root bench's metric names and keys) and
a comment line naming the card and its power limit on stderr.

Usage: python -m tcnn_tpu_torch.benchmarks.bench [--protocol 3d]
       [--serving] [--reference-verbatim] [--device cuda] ...
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from . import bench_device, card_label, sync

BASELINE_SAMPLES_PER_SEC = 2.62e8  # RTX 4090, reference README.md:151-153 (bench.py:37)
SERVING_BASELINE = 1e9  # the reference's fully-fused inference protocol (bench.py:685)
RES = 512
SERVING_SIDE, SERVING_REPS = 1024, 16  # the 1024^2 raster, 16 rasters a block (bench.py:667-676)


def build_parser():
    """The root bench.py's parser (:40-261), flag for flag, plus --device."""
    parser = argparse.ArgumentParser(description="Image-fit training (or --serving) throughput of the port.")
    parser.add_argument("--batch", type=int, default=2**18)
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--warmup", type=int, default=10)
    parser.add_argument("--timing-blocks", type=int, default=5,
                        help="split the timed steps into this many synchronised blocks; report the median block")
    parser.add_argument("--no-ab", action="store_true",
                        help="skip the secondary phase-locked measurement of the 2d default")
    parser.add_argument("--width", type=int, default=64)
    parser.add_argument("--hidden", type=int, default=2)
    parser.add_argument("--log2-hashmap", type=int, default=None)
    parser.add_argument("--per-level-scale", type=float, default=1.5)
    parser.add_argument("--protocol", choices=["2d", "3d"], default="2d",
                        help="'2d': the reference flagship image fit (2D HashGrid 16x2 @ 2^15 + FFMLP 64x2); "
                        "'3d': 3D HashGrid 16x2 @ 2^19 + FFMLP 64x2, batch 2^18 = 64^3 strata, analytic targets")
    parser.add_argument("--steps-per-call", type=int, default=1,
                        help="training steps a call of Trainer.training_steps (one captured CUDA graph "
                        "replayed; the JAX bench's lax.scan); 1: training_step calls")
    parser.add_argument("--serving", action="store_true",
                        help="time FrozenServer on the 1024^2 raster, 16 rasters a block, instead of training")
    parser.add_argument("--serving-dtype", choices=["float32", "bfloat16"], default="float32",
                        help="storage dtype of the frozen serving tables")
    parser.add_argument("--sort-batch", action="store_true", help="Morton-sort each 2d batch before the step")
    parser.add_argument("--sampler", choices=["stratified", "phase_locked", "iid"], default=None,
                        help="batch sampler (default: stratified in 2d and for --serving, phase_locked in 3d)")
    parser.add_argument("--locked-rounding", default=None, choices=["pair", "single", "sr", "f32"],
                        help="gradient rounding of the phase-locked levels (default: pair in 2d, single in 3d)")
    parser.add_argument("--locked-fwd", default=None, choices=["unpacked", "packed", "csr"],
                        help="TPU locked-level forward form (ignored by the port)")
    parser.add_argument("--ema", type=float, default=None,
                        help="wrap the optimizer in EMA with this decay (0 = off); default 0.99 for the "
                        "stratified/phase_locked samplers, 0 for iid and --serving")
    parser.add_argument("--locked-phases", type=int, default=1, help="jitter phases per batch with phase_locked")
    parser.add_argument("--stratified-variants", type=int, default=None,
                        help="stratified_max_variants of the encoding (sets its raster-stride levels)")
    parser.add_argument("--gather-strategy", default=None,
                        help="HashGrid gather strategy (default: 'stratified' with the stratified samplers, "
                        "'quad' otherwise)")
    parser.add_argument("--scatter-strategy", default=None,
                        help="HashGrid scatter strategy: the table gradient's rounding class (default: "
                        "'factored_sr' for the 2d stratified primary, 'auto' elsewhere)")
    parser.add_argument("--table-dtype", default=None, help="table storage dtype ('float16'/'bfloat16')")
    parser.add_argument("--quad-build", default=None, choices=["view", "flat", "slice", "cf"],
                        help="TPU quad-table build form (ignored by the port)")
    parser.add_argument("--layout", default=None, choices=["rm", "cf"],
                        help="TPU FFMLP activation layout (ignored by the port)")
    parser.add_argument("--strat-accum", default=None, choices=["select_n", "where"],
                        help="TPU static-path accumulation form (ignored by the port)")
    parser.add_argument("--level-split", default=None, choices=["auto", "off"],
                        help="TPU per-level parameter split (ignored by the port)")
    parser.add_argument("--split-state", choices=["auto", "on", "off"], default="auto",
                        help="TPU split training state (ignored by the port)")
    parser.add_argument("--reference-verbatim", action="store_true",
                        help="the reference's data/config_hash.json as shipped, iid batches, no EMA; the metric "
                        "gains the _refverbatim suffix")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu (plain versions, for tests)")
    return parser


def build_config(args, sampler, ema, scatter=None):
    """The flagship config for one sampler mode (bench.py:264-375): Adam
    beta2 0.99, eps 1e-15, l2 1e-6 as data/config_hash.json. ``scatter``
    overrides the scatter strategy for this config only."""
    scatter = scatter if scatter is not None else args.scatter_strategy
    adam = {
        "otype": "Adam",
        "learning_rate": 1e-2,
        "beta1": 0.9,
        "beta2": 0.99,
        "epsilon": 1e-15,
        "l2_reg": 1e-6,
    }
    if getattr(args, "reference_verbatim", False):
        return {
            "loss": {"otype": "RelativeL2"},
            "optimizer": adam,
            "encoding": {
                "otype": "HashGrid",
                "n_levels": 16,
                "n_features_per_level": 2,
                "log2_hashmap_size": 15,
                "base_resolution": 16,
                "per_level_scale": 1.5,
                "fixed_point_pos": False,
            },
            "network": {
                "otype": "FullyFusedMLP",
                "activation": "ReLU",
                "output_activation": "None",
                "n_neurons": 64,
                "n_hidden_layers": 2,
            },
        }
    return {
        "loss": {"otype": "RelativeL2"},
        "optimizer": ({"otype": "EMA", "decay": ema, "nested": adam} if ema else adam),
        "encoding": {
            "otype": "HashGrid",
            "n_levels": 16,
            "n_features_per_level": 2,
            "log2_hashmap_size": args.log2_hashmap,
            "base_resolution": 16,
            "per_level_scale": args.per_level_scale,
            "hash": "CoherentAdditive",
            "gather_strategy": args.gather_strategy
            or ("stratified" if sampler in ("stratified", "phase_locked") else "quad"),
            **({"stratified_max_variants": args.stratified_variants} if args.stratified_variants is not None else {}),
            **(
                {
                    "phase_locked": True,
                    "locked_phases": args.locked_phases,
                    **({"locked_rounding": args.locked_rounding} if args.locked_rounding else {}),
                    **({"locked_fwd": args.locked_fwd} if args.locked_fwd else {}),
                }
                if sampler == "phase_locked"
                else {}
            ),
            **({"scatter_strategy": scatter} if scatter else {}),
            **({"table_dtype": args.table_dtype} if args.table_dtype else {}),
            **({"quad_build": args.quad_build} if args.quad_build else {}),
            **({"level_split": args.level_split} if args.level_split else {}),
            **({"strat_accum": args.strat_accum} if args.strat_accum else {}),
        },
        "network": {
            "otype": "FullyFusedMLP",
            "activation": "ReLU",
            "output_activation": "None",
            "n_neurons": args.width,
            "n_hidden_layers": args.hidden,
            **({"layout": args.layout} if args.layout else {}),
        },
    }


def resolve_split_state(args) -> bool:
    """bench.py:553-563: on for the 3d protocol unless the gather strategy
    is a global-table one, else off. The port keeps one flat state and
    ignores the answer."""
    mode = getattr(args, "split_state", "auto")
    if mode == "auto":
        return args.protocol == "3d" and getattr(args, "gather_strategy", None) not in ("fused", "quad_fused")
    return mode == "on"


def resolve_mode_defaults(args):
    """Resolve the per-protocol defaults in place (bench.py:566-622);
    returns (explicit_sampler, primary_scatter). The 2d default is the
    stratified sampler with the factored_sr scatter and EMA(0.99); 3d the
    phase-locked sampler with locked_rounding single; serving the
    stratified no-EMA config. factored_sr is returned for the 2d primary
    only, never written to args, so it does not reach the phase-locked
    secondary."""
    if getattr(args, "reference_verbatim", False):
        if args.protocol != "2d":
            raise SystemExit("--reference-verbatim is the 2d protocol")
        args.sampler = "iid"
        args.ema = 0.0
        args.log2_hashmap = 15
        return True, None
    explicit_sampler = args.sampler is not None
    if args.sampler is None:
        args.sampler = "stratified" if (args.serving or args.protocol == "2d") else "phase_locked"
    if args.ema is None:
        args.ema = 0.0 if (args.serving or args.sampler == "iid") else 0.99
    primary_scatter = args.scatter_strategy
    if primary_scatter is None and args.protocol == "2d" and args.sampler == "stratified" and not args.serving:
        primary_scatter = "factored_sr"
    if args.log2_hashmap is None:
        args.log2_hashmap = 15 if args.protocol == "2d" else 19
    if args.locked_rounding is None and args.protocol == "3d":
        args.locked_rounding = "single"
    return explicit_sampler, primary_scatter


TPU_KNOBS = ("quad_build", "layout", "strat_accum", "level_split", "locked_fwd")


def ignored_knobs(args) -> list:
    """The TPU execution knobs that this run sets and the port ignores."""
    out = [f"--{k.replace('_', '-')}" for k in TPU_KNOBS if getattr(args, k, None) is not None]
    if resolve_split_state(args):
        out.append("--split-state (resolves on)")
    return out


def bench_image(res: int = RES) -> np.ndarray:
    """The root bench's own synthetic texture (bench.py:704-715): channel 3
    is sin(2 pi x y 4), not the sample's image."""
    yy, xx = np.meshgrid(np.linspace(0, 1, res), np.linspace(0, 1, res), indexing="ij")
    return np.stack(
        [
            0.5 + 0.5 * np.sin(8 * np.pi * xx) * np.cos(6 * np.pi * yy),
            0.5 + 0.5 * np.cos(4 * np.pi * (xx + yy)),
            0.5 + 0.5 * np.sin(2 * np.pi * xx * yy * 4),
        ],
        axis=-1,
    ).astype(np.float32)


def targets_3d(x: torch.Tensor) -> torch.Tensor:
    """The 3d protocol's analytic density/colour field (bench.py:429-449)."""
    pi = np.pi
    return torch.stack(
        [
            0.5 + 0.5 * torch.sin(6 * pi * x[:, 0]) * torch.cos(4 * pi * x[:, 1]),
            0.5 + 0.5 * torch.cos(5 * pi * (x[:, 1] + x[:, 2])),
            0.5 + 0.5 * torch.sin(3 * pi * x[:, 0] * x[:, 2] * 2),
        ],
        dim=-1,
    )


def morton_sort(xy: torch.Tensor) -> torch.Tensor:
    """``--sort-batch`` (bench.py:455-467): the batch in Morton order of its
    10-bit grid cell (a batch is a set; the step does not depend on order)."""
    q = (xy * 1024).to(torch.int64)
    key = torch.zeros(xy.shape[0], dtype=torch.int64, device=xy.device)
    for b in range(10):
        key = key | (((q[:, 0] >> b) & 1) << (2 * b)) | (((q[:, 1] >> b) & 1) << (2 * b + 1))
    return xy[torch.argsort(key, stable=True)]


def measure_training(args, sampler, ema, dev, image=None, scatter=None):
    """One training-throughput measurement for one sampler config
    (bench.py:390-550): the median block's ms/step and samples/s, every
    block, and the last step's loss."""
    from ..config import create_from_config
    from ..utils.sampling import stratified_uniform

    n_dims = 2 if args.protocol == "2d" else 3
    model = create_from_config(n_dims, 3, build_config(args, sampler, ema, scatter), device=dev)
    trainer = model.trainer
    gen = torch.Generator(device=dev).manual_seed(0)
    img = None if image is None else torch.from_numpy(image).to(dev).reshape(RES * RES, 3)

    def batch(generator):
        if sampler in ("stratified", "phase_locked"):
            x = stratified_uniform(args.batch, n_dims, generator,
                                   phase_locked=args.locked_phases if sampler == "phase_locked" else False)
        else:
            x = torch.rand((args.batch, n_dims), generator=generator, device=dev)
        if args.protocol == "3d":
            return x, targets_3d(x)
        if args.sort_batch:
            x = morton_sort(x)
        if sampler in ("stratified", "phase_locked") and args.batch == RES * RES and not args.sort_batch:
            return x, img  # strata == res: the nearest pixel of sample j is pixel j (bench.py:468-474)
        ij = torch.clamp((x * RES).to(torch.int64), 0, RES - 1)
        return x, img[ij[:, 1] * RES + ij[:, 0]]

    spc = max(1, args.steps_per_call)
    data = {"gen": gen}

    def batch_fn(d, i):
        return batch(d["gen"])

    def call():
        """``spc`` steps; their losses."""
        if spc == 1:
            return trainer.training_step(*batch(gen)).reshape(1)
        return trainer.training_steps(batch_fn, spc, data)

    k = max(1, args.timing_blocks)
    steps_per_block = max(spc, (args.steps // k) // spc * spc)
    n_warm = max(1, -(-args.warmup // spc))

    losses = call()
    first_loss = float(losses[0])
    for _ in range(n_warm - 1):
        losses = call()
    sync(dev)
    ms_blocks = []
    for _ in range(k):
        t0 = time.perf_counter()
        for _ in range(steps_per_block // spc):
            losses = call()
        loss = losses[-1]
        sync(dev)
        ms_blocks.append((time.perf_counter() - t0) / steps_per_block * 1e3)
    median_ms = statistics.median(ms_blocks)
    return {
        "sampler": sampler,
        "ema": ema,
        "scatter": scatter or args.scatter_strategy or "auto",
        "ms_per_step": round(median_ms, 3),
        "ms_blocks": [round(m, 3) for m in ms_blocks],
        "samples_per_sec": round(args.batch / median_ms * 1e3, 1),
        "final_loss": float(loss),
        "first_loss": first_loss,
    }


def measure_serving(args, dev):
    """``--serving`` (bench.py:647-695): FrozenServer over the 1024^2
    tile-centre raster, 16 rasters a block, the median block."""
    from ..config import create_from_config

    if args.protocol != "2d":
        raise SystemExit("--serving is defined for the 2d protocol only")
    model = create_from_config(2, 3, build_config(args, args.sampler, args.ema), device=dev)
    server = model.trainer.freeze_serving(table_dtype=None if args.serving_dtype == "float32" else args.serving_dtype)
    side, reps = SERVING_SIDE, SERVING_REPS
    y = server.raster((side, side))
    sync(dev)
    ms_blocks = []
    for _ in range(max(1, args.timing_blocks)):
        t0 = time.perf_counter()
        for _ in range(reps):
            y = server.raster((side, side))
        sync(dev)
        ms_blocks.append((time.perf_counter() - t0) / reps * 1e3)
    ms = statistics.median(ms_blocks)
    if not bool(torch.isfinite(y).all()):
        raise RuntimeError("bench --serving: non-finite raster")
    samples_per_sec = side * side / ms * 1e3
    return {
        "metric": "flagship_serving_throughput_raster1024_frozen",
        "value": round(samples_per_sec, 1),
        "unit": "samples/s",
        "vs_baseline": round(samples_per_sec / SERVING_BASELINE, 4),
        "ms_per_raster": round(ms, 3),
        "ms_blocks": [round(m, 3) for m in ms_blocks],
    }


def main(argv=None):
    """Runs the benchmark of ``argv``; prints the JSON line and returns
    (that line's dict, {"primary": ..., "secondary": ...} with each
    training run's measurement, first and final loss included)."""
    args = build_parser().parse_args(argv)
    explicit_sampler, primary_scatter = resolve_mode_defaults(args)
    dev = bench_device(args.device)
    card = card_label(dev)
    ignored = ignored_knobs(args)
    if ignored:
        print(f"# the port ignores the TPU execution knobs {', '.join(ignored)}", file=sys.stderr)

    if args.serving:
        result = measure_serving(args, dev)
        print(json.dumps(result), flush=True)
        print(f"# serving {result['ms_per_raster']:.3f} ms per 1024^2 raster, card: {card}", file=sys.stderr)
        return result, {}

    image = bench_image() if args.protocol == "2d" else None
    primary = measure_training(args, args.sampler, args.ema, dev, image, scatter=primary_scatter)
    secondary = None
    if args.protocol == "2d" and not args.no_ab and not explicit_sampler:
        secondary = measure_training(args, "phase_locked", 0.99, dev, image, scatter=args.scatter_strategy)

    metric = (
        "image_fit_training_throughput_hashgrid16x2_ffmlp64x2_b2^18"
        if args.protocol == "2d"
        else "nerf3d_training_throughput_hashgrid16x2_ffmlp64x2_b2^18"
    )
    if args.reference_verbatim:
        metric += "_refverbatim"
    result = {
        "metric": metric,
        "value": primary["samples_per_sec"],
        "unit": "samples/s",
        "vs_baseline": round(primary["samples_per_sec"] / BASELINE_SAMPLES_PER_SEC, 4),
        "sampler": primary["sampler"],
        "scatter": primary["scatter"],
        "ema": primary["ema"],
        "ms_per_step": primary["ms_per_step"],
        "ms_blocks": primary["ms_blocks"],
    }
    if secondary is not None:
        result["secondary"] = {
            "sampler": secondary["sampler"],
            "scatter": secondary["scatter"],
            "ema": secondary["ema"],
            "ms_per_step": secondary["ms_per_step"],
            "ms_blocks": secondary["ms_blocks"],
            "samples_per_sec": secondary["samples_per_sec"],
            "vs_baseline": round(secondary["samples_per_sec"] / BASELINE_SAMPLES_PER_SEC, 4),
        }
    print(json.dumps(result), flush=True)
    print(f"# {primary['ms_per_step']:.3f} ms/step (median of {len(primary['ms_blocks'])} blocks: "
          f"{primary['ms_blocks']}), final loss {primary['final_loss']:.3e}, card: {card}", file=sys.stderr)
    if secondary is not None:
        print(f"# secondary [{secondary['sampler']}]: {secondary['ms_per_step']:.3f} ms/step (blocks: "
              f"{secondary['ms_blocks']}), final loss {secondary['final_loss']:.3e}", file=sys.stderr)
    return result, {"primary": primary, "secondary": secondary}


if __name__ == "__main__":
    main()
