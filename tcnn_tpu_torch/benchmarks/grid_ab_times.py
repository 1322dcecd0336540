"""The lookup and the table gradient at the flagship (B = 2^18, stratified
and uniform points; with ``"hash": "Rng"`` on uniform points; the table
gradients of ``fixed_point_pos`` and of stochastic interpolation on the
same uniform points, as uint32 and with one uniform per (sample, level))
and on the 3D model (uniform points), through the public wrappers; with
``--ptxas`` the grid libraries' build seconds and every kernel's registers
and spills; with ``--steps N`` the flagship training step, as configured,
with the Rng hash and with ``fixed_point_pos``, through
``Trainer.training_steps`` (N steps of one captured step replayed). Card
only.

Prints one JSON line ``{"times": {...}, "ptxas": {...}, "steps": {...}}``:
kernels by CUDA events, median of 7 runs of 20 calls each, bf16 output and
dL/dy, each encoding in its own training classes; steps by the host clock
over N steps synced at their ends, median of 3. For a parent-beside-change
pair, copy this file into the parent's ``tcnn_tpu_torch/benchmarks/`` and
run it from both roots in turns (parent, change, change, parent) in one
call:

    python -m tcnn_tpu_torch.benchmarks.grid_ab_times [--ptxas] [--steps 100]
"""

from __future__ import annotations

import argparse
import copy
import json
import statistics
import time

FLAGSHIP = {"otype": "HashGrid", "n_levels": 16, "n_features_per_level": 2, "log2_hashmap_size": 15,
            "base_resolution": 16, "per_level_scale": 1.5, "hash": "CoherentAdditive", "gather_strategy": "stratified"}
MODEL_3D = {"otype": "HashGrid", "n_levels": 16, "n_features_per_level": 2, "log2_hashmap_size": 19,
            "base_resolution": 16, "per_level_scale": 1.5, "hash": "CoherentAdditive"}
FLAGSHIP_RNG = dict(FLAGSHIP, hash="Rng")
BATCH = 2**18
# The libraries the timed calls use (those of them the checkout has).
LIBRARIES = ("grid_fwd", "grid_bwd", "grid_input_grad", "grid_bwd_rng", "grid_bwd_modes", "ffmlp_fwd", "ffmlp_bwd",
             "adam_step")
GRID_LIBRARIES = ("grid_fwd", "grid_bwd", "grid_input_grad", "grid_bwd_rng", "grid_bwd_modes")


def _build_all():
    """Builds every library of LIBRARIES the checkout has, in parallel."""
    from ..ops import _build

    _build.build_libraries(n for n in LIBRARIES if (_build.CSRC / f"{n}.cu").exists())


def _event_ms(fn, iters=20, reps=7):
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def _as_fixed(x):
    """Positions in [0, 1] as fixed_point_pos's uint32 (x * 2^32, floored,
    clamped), held in int64."""
    import torch

    return torch.clamp((x.double() * 2.0**32).floor(), 0, 2**32 - 1).to(torch.int64)


def times(seed: int = 5) -> dict:
    import torch

    from ..encodings import create_encoding
    from ..ops import grid_encode as ge
    from ..utils.sampling import stratified_uniform

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for name, cfg, d in (("flagship", FLAGSHIP, 2), ("flagship Rng", FLAGSHIP_RNG, 2), ("3D model", MODEL_3D, 3)):
        enc = create_encoding(d, cfg, alignment=16)
        enc.output_dtype = torch.bfloat16
        params = torch.rand((enc.n_params,), generator=gen, device=dev) * 2 - 1
        dy = torch.randn((BATCH, enc.padded_output_width), generator=gen, device=dev).bfloat16()
        points = {"uniform": torch.rand((BATCH, d), generator=gen, device=dev)}
        if cfg is FLAGSHIP:
            points["stratified"] = stratified_uniform(BATCH, 2, gen, device=dev)
        levels = enc._levels_on(dev)
        classes = torch.from_numpy(enc.gradient_classes(BATCH)).to(dev)
        plan = ge.backward_plan(enc.level_table(), enc.n_features_per_level, BATCH, classes)
        for label, x in points.items():
            with torch.no_grad():
                out[f"{name} {label} lookup"] = _event_ms(lambda: enc.apply(params, x))
                out[f"{name} {label} table gradient"] = _event_ms(
                    lambda: ge.grid_backward(x, dy, levels, enc.n_features_per_level, ge.INTERP_LINEAR, classes, plan))
        if cfg is FLAGSHIP:  # the two modes' table gradients over the same uniform points
            x = points["uniform"]
            for mode, over in (("fixed_point_pos", {"fixed_point_pos": True}),
                               ("stochastic", {"stochastic_interpolation": True})):
                menc = create_encoding(d, dict(cfg, **over), alignment=16)
                xm = _as_fixed(x).to(torch.uint32) if mode == "fixed_point_pos" else x
                u = menc._uniforms(gen, BATCH, dev)
                mcls = torch.from_numpy(menc.gradient_classes(BATCH, False if u is not None else None)).to(dev)
                mplan = ge.backward_plan(menc.level_table(), menc.n_features_per_level, BATCH, mcls)
                mlevels = menc._levels_on(dev)
                with torch.no_grad():
                    out[f"{name} uniform {mode} table gradient"] = _event_ms(
                        lambda: ge.grid_backward(xm, dy, mlevels, menc.n_features_per_level, ge.INTERP_LINEAR, mcls,
                                                 mplan, u))
    return out


def steps(n_steps: int, seed: int = 5) -> dict:
    """ms a step of FLAGSHIP_CONFIG, and of it with "hash": "Rng" and with
    "fixed_point_pos" (the same points as uint32), through
    Trainer.training_steps: stratified batches drawn on the card beforehand
    (targets a smooth function of x), one call to capture, then the host
    clock over ``n_steps`` replayed steps synced at their ends, median of 3."""
    import torch

    import tcnn_tpu_torch as tt
    from __graft_entry__ import FLAGSHIP_CONFIG

    from ..utils.sampling import stratified_uniform

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    xs = torch.stack([stratified_uniform(BATCH, 2, gen) for _ in range(n_steps)])
    data = {"x": xs, "t": torch.stack([torch.sin(6 * xs[..., 0]), torch.cos(5 * xs[..., 1]),
                                       xs[..., 0] * xs[..., 1]], -1)}

    def batch(d, i):
        idx = i.reshape(1).to(torch.int64)
        return torch.index_select(d["x"], 0, idx)[0], torch.index_select(d["t"], 0, idx)[0]

    def batch_fixed(d, i):  # the positions as uint32, gathered as int64
        idx = i.reshape(1).to(torch.int64)
        return torch.index_select(d["xf"], 0, idx)[0].to(torch.uint32), torch.index_select(d["t"], 0, idx)[0]

    out = {}
    for name, over, batch_fn in (("flagship", {}, batch), ("flagship Rng", {"hash": "Rng"}, batch),
                                 ("flagship fixed_point_pos", {"fixed_point_pos": True}, batch_fixed)):
        cfg = copy.deepcopy(FLAGSHIP_CONFIG)
        cfg["encoding"].update(over)
        if "fixed_point_pos" in over:
            data["xf"] = _as_fixed(xs)
        trainer = tt.create_from_config(2, 3, cfg, seed=seed, device=dev).trainer
        trainer.training_steps(batch_fn, n_steps, data)  # warm-up and capture
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.training_steps(batch_fn, n_steps, data)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3 / n_steps)
        out[f"{name} training_steps ms/step"] = statistics.median(runs)
        out[f"{name} training_steps runs"] = runs
    return out


def _kernel(readable: str) -> str:
    """A demangled kernel name without its return type and parameters."""
    name = readable.replace("void ", "", 1).replace("<unnamed>::", "")
    return name.split(">(")[0] + ">" if ">(" in name else name.split("(")[0]


def ptxas() -> dict:
    """Builds the grid libraries together (unless built: those of
    GRID_LIBRARIES the checkout has) and reads each kernel's registers and
    spills from the compiler's report."""
    from ..ops import _build
    from .grid_second_order_times import demangle, parse_ptxas

    built = _build.build_libraries_timed(n for n in GRID_LIBRARIES if (_build.CSRC / f"{n}.cu").exists())
    out = {}
    for name, (path, seconds) in built.items():
        report = parse_ptxas(path.with_suffix(".log").read_text())
        readable = demangle(report)
        out[name] = {"build_s": seconds, "kernels": {
            _kernel(readable[fn]): [r["registers"], r["spill_stores"], r["spill_loads"]] for fn, r in report.items()}}
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ptxas", action="store_true", help="also the build seconds, registers and spills")
    parser.add_argument("--steps", type=int, default=0, help="also the flagship step through training_steps")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("grid_ab_times: needs a CUDA device")
    result = {"ptxas": ptxas() if args.ptxas else None}
    _build_all()
    result["times"] = times()
    result["steps"] = steps(args.steps) if args.steps > 0 else None
    result["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
