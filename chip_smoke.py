#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tcnn_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing lines of its own; any failure exits non-zero:

1. device: needs CUDA (no CPU fallback); prints the card's name and power
   limit as nvidia-smi reports them.
2. build: compiles all five kernel libraries from tcnn_tpu_torch/csrc, one
   nvcc each, all started together.
3. kernel 1 (fused MLP forward) against its plain chain, over widths x
   depths x activations x batch sizes, then at the flagship's shapes.
4. kernel 2 (grid lookup) against its plain version: the flagship encoding
   at B = 2^18 plus cell-boundary points and points outside [0, 1]; again
   with table_dtype bfloat16 and with the CoherentPrime (XOR) hash.
5. the serving slice: create_from_config(FLAGSHIP_CONFIG, device="cuda"),
   random parameters from a numpy seed, inference at B in {1, 4097, 2^18},
   inference_raster 1024^2 and a FrozenServer batch and raster, each
   checked against the plain path on the card; both kernels' launch
   counters must rise during this phase.
6. the fused MLP backward against its plain version: widths x depths x
   activations x batch sizes, all ten activations, the flagship's shapes.
7. the fused Adam step against its plain version at the flagship's
   715,760 params, over the optimizer's knobs, three steps each.
8. the grid backward (flagship encoding, B = 2^18) and the generic
   row scatter (2^18 rows into 64 slots) against their plain versions in
   the four gradient classes.
9. the training slice, FLAGSHIP_CONFIG and
   benchmarks/configs/config_hash_strat_sr_ema.json: one step from the
   same state on the kernel path and on the plain path, then 1000 steps at
   B = 2^18 on stratified batches of the synthetic 512^2 image; the loss
   falls, everything stays finite, the PSNR of the fitted image clears its
   floor, and every training kernel's launch counter rises.
10. times (CUDA events / synced host clock, median of repeats).

The second-to-last line is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 20261016
B_FLAG = 2**18
TOL_NOTE = "p99 RAE <= 1e-2 and max|diff| <= 4 bf16 ulps of max|ref| (fp32 sums in another order flip bf16 roundings)"
TOL_BWD_NOTE = (
    "||kernel - plain|| <= 1e-2 ||plain|| and at most 0.1% of the entries beyond 4 bf16 ulps of max|ref| (dW "
    "entries are long fp32 sums that cancel, so entrywise relative errors of small entries mean nothing; a "
    "derivative that jumps, ReLU's at 0 or a bf16 rounding of the recomputed forward, turns an fp32 sum-order "
    "difference into an O(1) change of a few entries)"
)
KERNELS = ("ffmlp_fwd", "grid_fwd", "ffmlp_bwd", "adam_step", "grid_bwd")
N_TRAIN_STEPS = 1000
# PSNR floors of the 1000-step fits (dB) and the JAX package's TPU v5e
# readings beside them (benchmarks/golden_strat_sr/metrics.json; the
# pair-class run without EMA, DOCUMENTATION.md:275).
PSNR_FLOOR = {"FLAGSHIP_CONFIG": 45.0, "config_hash_strat_sr_ema.json": 47.0}
JAX_TPU_PSNR = {"FLAGSHIP_CONFIG": 47.3, "config_hash_strat_sr_ema.json": 53.226}
# Independent fits (sampler seeds) whose median PSNR is held to the floor.
# Without EMA the served weights are the last step's, which dither at the
# constant learning rate: single 1000-step fits of FLAGSHIP_CONFIG spread
# from 38.8 to 49.3 dB around a median of ~45.8 dB on an H100 (52 fits; the
# JAX package's own no-EMA goldens read 45.0-47.3 dB on a TPU v5e), so one
# fit, or the mean of a few with their long lower tail, would pass or fail
# the floor by chance. The EMA config averages that dither away.
N_FITS = {"FLAGSHIP_CONFIG": 64, "config_hash_strat_sr_ema.json": 1}


def log(msg: str) -> None:
    print(msg, flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def bf16_close(got, want, what: str) -> float:
    """Kernel vs plain, bf16 network outputs: ``TOL_NOTE``. Returns max |diff|."""
    import torch

    got = got.float()
    want = want.float()
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    check(torch.isfinite(got).all(), f"{what}: non-finite output")
    diff = (got - want).abs()
    denom = got.abs() + want.abs()
    rae = torch.where(denom == 0, torch.zeros_like(diff), 2 * diff / torch.where(denom == 0, 1, denom))
    flat = rae.flatten()
    k = max(1, int(np.ceil(0.99 * flat.numel())))
    p99 = float(flat.kthvalue(k).values)
    max_diff = float(diff.max())
    scale = float(want.abs().max())
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7) if scale > 0 else 0.0
    check(p99 <= 1e-2, f"{what}: p99 RAE {p99:.3e} > 1e-2")
    check(max_diff <= 4 * ulp, f"{what}: max|diff| {max_diff:.3e} > 4 bf16 ulps ({4 * ulp:.3e})")
    return max_diff


def gpu_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0].strip()


def phase_build():
    from tcnn_tpu_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build_libraries(KERNELS)
    dt = time.perf_counter() - t0
    for name, path in paths.items():
        src = os.path.relpath(_build.CSRC / f"{name}.cu")
        log(f"build: {src} -> {os.path.relpath(path)} (all five in parallel: {dt:.1f} s)")
        logfile = path.with_suffix(".log")
        if logfile.exists():
            for line in logfile.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas: {line.strip()}")


def _mlp_weights(gen, shapes, gain, device):
    import torch

    ws = []
    for rows, cols in shapes:
        w = (torch.rand((rows, cols), generator=gen, device=device) * 2 - 1) * (gain / np.sqrt(cols))
        ws.append(w.to(torch.bfloat16))
    return ws


def _shapes(in_w, width, n_hidden, out_w):
    if n_hidden == 0:
        return [(out_w, in_w)]
    return [(width, in_w)] + [(width, width)] * (n_hidden - 1) + [(out_w, width)]


def phase_kernel1():
    import torch

    from tcnn_tpu_torch.common import Activation
    from tcnn_tpu_torch.ops.ffmlp import ffmlp_forward, ffmlp_forward_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n = 0
    worst = 0.0
    for width in (16, 32, 64, 128):
        for n_hidden in (0, 2, 5):
            for act in (Activation.ReLU, Activation.Sigmoid, Activation.Sine):
                ws = _mlp_weights(gen, _shapes(32, width, n_hidden, 16), 2.0, dev)
                for batch in (1, 1000, B_FLAG):
                    x = (torch.rand((batch, 32), generator=gen, device=dev) * 2 - 1).to(torch.bfloat16)
                    got = ffmlp_forward(x, ws, act, Activation.NONE)
                    want = ffmlp_forward_plain(x, ws, act, Activation.NONE)
                    torch.cuda.synchronize()
                    worst = max(worst, bf16_close(got, want, f"ffmlp w{width} h{n_hidden} {act.value} B{batch}"))
                    n += 1
    log(f"kernel1: {n} cases match the plain chain ({TOL_NOTE}); worst max|diff| {worst:.3e}")
    ws = _mlp_weights(gen, _shapes(32, 64, 2, 16), 1.0, dev)
    x = (torch.rand((B_FLAG, 32), generator=gen, device=dev) * 2 - 1).to(torch.bfloat16)
    got = ffmlp_forward(x, ws, Activation.ReLU, Activation.NONE)
    want = ffmlp_forward_plain(x, ws, Activation.ReLU, Activation.NONE)
    err = bf16_close(got, want, "ffmlp flagship shapes")
    log(f"kernel1: flagship shapes (B 2^18, 32 -> 64 x2 -> 16, ReLU) max|diff| {err:.3e}")
    return {"x": x, "ws": ws, "err": err}


def _boundary_points(scales, rng, per_level=256):
    pts = []
    for s in scales:
        s32 = np.float32(s)
        k = rng.integers(0, int(np.ceil(s)) + 2, size=(per_level, 2)).astype(np.float32)
        x = (k - np.float32(0.5)) / s32
        pts += [x, np.nextafter(x, np.float32(np.inf)), np.nextafter(x, np.float32(-np.inf))]
    return np.concatenate(pts)


def phase_kernel2(flagship):
    import torch

    from tcnn_tpu_torch.encodings import create_encoding

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    results = {}
    variants = {
        "flagship": flagship["encoding"],
        "table_dtype bfloat16": dict(flagship["encoding"], table_dtype="bfloat16"),
        "hash CoherentPrime": dict(flagship["encoding"], hash="CoherentPrime"),
    }
    for name, cfg in variants.items():
        enc = create_encoding(2, cfg, alignment=16)
        x_np = np.concatenate([
            rng.uniform(0, 1, (B_FLAG, 2)),
            rng.uniform(-0.5, 1.5, (4096, 2)),
        ]).astype(np.float32)
        x_np = np.concatenate([x_np, _boundary_points(enc.scales, rng).astype(np.float32)])
        params = torch.from_numpy(rng.uniform(-1, 1, enc.n_params).astype(np.float32)).to(dev)
        x = torch.from_numpy(x_np).to(dev)
        with torch.no_grad():
            enc.output_dtype = torch.float32
            got = enc.apply(params, x)
            want = enc.apply_plain(params, x)
            enc.output_dtype = torch.bfloat16
            got16 = enc.apply(params, x)
        torch.cuda.synchronize()
        check(got.shape == (len(x_np), 32) and torch.isfinite(got).all(), f"grid {name}: bad output")
        err = float((got - want).abs().max())
        # fp32 features of magnitude <= 1: the sums differ at most in their
        # order of addition on the card.
        check(torch.allclose(got, want, rtol=1e-5, atol=1e-6), f"grid {name}: max|diff| {err:.3e}")
        check(torch.equal(got16, got.to(torch.bfloat16)), f"grid {name}: bf16 store differs")
        log(f"kernel2: {name}: {len(x_np)} points (2^18 uniform, 4096 outside [0,1], "
            f"{len(x_np) - B_FLAG - 4096} on cell boundaries) match the plain lookup "
            f"(fp32 rtol 1e-5 atol 1e-6), max|diff| {err:.3e}; bf16 output = rounded fp32")
        results[name] = (enc, params, x[:B_FLAG].contiguous(), err)
    return results


def flagship_params(model, rng):
    """Grid uniform +-1, network uniform at the xavier scale."""
    net = model.network
    parts = []
    for rows, cols in net.layer_sizes():
        s = np.sqrt(6.0 / (rows + cols))
        parts.append(rng.uniform(-s, s, rows * cols))
    parts.append(rng.uniform(-1, 1, model.encoding.n_params))
    return np.concatenate(parts).astype(np.float32)


def phase_slice(flagship):
    import torch

    import tcnn_tpu_torch as tt
    from tcnn_tpu_torch.networks.mlp import MLP
    from tcnn_tpu_torch.ops import ffmlp, grid_encode
    from tcnn_tpu_torch.utils.sampling import raster_centers_torch

    rng = np.random.default_rng(SEED + 1)
    m = tt.create_from_config(2, 3, flagship, device="cuda")
    model, trainer = m.model, m.trainer
    check(model.params.is_cuda and model.n_params == 715760, "flagship model not on the card")
    trainer.params = tt.params_from_numpy(flagship_params(model, rng), model)
    n_net = model.network.n_params

    def plain(params, x):
        with torch.no_grad():
            enc = model.encoding.apply_plain(params[n_net:], x)
            return MLP.apply(model.network, params[:n_net], enc)[:, :3].float()

    batches = {b: rng.uniform(0, 1, (b, 2)).astype(np.float32) for b in (1, 4097, B_FLAG)}
    raster_x = raster_centers_torch((1024, 1024), 2, "cuda")

    ffmlp.LAUNCHES = 0
    grid_encode.LAUNCHES = 0
    outs = {}
    for b, x in batches.items():
        outs[f"inference B={b}"] = (m.inference(x), torch.from_numpy(x).cuda())
    outs["inference_raster 1024x1024"] = (trainer.inference_raster((1024, 1024)), raster_x)
    server = trainer.freeze_serving()
    outs["FrozenServer batch B=2^18"] = (server(batches[B_FLAG]), torch.from_numpy(batches[B_FLAG]).cuda())
    outs["FrozenServer raster 1024x1024"] = (server.raster(1024), raster_x)
    torch.cuda.synchronize()
    launches = {"ffmlp_fwd": ffmlp.LAUNCHES, "grid_fwd": grid_encode.LAUNCHES}

    for name, (y, x) in outs.items():
        check(y.dtype == torch.float32 and y.shape == (x.shape[0], 3), f"{name}: {y.dtype} {tuple(y.shape)}")
        check(torch.isfinite(y).all(), f"{name}: non-finite output")
        err = bf16_close(y, plain(trainer.params, x), name)
        log(f"slice: {name}: shape {tuple(y.shape)} fp32 finite, matches the plain path, max|diff| {err:.3e}")
    for k, v in launches.items():
        check(v > 0, f"slice: kernel {k} was not launched on the serving path")
    log(f"slice: kernel launches during the serving phase: {launches}")
    return m, launches, batches[B_FLAG]


def bwd_close(got, want, what: str) -> float:
    """Kernel vs plain, bf16 gradients: ``TOL_BWD_NOTE``. Returns max |diff|."""
    import torch

    got = got.float()
    want = want.float()
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    check(torch.isfinite(got).all(), f"{what}: non-finite output")
    diff = (got - want).abs()
    rel = float(diff.norm()) / max(float(want.norm()), 1e-30)
    scale = float(want.abs().max())
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7) if scale > 0 else 0.0
    beyond = float((diff > 4 * ulp).float().mean())
    check(rel <= 1e-2, f"{what}: relative difference (norm) {rel:.3e} > 1e-2")
    check(beyond <= 1e-3, f"{what}: {beyond:.2e} of the entries beyond 4 bf16 ulps ({4 * ulp:.3e})")
    return float(diff.max())


def phase_mlp_backward():
    import torch

    from tcnn_tpu_torch.common import Activation
    from tcnn_tpu_torch.ops.ffmlp import ffmlp_backward, ffmlp_backward_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)

    def case(width, n_hidden, act, batch, gain=2.0):
        ws = _mlp_weights(gen, _shapes(32, width, n_hidden, 16), gain, dev)
        x = (torch.rand((batch, 32), generator=gen, device=dev) * 2 - 1).to(torch.bfloat16)
        g = (torch.rand((batch, 16), generator=gen, device=dev) * 2 - 1).to(torch.bfloat16)
        got = ffmlp_backward(x, g, ws, act, Activation.NONE)
        want = ffmlp_backward_plain(x, g, ws, act, Activation.NONE)
        torch.cuda.synchronize()
        name = f"ffmlp_bwd w{width} h{n_hidden} {act.value} B{batch}"
        errs = [bwd_close(got[0], want[0], name + " dx")]
        errs += [bwd_close(a, b, f"{name} dW{i}") for i, (a, b) in enumerate(zip(got[1], want[1]))]
        return max(errs)

    n, worst = 0, 0.0
    for width in (16, 32, 64, 128):
        for n_hidden in (0, 2, 5):
            for act in (Activation.ReLU, Activation.Sigmoid, Activation.Sine):
                for batch in (1, 1000, B_FLAG):
                    worst = max(worst, case(width, n_hidden, act, batch))
                    n += 1
    for act in Activation:
        worst = max(worst, case(64, 2, act, 4096, gain=0.5 if act == Activation.Exponential else 2.0))
        n += 1
    log(f"kernel ffmlp_bwd: {n} cases (widths x depths {{0, 2, 5}} x ReLU/Sigmoid/Sine x B {{1, 1000, 2^18}}, "
        f"then all 10 activations at w64) match the plain backward ({TOL_BWD_NOTE}); worst max|diff| {worst:.3e}")
    ws = _mlp_weights(gen, _shapes(32, 64, 2, 16), 1.0, dev)
    x = (torch.rand((B_FLAG, 32), generator=gen, device=dev) * 2 - 1).to(torch.bfloat16)
    g = ((torch.rand((B_FLAG, 16), generator=gen, device=dev) * 2 - 1) * 1e-3).to(torch.bfloat16)
    got = ffmlp_backward(x, g, ws, Activation.ReLU, Activation.NONE)
    want = ffmlp_backward_plain(x, g, ws, Activation.ReLU, Activation.NONE)
    err = max([bwd_close(got[0], want[0], "ffmlp_bwd flagship dx")]
              + [bwd_close(a, b, f"ffmlp_bwd flagship dW{i}") for i, (a, b) in enumerate(zip(got[1], want[1]))])
    log(f"kernel ffmlp_bwd: flagship shapes (B 2^18, 32 -> 64 x2 -> 16, ReLU) max|diff| {err:.3e}")
    return {"x": x, "g": g, "ws": ws, "err": err}


ADAM_KNOBS = [
    {},
    {"l2_reg": 1e-4, "non_matrix_l2_reg": 1e-5},
    {"non_matrix_learning_rate_factor": 0.5},
    {"relative_decay": 1e-3, "absolute_decay": 1e-4},
    {"clipping_magnitude": 0.25, "gradient_clipping_magnitude": 0.5},
    {"adabound": True},
    {"optimize_matrix_params": False},
    {"optimize_non_matrix_params": False},
    {"skip_zero_grad_non_matrix_params": False},
    {"beta1": 0.5, "beta2": 0.9, "epsilon": 1e-15, "learning_rate": 1e-2},
]


def phase_adam():
    import torch

    from tcnn_tpu_torch.optimizers import AdamOptimizer

    dev = torch.device("cuda")
    n, n_matrix = 715760, 7168
    rng = np.random.default_rng(SEED + 3)
    worst = 0.0
    for hp in ADAM_KNOBS:
        opt = AdamOptimizer(hp)
        opt.allocate(n, [(1, n_matrix)])
        p0 = torch.from_numpy(rng.normal(0, 0.3, n).astype(np.float32)).to(dev)
        sk, sp, pk, pp = opt.init_state(dev), opt.init_state(dev), p0.clone(), p0.clone()
        for _ in range(3):
            g = rng.normal(0, 1, n).astype(np.float32) * 128
            g[n_matrix:][rng.random(n - n_matrix) < 0.1] = 0.0
            g = torch.from_numpy(g).to(dev)
            sp, pp = opt.step(sp, pp, g, 128.0, plain=True)
            sk, pk = opt.step(sk, pk, g, 128.0)
        torch.cuda.synchronize()
        check(torch.equal(sk["param_steps"], sp["param_steps"]), f"adam {hp}: param_steps differ")
        check(int(sk["step"]) == int(sp["step"]) == 3, f"adam {hp}: step count")
        for what, a, b in (("params", pk, pp), ("first moments", sk["first_moments"], sp["first_moments"]),
                           ("second moments", sk["second_moments"], sp["second_moments"])):
            check(torch.isfinite(a).all(), f"adam {hp}: non-finite {what}")
            check(torch.allclose(a, b, rtol=1e-6, atol=1e-7), f"adam {hp}: {what} differ "
                  f"(max {float((a - b).abs().max()):.3e})")
            worst = max(worst, float((a - b).abs().max()))
    log(f"kernel adam_step: n 715,760, n_matrix 7,168, {len(ADAM_KNOBS)} knob sets x 3 steps (10% of the non-matrix "
        f"gradients exactly zero): param_steps equal, params and moments within rtol 1e-6 atol 1e-7; "
        f"worst max|diff| {worst:.3e}")
    return {"err": worst, "opt": opt, "p": pk, "g": g, "state": sk}


GRAD_CLASSES = {"(none, fp32)": (0, 0), "(SR, fp32)": (2, 0), "(RN, bf16)": (1, 1), "(SR, bf16)": (2, 1)}
CLASS_TOL = {
    0: "per entry |kernel - plain| <= 1e-5 S, S = sum of |contribution| (fp32 atomics add in any order)",
    1: "||kernel - exact|| <= 2 ||plain - exact|| + 1e-6 ||S||, exact = the fp32 sum of the same rounded "
       "contributions (both round to bf16 at every add, in another order)",
}


def _class_check(got, plain, exact, S, acc, what):
    import torch

    check(got.shape == plain.shape and torch.isfinite(got).all(), f"{what}: bad output")
    if acc == 0:
        excess = float(((got - plain).abs() - 1e-5 * S).max())
        check(excess <= 1e-30, f"{what}: beyond 1e-5 S by {excess:.3e}")
    else:
        e_k, e_p = float((got - exact).norm()), float((plain - exact).norm())
        check(e_k <= 2 * e_p + 1e-6 * float(S.norm()), f"{what}: kernel error {e_k:.3e} > 2 x plain {e_p:.3e}")
    return float((got - plain).abs().max())


def phase_scatter(flagship):
    import torch

    from tcnn_tpu_torch.encodings import create_encoding
    from tcnn_tpu_torch.ops import grid_encode as ge
    from tcnn_tpu_torch.ops import scatter_rows as sr

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 4)
    enc = create_encoding(2, flagship["encoding"], alignment=16)
    x = torch.from_numpy(rng.uniform(0, 1, (B_FLAG, 2)).astype(np.float32)).to(dev)
    dy = torch.from_numpy(rng.normal(0, 1, (B_FLAG, 32)).astype(np.float32)).to(dev).to(torch.bfloat16)
    levels = enc._levels_on(dev)
    zero = torch.zeros((enc.n_levels, 2), dtype=torch.int32, device=dev)
    S = ge.grid_backward_plain(x, dy.float().abs(), levels, 2, ge.INTERP_LINEAR, zero)
    errs = {}
    for name, (contrib, acc) in GRAD_CLASSES.items():
        classes = torch.tensor([[contrib, acc]] * enc.n_levels, dtype=torch.int32, device=dev)
        got = ge.grid_backward(x, dy, levels, 2, ge.INTERP_LINEAR, classes)
        plain = ge.grid_backward_plain(x, dy, levels, 2, ge.INTERP_LINEAR, classes)
        exact = ge.grid_backward_plain(x, dy, levels, 2, ge.INTERP_LINEAR, torch.tensor(
            [[contrib, 0]] * enc.n_levels, dtype=torch.int32, device=dev))
        torch.cuda.synchronize()
        errs[name] = _class_check(got, plain, exact, S, acc, f"grid_bwd {name}")
        check(not got[S == 0].any(), f"grid_bwd {name}: an untouched entry is not zero")
        log(f"kernel grid_bwd: flagship encoding B=2^18 class {name}: matches the plain backward "
            f"({CLASS_TOL[acc]}); untouched entries exactly 0; max|diff| {errs[name]:.3e}")
    idx = torch.from_numpy(rng.integers(0, 64, B_FLAG).astype(np.int32)).to(dev)
    rows = torch.from_numpy(rng.normal(0, 1, (B_FLAG, 4)).astype(np.float32)).to(dev)
    S_rows = sr.scatter_rows_plain(idx, rows.abs(), 64)
    ints = torch.from_numpy(rng.integers(-2, 3, (B_FLAG, 4)).astype(np.float32)).to(dev)
    idx_spread = torch.from_numpy(rng.integers(0, 2**14, B_FLAG).astype(np.int32)).to(dev)
    s_errs = {}
    for name, (contrib, acc) in GRAD_CLASSES.items():
        acc_dtype = torch.bfloat16 if acc else torch.float32
        got = sr.scatter_rows(idx, rows, 64, contrib, acc_dtype)
        plain = sr.scatter_rows_plain(idx, rows, 64, contrib, acc_dtype)
        exact = sr.scatter_rows_plain(idx, rows, 64, contrib, torch.float32)
        s_errs[name] = _class_check(got, plain, exact, S_rows, acc, f"scatter_rows {name}")
        same = torch.equal(sr.scatter_rows(idx_spread, ints, 2**14, contrib, acc_dtype),
                           sr.scatter_rows_plain(idx_spread, ints, 2**14, contrib, acc_dtype))
        check(same, f"scatter_rows {name}: small-integer sums are not exact")
        log(f"kernel scatter_rows: 2^18 rows x 4 into 64 slots, class {name}: matches the plain scatter "
            f"({CLASS_TOL[acc]}); small-integer rows into 2^14 slots bitwise equal; max|diff| {s_errs[name]:.3e}")
    return {"enc": enc, "x": x, "dy": dy, "levels": levels, "grid_err": errs["(none, fp32)"],
            "scatter_err": s_errs["(none, fp32)"], "idx": idx, "rows": rows}


def _load_synthetic_image():
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "samples", "mlp_learning_an_image.py")
    spec = importlib.util.spec_from_file_location("_mlp_learning_an_image", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.synthetic_image(512)


def _clone_state(tree):
    import torch

    if isinstance(tree, dict):
        return {k: _clone_state(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _flat_state(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_state(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _compare_one_step(name, m, x, y, lr):
    """One step from the same state on the kernel path and on the plain path."""
    import torch

    trainer = m.trainer
    p0, s0 = trainer.params.clone(), _clone_state(trainer.opt_state)
    loss_k = trainer.training_step(x, y)
    p_k, s_k = trainer.params.clone(), _clone_state(trainer.opt_state)
    trainer.params = p0
    trainer.opt_state = _clone_state(s0)
    loss_p = trainer.training_step_plain(x, y)
    p_p, s_p = trainer.params.clone(), trainer.opt_state
    torch.cuda.synchronize()
    check(torch.isfinite(loss_k) and torch.isfinite(p_k).all(), f"{name}: non-finite kernel step")
    rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    check(rel <= 1e-4, f"{name}: one-step loss kernel {float(loss_k)} vs plain {float(loss_p)}")
    # One Adam step from zero moments moves a param by about lr * sign(grad):
    # a gradient that is tiny on one path and of the other sign (or zero) on
    # the other moves it by up to 2 lr.
    d = (p_k - p_p).abs()
    moved = float((d > 1e-6).float().mean())
    check(float(d.max()) <= 2 * lr * 1.0001 and moved <= 1e-2,
          f"{name}: params max|diff| {float(d.max()):.3e}, {moved:.2e} of them differ")
    fk, fp = _flat_state(s_k), _flat_state(s_p)
    for key in fk:
        a, b = fk[key], fp[key]
        if a.dtype == torch.int32:
            share = float((a != b).float().mean())
            check(share <= 1e-2, f"{name}: state {key} differs at {share:.2e} of the entries")
        else:
            rel_n = float((a - b).norm()) / max(float(b.norm()), 1e-30)
            check(rel_n <= 1e-2, f"{name}: state {key} relative difference {rel_n:.3e}")
    log(f"train [{name}]: one step from the same state, kernel vs plain path: loss {float(loss_k):.6f} vs "
        f"{float(loss_p):.6f} (rel {rel:.2e}); params max|diff| {float(d.max()):.3e} ({moved:.2e} of them "
        f"differ: Adam's first step is ~lr x sign(grad), bound 2 lr and 1%); optimizer state within 1e-2 "
        f"relative (norm), step counts at most 1% different")
    trainer.params = p0
    trainer.opt_state = s0


def _psnr(m, image):
    h, w, _ = image.shape
    pred = m.trainer.inference_raster((w, h)).cpu().numpy().reshape(h, w, 3)
    mse = float(np.mean((pred.astype(np.float64) - image.astype(np.float64)) ** 2))
    return -10 * np.log10(mse)


def _extra_fit(cfg, image, seed):
    """Another 1000-step fit from another sampler seed; returns its PSNR."""
    import torch

    import tcnn_tpu_torch as tt
    from tcnn_tpu_torch.utils.sampling import stratified_uniform

    m = tt.create_from_config(2, 3, cfg, seed=SEED, device="cuda")
    h, w, _ = image.shape
    img = torch.from_numpy(image).cuda().reshape(h * w, 3)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for _ in range(N_TRAIN_STEPS):
        xy = stratified_uniform(B_FLAG, 2, gen)
        ij = torch.clamp((xy[:, 1] * h).long(), 0, h - 1) * w + torch.clamp((xy[:, 0] * w).long(), 0, w - 1)
        m.training_step(xy, img[ij])
    check(torch.isfinite(m.params).all(), f"fit with sampler seed {seed}: non-finite params")
    return _psnr(m, image)


def phase_train(name, cfg, card, image):
    import torch

    import tcnn_tpu_torch as tt
    from tcnn_tpu_torch.ops import ffmlp, fused_adam, grid_encode
    from tcnn_tpu_torch.utils.sampling import stratified_uniform

    dev = torch.device("cuda")
    m = tt.create_from_config(2, 3, cfg, seed=SEED, device="cuda")
    check(m.params.is_cuda and m.model.n_params == 715760, f"{name}: model not on the card")
    h, w, _ = image.shape
    img = torch.from_numpy(image).to(dev).reshape(h * w, 3)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def batch():
        xy = stratified_uniform(B_FLAG, 2, gen)
        ij_y = torch.clamp((xy[:, 1] * h).to(torch.int64), 0, h - 1)
        ij_x = torch.clamp((xy[:, 0] * w).to(torch.int64), 0, w - 1)
        return xy, img[ij_y * w + ij_x]

    lr = float(m.trainer.learning_rate)
    _compare_one_step(name, m, *batch(), lr)

    counters = (ffmlp, "LAUNCHES"), (grid_encode, "LAUNCHES"), (ffmlp, "BWD_LAUNCHES"), \
        (fused_adam, "LAUNCHES"), (grid_encode, "BWD_LAUNCHES")
    for mod, attr in counters:
        setattr(mod, attr, 0)
    losses, step_ms = [], []
    t_start = time.perf_counter()
    for i in range(N_TRAIN_STEPS):
        xy, target = batch()
        if i >= 100:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        losses.append(m.training_step(xy, target))
        if i >= 100:
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = {k: getattr(mod, attr) for k, (mod, attr) in zip(KERNELS, counters)}
    losses = torch.stack(losses).float().cpu().numpy()
    check(np.isfinite(losses).all() and torch.isfinite(m.params).all(), f"{name}: non-finite loss or params")
    check(torch.isfinite(m.trainer.inference_params()).all(), f"{name}: non-finite inference params")
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    check(last < 0.1 * first, f"{name}: loss did not fall ({first:.4e} -> {last:.4e})")
    for k, v in launches.items():
        check(v > 0, f"{name}: kernel {k} was not launched on the training path")
    psnrs = [_psnr(m, image)]
    med = statistics.median(step_ms)
    log(f"train [{name}]: {N_TRAIN_STEPS} steps at B=2^18 on stratified batches of the synthetic 512^2 image: "
        f"loss {first:.4e} (mean of steps 0-9) -> {last:.4e} (steps {N_TRAIN_STEPS - 10}-{N_TRAIN_STEPS - 1}), "
        f"all finite; kernel launches {launches}")
    psnrs += [_extra_fit(cfg, image, SEED + k) for k in range(1, N_FITS[name])]
    psnr = float(np.median(psnrs))
    log(f"train [{name}]: PSNR of inference_raster((512, 512)) vs the image {psnr:.3f} dB, median of "
        f"{len(psnrs)} fits from independent sampler seeds (mean {np.mean(psnrs):.3f}, range {min(psnrs):.2f}-"
        f"{max(psnrs):.2f}; each: {', '.join(f'{p:.2f}' for p in psnrs)}; floor {PSNR_FLOOR[name]} dB; the JAX "
        f"package read {JAX_TPU_PSNR[name]} dB on a TPU v5e)")
    check(psnr >= PSNR_FLOOR[name], f"{name}: PSNR {psnr:.2f} dB below {PSNR_FLOOR[name]} dB")
    log(f"time [{card}]: training_step [{name}] B=2^18: {med:.4f} ms/step, {B_FLAG / med * 1e3:.4e} samples/s "
        f"(host clock + synchronize, median of steps 100-{N_TRAIN_STEPS - 1}); {N_TRAIN_STEPS} steps with the "
        f"batch sampling in {wall:.2f} s")
    return {"launches": launches, "psnr": psnr, "ms": med, "loss": (first, last)}


def _event_ms(fn, iters=10, reps=7):
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def _host_ms(fn, reps=11):
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_times(card, k1, k2, m, x_np, kb, ks):
    import torch

    from tcnn_tpu_torch.common import Activation
    from tcnn_tpu_torch.ops import grid_encode as ge
    from tcnn_tpu_torch.ops import scatter_rows as sr
    from tcnn_tpu_torch.ops.ffmlp import ffmlp_backward, ffmlp_backward_plain, ffmlp_forward, ffmlp_forward_plain
    from tcnn_tpu_torch.optimizers import AdamOptimizer

    x, ws = k1["x"], k1["ws"]
    relu, none = Activation.ReLU, Activation.NONE
    t = {}
    # Kernel and plain alternate (plain, kernel, kernel, plain) and each
    # takes the median of both of its runs.
    order = ("plain", "kernel", "kernel", "plain")
    enc, params, xg, _ = k2["flagship"]
    enc.output_dtype = torch.bfloat16
    # Adam at the flagship's size and hyperparameters, stepping in place.
    opt = AdamOptimizer({"learning_rate": 1e-2, "beta2": 0.99, "epsilon": 1e-15, "l2_reg": 1e-6})
    opt.allocate(715760, m.model.layer_sizes())
    a_state, a_params = opt.init_state("cuda"), m.trainer.params.clone()
    a_grads = torch.randn(715760, device="cuda") * 128
    classes = torch.zeros((ks["enc"].n_levels, 2), dtype=torch.int32, device="cuda")
    fns = {
        ("kernel", "k1"): lambda: ffmlp_forward(x, ws, relu, none),
        ("plain", "k1"): lambda: ffmlp_forward_plain(x, ws, relu, none),
        ("kernel", "k2"): lambda: enc.apply(params, xg),
        ("plain", "k2"): lambda: enc.apply_plain(params, xg),
        ("kernel", "ffmlp_bwd"): lambda: ffmlp_backward(kb["x"], kb["g"], kb["ws"], relu, none),
        ("plain", "ffmlp_bwd"): lambda: ffmlp_backward_plain(kb["x"], kb["g"], kb["ws"], relu, none),
        ("kernel", "adam_step"): lambda: opt.step(a_state, a_params, a_grads, 128.0),
        ("plain", "adam_step"): lambda: opt.step(a_state, a_params, a_grads, 128.0, plain=True),
        ("kernel", "grid_bwd"): lambda: ge.grid_backward(ks["x"], ks["dy"], ks["levels"], 2, ge.INTERP_LINEAR,
                                                         classes, enc.n_params, False),
        ("plain", "grid_bwd"): lambda: ge.grid_backward_plain(ks["x"], ks["dy"], ks["levels"], 2,
                                                              ge.INTERP_LINEAR, classes),
        ("kernel", "scatter_rows"): lambda: sr.scatter_rows(ks["idx"], ks["rows"], 64),
        ("plain", "scatter_rows"): lambda: sr.scatter_rows_plain(ks["idx"], ks["rows"], 64),
    }
    timed = ("k1", "k2", "ffmlp_bwd", "adam_step", "grid_bwd", "scatter_rows")
    runs = {which: {"kernel": [], "plain": []} for which in timed}
    with torch.no_grad():
        for which in timed:
            for kind in order:
                runs[which][kind].append(_event_ms(fns[(kind, which)]))
        xd = torch.from_numpy(x_np).cuda()
        t["inference_ms"] = _host_ms(lambda: m.inference(xd))
        server = m.trainer.freeze_serving()
        t["raster_ms"] = _host_ms(lambda: server.raster(1024))
    for which in timed:
        for kind in ("kernel", "plain"):
            t[f"{which}_{kind}_ms"] = statistics.median(runs[which][kind])
    log(f"time [{card}]: kernel1 ffmlp_fwd B=2^18 32->64x2->16: kernel {t['k1_kernel_ms']:.4f} ms, "
        f"plain chain {t['k1_plain_ms']:.4f} ms (CUDA events, median)")
    log(f"time [{card}]: kernel2 grid_fwd flagship B=2^18: kernel {t['k2_kernel_ms']:.4f} ms, "
        f"plain lookup {t['k2_plain_ms']:.4f} ms (CUDA events, median)")
    log(f"time [{card}]: Trainer.inference B=2^18 (device input): {t['inference_ms']:.4f} ms "
        f"(host clock + synchronize, median of 11)")
    log(f"time [{card}]: FrozenServer.raster 1024x1024: {t['raster_ms']:.4f} ms "
        f"(host clock + synchronize, median of 11)")
    shapes = {
        "ffmlp_bwd": "B=2^18 32->64x2->16 ReLU (dx and dW)",
        "adam_step": "715,760 params, flagship hyperparameters",
        "grid_bwd": "flagship encoding B=2^18, class (none, fp32)",
        "scatter_rows": "2^18 rows x 4 into 64 slots, fp32",
    }
    for which, shape in shapes.items():
        log(f"time [{card}]: kernel {which} {shape}: kernel {t[which + '_kernel_ms']:.4f} ms, plain "
            f"{t[which + '_plain_ms']:.4f} ms (CUDA events, median)")
    return t


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import tcnn_tpu_torch  # noqa: F401
        from __graft_entry__ import FLAGSHIP_CONFIG
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})", file=sys.stderr)
        return 1
    check("jax" not in sys.modules and "tcnn_tpu" not in sys.modules, "the port must not import jax")

    # The plain chain's fp32 matmuls must keep full fp32 products and sums
    # (exact for bf16 operands); TF32 would round the operands' sums.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = gpu_name_and_limit()
    log(card)
    log(f"device: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    phase_build()
    log(f"build: all five kernel libraries in {time.perf_counter() - t0:.1f} s")
    k1 = phase_kernel1()
    k2 = phase_kernel2(FLAGSHIP_CONFIG)
    m, launches, x_flag = phase_slice(FLAGSHIP_CONFIG)
    kb = phase_mlp_backward()
    ka = phase_adam()
    ks = phase_scatter(FLAGSHIP_CONFIG)

    from tcnn_tpu_torch import load_config

    image = _load_synthetic_image()
    configs = {
        "FLAGSHIP_CONFIG": FLAGSHIP_CONFIG,
        "config_hash_strat_sr_ema.json": load_config(os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "benchmarks", "configs", "config_hash_strat_sr_ema.json")),
    }
    trained = {name: phase_train(name, cfg, card, image) for name, cfg in configs.items()}
    t = phase_times(card, k1, k2, m, x_flag, kb, ks)
    check("jax" not in sys.modules and "tcnn_tpu" not in sys.modules, "the port must not import jax")

    # launches: the serving path's counts for the two forward kernels (its
    # own kernels), the first training run's for the others; every count
    # was checked > 0 on its path above. scatter_rows is the generic row
    # scatter (the classes of the JAX one-hot and serial scatters), not a
    # kernel of either path.
    train = trained["FLAGSHIP_CONFIG"]["launches"]

    def entry(name, source, replaces, launches_, err, which, path):
        return {"name": name, "route": "cuda", "source": f"tcnn_tpu_torch/csrc/{source}", "replaces": replaces,
                "launches": launches_, "max_abs_err": err, "ms": t[f"{which}_kernel_ms"],
                "plain_ms": t[f"{which}_plain_ms"], "path": path}

    kernels = [
        entry("ffmlp_fwd", "ffmlp_fwd.cu", "tcnn_tpu/ops/ffmlp.py:271", launches["ffmlp_fwd"], k1["err"], "k1",
              "serving"),
        entry("grid_fwd", "grid_fwd.cu", "tcnn_tpu/encodings/grid.py:1354", launches["grid_fwd"],
              k2["flagship"][3], "k2", "serving"),
        entry("ffmlp_bwd", "ffmlp_bwd.cu", "tcnn_tpu/ops/ffmlp.py:838", train["ffmlp_bwd"], kb["err"],
              "ffmlp_bwd", "training"),
        entry("adam_step", "adam_step.cu", "tcnn_tpu/ops/fused_adam.py:122", train["adam_step"], ka["err"],
              "adam_step", "training"),
        entry("grid_bwd", "grid_bwd.cu", "tcnn_tpu/ops/scatter_rows.py:259", train["grid_bwd"], ks["grid_err"],
              "grid_bwd", "training"),
        entry("scatter_rows", "grid_bwd.cu", "tcnn_tpu/ops/scatter_rows.py:68", 0, ks["scatter_err"],
              "scatter_rows", "none"),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
