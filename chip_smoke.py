#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tcnn_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py  (~10 min on an H100)

Phases, each printing lines of its own; any failure exits non-zero:

1. device: needs CUDA (no CPU fallback); prints the card's name and power
   limit as nvidia-smi reports them.
2. build: compiles every kernel library of tcnn_tpu_torch/csrc (KERNELS),
   one nvcc each, all started together.
3. kernel 1 (fused MLP forward) against its plain chain, over widths x
   depths x activation pairs x batch sizes (ragged last tiles: 1, 15, 17,
   31, 33, 1000, 2^18 + 7), every activation as the hidden and as the
   output one, then at the flagship's shapes, where two calls give the same
   bits.
3b. the spherical-harmonics kernels (forward and input gradient) against
   their plain versions on both routes (vector: the padding that fills a
   row's last 16-byte vector; staged: one column more): degrees 1-8, fp32
   and bf16 output, bf16 and fp32 dL/dy, B in {1, 31, 1000, 2^18 + 7}, a
   strided (B, 6)[:, 3:] input and a contiguous one, each launch moving its
   route's count; two calls give the same bits; then both timed at the NeRF
   path's shapes (benchmarks.sh_times: device time cold over a ring of
   buffers beyond L2 and warm, call time, each beside the bytes bound).
   The double backward (tcnn_sh_backward_backward, the input gradient's
   vjp) against autograd of the plain vjp: degrees 1-8, bf16 and fp32
   dL/dy, each need flag, the same batches, a strided input with a
   misaligned dL/dy and a contiguous one; then SH_PENALTY_STEPS module-API
   steps of the NeRF sample's network at 2^18 samples whose loss adds a
   penalty on the squared gradient in the direction columns (create_graph):
   one kernel launch a step, no plain double backward on the card, one
   step's parameter gradient against the same step through apply_plain;
   timed at the NeRF shapes and at degree 8 with fp32 dL/dy.
4. kernel 2 (grid lookup) against its plain version: the flagship encoding
   at B = 2^18 plus cell-boundary points and points outside [0, 1]; again
   with table_dtype bfloat16 and with the CoherentPrime (XOR) hash, each
   also bitwise against the earlier lookup kernel (v1) in fp32 and bf16
   output; then the encoding's own table_dtype level by level (rounded_levels: a stratified
   2^18 batch in bf16 and fp16, the 1024^2 raster, gather_strategy fused,
   quad_fused and per_level), forward and input gradient (G1) against the
   plain path.
5. the serving slice: create_from_config(FLAGSHIP_CONFIG, device="cuda"),
   random parameters from a numpy seed, inference at B in {1, 4097, 2^18},
   inference_raster 1024^2 and a FrozenServer batch and raster, each
   checked against the plain path on the card; both kernels' launch
   counters must rise during this phase.
6. the fused MLP backward (K2: the walk, the split-K weight gradient and
   its reduce) against its plain version: widths x depths x activations x
   batch sizes, all ten activations, in 128 at 128 x 5, an empty batch and
   batches that are no multiple of a tile, the flagship's shapes; two
   calls give the same bits.
7. the fused Adam step against its plain version at the flagship's
   715,760 params, over the optimizer's knobs, three steps each.
8. the table gradient (flagship encoding, B = 2^18 uniform points) and the
   generic row scatter (2^18 rows into 64 slots: private blocks for fp32
   sums; small integers into 2^14 slots: vector atomics) against their
   plain versions in the four gradient classes; the table gradient level by
   level in each level's class on a stratified flagship batch (its own
   classes and factored_sr) and on the 3D model at 2^18 (13 levels add in
   bf16).
9. the packed-I/O MLP (K7/K8) against its block-diagonal plain versions at
   the reference's MLP benchmark protocol (B = 2^20, widths 16/32/64, 3 and
   0 hidden layers, a ragged row count), then the protocol through
   FullyFusedMLP.apply_packed: inference and training elements/s.
10. the grid's input gradient (G1) and double backward (G2) against their
   plain versions on the 3D model at B = 2^18 with cell-boundary points:
   Linear, Smoothstep, table_dtype bfloat16, scatter_strategy factored_sr.
11. the module-API slice: modules.NetworkWithInputEncoding on the 3D model
   (13.0 M params, on the card by default) fitting a sphere SDF with an
   eikonal term through torch.optim.Adam: one step kernel vs plain, then
   300 steps at B = 2^18; the loss falls below a tenth, everything stays
   finite and every kernel of the path shows launches.
12. the training slice, FLAGSHIP_CONFIG and
   benchmarks/configs/config_hash_strat_sr_ema.json: one step from the
   same state on the kernel path and on the plain path, then 1000 steps at
   B = 2^18 on stratified batches of the synthetic 512^2 image; the loss
   falls, everything stays finite, the PSNR of the fitted image clears its
   floor, and every training kernel's launch counter rises.
12b. the captured step (Trainer.training_steps: one training step captured
   as a CUDA graph and replayed): both configs 20 steps through the graph
   against 20 training_step calls from the same seed on the same batches
   (first loss bitwise, then 1e-4 relative; params and inference params
   max |diff| <= 2 lr and 1e-2 relative in norm, beside the same loop run
   twice), the counts at 0 just before the call and read just after
   (warm-up and capture launch each kernel; each replay repeats them); the
   flagship's synced ms/step through the graph and the loop, each with the
   batch drawn on the card, in turns, and their profiled busy time and
   idle share; serialize(True) -> json.dumps -> deserialize and save_npz /
   load_npz give bitwise equal inference and optimizer state, and training
   resumes from each as from the original; SGD, Novograd, Average, Batched,
   Lookahead, ExponentialDecay, Composite, Shampoo and the seven other
   losses 5 steps each on a small grid model through both paths.
12c. the NeRF path: samples.nerf_synthetic at its own CONFIG (Composite
   of a 8-level 2^15 hash grid and SH degree 3 into FFMLP 64 x 2, 256,480
   params) for 600 steps of 8192 rays x 32 samples, every count at 0 just
   before and read just after: the loss falls, the validation PSNR clears
   its floor, the served render's frames/s, and the lookup, K1, K2, the
   table gradient, K3 and the SH kernel (its vector route) each launch; one step kernel vs
   plain and the step's profile; then tests/test_nerf_config.py's
   NERF_CONFIG 20 steps through training_steps against 20 training_step
   calls (the graph-vs-loop tolerances).
12d. the grid extras and the trainer's extras at the flagship's width (B =
   2^18): the Rng hash's lookup (bitwise), table gradient, G1 and G2, the
   fixed-point lookup and table gradient (uint32 positions) and the
   stochastic table gradient (the same uniforms; its own classes and every
   level (RN, bf16)) against their plain versions, then timed beside the
   CoherentAdditive kernels, with the Rng bound from this run's set bits as
   the kernels hash a cell (the per-corner jump's count beside it, and the
   share of (sample, Rng level) pairs that took it);
   then FLAGSHIP_CONFIG with each extra in turn (hash Rng,
   fixed_point_pos on uint32 points, stochastic_interpolation through the
   Trainer, Shampoo, perturbation_sigma 0.1): one step kernel vs plain
   from the same state, 100 steps through training_steps with the counts
   at 0 just before and read just after, the loss halving, and the
   replayed ms/step (Shampoo's beside Adam's, and one eager Shampoo
   step); and the one-corner gradient through
   NetworkWithInputEncoding.apply(rng=generator) with torch.optim.Adam:
   its gradient kernel vs plain on the same uniforms, then 100 steps.
12e. the remaining samples and the host sampler, each count at 0 just before
   its path and read just after, each with the card's name and power limit:
   samples.sdf_learning at its CONFIG (8 levels of 2^15, Smoothstep,
   CutlassMLP, the trainer's Adam kernel): total_loss and its parameter
   gradient kernel vs plain, one step kernel vs plain, fit() at its defaults
   held to the JAX sample test's criteria (loss below a fifth, validation
   sdf-l2 < 5e-3, eikonal < 0.5), ms/step and the profile;
   samples.realtime_render --steps 300 --side 512 --frames 120, a static and
   a moving frame against the plain path with the same frozen params, both
   frame rates and the launches a frame; samples.fused_ray_marcher's Marcher
   (one CUDA graph of all 64 steps) against the eager march through the
   kernels (bit for bit) and the plain march (bf16 bound), replays
   repeatable, launches at capture and in replays, ms a render graph beside
   eager, at the sample's params and at random tables, then the sample's
   main; utils.data.HostImageSampler native, its contract on the 512^2
   image, batches/s, and 100 FLAGSHIP_CONFIG steps fed from it beside the
   same steps fed from the card.
12f. the multi-GPU layer (tcnn_tpu_torch.parallel) on the one card: the
   windowed lookup and table gradient of a row-sharded table against their
   plain versions (the flagship encoding over 2 and 3 shards, the 3D model
   over 2 and 4, with cell-boundary points; the shards' sum against the
   unsharded lookup and gradient); then ranks spawned on cuda:0 (each loads
   the built libraries and imports no jax): (a) DataParallelTrainer over a
   one-rank NCCL mesh, 5 FLAGSHIP_CONFIG steps at 2^18 beside the plain
   Trainer in the same process (first loss bitwise); (b) 2 gloo ranks, 20
   steps at global 2^18 against the single trainer (one all_reduce a step,
   replicas bitwise equal); (c) TableParallelTrainer on the --protocol 3d
   model over a (1, 2) mesh at 2^18 and a (2, 2) mesh of 4 ranks at 2^16
   (the windowed kernels launched, the unsharded grid kernels not); (d)
   FrozenServer over 2 gloo ranks, a 2^18 batch and the 1024^2 raster
   against the single server; each path held against the single trainer
   (PAR_LOSS_RTOL's note), with ms/step beside the single trainer's and
   each rank's peak memory beside its; then the windowed kernels timed at
   the 3D model's shard 0 of 2 beside their plain versions.
12g. higher orders, at the 3D model's and the flagship's width: the
   windowed input gradient and double backward (G1, G2 of a rank of a
   row-sharded table; the 3D model's shard 0 of 2 at 2^18 plus cell-boundary
   points), the third order G3 (the 3D model at 2^16 plus cell-boundary
   points, every cotangent and the curvature loss's) and the windowed G3
   (shard 0 of 2) and the sampled-corner gather (the flagship encoding, fp32
   and uint32 positions; bitwise) against their plain versions and timed
   beside them with their bounds (G3 also beside G2 at 2^16), the
   fixed_point_pos cotangent lookup against its plain version; then, each
   count at 0 just before its path and read just after: the
   curvature-regularised SDF fit through modules.NetworkWithInputEncoding
   (L2 + eikonal + mean |H v|^2, whose parameter gradient is a third
   derivative: G3 once a step), one step kernel vs plain, 200 steps at B =
   2^16 with torch.optim.Adam, the loss falling below three quarters,
   ms/step beside the eikonal-only step's and PR 24's; a table-gradient
   penalty through stochastic interpolation (the sampled-corner gather) and
   through fixed_point_pos, 20 steps each; one curvature step of the 3D TP
   model over a (1, 2) mesh of 2 gloo ranks against the single process (the
   windowed G1, G2 and G3 launched, the unsharded ones not).
13. times (CUDA events / synced host clock, median of repeats), each
   kernel's bound from its shapes (bytes over 3.35 TB/s or operations over
   the peak of their type) and, where one PyTorch call computes the same
   function, that call's time; K1's and K3's device time a call beside
   their call time; G1 and G2 (cgx only, and with cgp) at the
   SDF path's shapes beside the 3D lookup and table gradient, with their
   row0 and no-scatter variants, plain versions and compiler report
   (benchmarks.grid_second_order_times); the table gradient and the plain version
   in turns at three shapes (the stratified flagship batch, uniform
   flagship points, the 3D model in its training classes), beside one
   index_add_ of the precomputed (row, contribution) pairs; the lookup
   against the earlier kernel (v1) in turns at four shapes (stratified and
   uniform flagship batches, the 3D model, the 1024^2 raster) with both
   kernels' SASS instruction counts; the row scatter beside index_add_ in
   device and call time at 2^18 x 4 into 64 slots and the P3 and P19
   shapes (benchmarks.lookup_scatter_times); K2 and the plain version in
   turns at the flagship, at 128 x 5 with in 128 and at the K8 view, and
   its walk and weight gradient on their own (the latter beside
   torch.matmul(D_l.T, H_l) over the layers).
14. probes: the row gather and scatter probes (P1-P19) at their default
   shapes, each kernel against its plain version (gathers, tile sums,
   copies and STORE_LAST bit-exact; ADD within 1e-6 of the sum of
   |contributions| per entry; the gather-dot within 1e-5 of max |plain|),
   out-of-range rows reading zeros from every source (SHARED also from a
   table 4 bytes off alignment, ASYNC also in groups of 16 rows); then the
   path, tcnn_tpu_torch.benchmarks.probe_rows --sweep with every count at
   0 (and the gather's launches by route, its SHARED and ASYNC routes among
   them): the
   probes and the gather and scatter-add at the grid's row widths (F = 2, 8;
   S = 2^12 .. 2^23; B = 2^18 and 2^24; and the 3D model's own 6,522,408-row
   table at F = 2, B = 2^24) per source, ns/row beside the bytes
   bound and the library call (index_select, index_add_); the device time
   (events around a call whose issue the device cannot see) and call time
   (events over back-to-back calls) of each probe case and of the JSON
   shape, kernel beside library call, and the host's microseconds a whole
   call at P5 C1's size, the wrapper beside torch.gather; the redesigned
   probe kernels and the modes next in line under torch.profiler beside
   their bounds (P2, P18, P8 and P9 also beside the L2 route on the same
   inputs), and the redesigned kernels' registers (a spill fails).
15. floors: the grid kernels' random rows (lookup on uniform and
   stratified flagship points, v1 beside it, and in 3D; table gradient on
   the stratified batch, uniform points and the 3D model, G1, G2) against the
   probe sweep's fastest measured rate per operation and table size (over
   every source and the library call, named; the 3D kernels at the 3D
   model's own table), beside their measured times.
16. benches: the port's entry points, each count at 0 before and read after:
   benchmarks.bench (the 2D default with its phase-locked secondary,
   --protocol 3d, --reference-verbatim, --serving), bench_mlp, bench_image
   and the image-fit sample for 1000 steps; every value finite, every
   training run's final loss below its first, the sample's PSNR at least
   30 dB.

The second-to-last line is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import itertools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 20261016
B_FLAG = 2**18
B_SDF = 2**18
TOL_NOTE = "p99 RAE <= 1e-2 and max|diff| <= 4 bf16 ulps of max|ref| (fp32 sums in another order flip bf16 roundings)"
TOL_BWD_NOTE = (
    "||kernel - plain|| <= 1e-2 ||plain|| and at most 0.1% of the entries beyond 4 bf16 ulps of max|ref| (dW "
    "entries are long fp32 sums that cancel, so entrywise relative errors of small entries mean nothing; a "
    "derivative that jumps, ReLU's at 0 or a bf16 rounding of the recomputed forward, turns an fp32 sum-order "
    "difference into an O(1) change of a few entries)"
)
KERNELS = ("ffmlp_fwd", "grid_fwd", "ffmlp_bwd", "adam_step", "grid_bwd", "grid_input_grad", "grid_bwd_rng",
           "grid_bwd_modes", "probe_rows", "sh_encode", "grid_sharded", "grid_third_order")
N_TRAIN_STEPS = 1000
# PSNR floors of the 1000-step fits (dB) and the JAX package's TPU v5e
# readings beside them (benchmarks/golden_strat_sr/metrics.json; the
# pair-class run without EMA, DOCUMENTATION.md:275).
PSNR_FLOOR = {"FLAGSHIP_CONFIG": 44.5, "config_hash_strat_sr_ema.json": 47.0}
JAX_TPU_PSNR = {"FLAGSHIP_CONFIG": 47.3, "config_hash_strat_sr_ema.json": 53.226}
# Independent fits (sampler seeds) whose median PSNR is held to the floor.
# Without EMA the served weights are the last step's, which dither at the
# constant learning rate: single 1000-step fits of FLAGSHIP_CONFIG spread
# from 38.8 to 49.3 dB around a median of ~45.8 dB on an H100 (52 fits; the
# JAX package's own no-EMA goldens read 45.0-47.3 dB on a TPU v5e), so one
# fit, or the mean of a few with their long lower tail, would pass or fail
# the floor by chance. The EMA config averages that dither away. Three
# runs on an H100 gave medians of 46.01 (64 fits), 45.19 (64) and 45.37 dB
# (128 fits); the 192 fits of the last two have a median of 45.375 dB, a
# standard deviation of 2.9 dB and 46% of single fits below 45 dB. The
# median of n fits has a standard error of ~1.2533 x 2.9 / sqrt(n) dB
# (0.32 at n = 128), so a floor of 45 dB, 0.375 dB under the median, would
# be missed by chance in ~12% of runs; at 44.5 dB, ~0.3% (2.7% with 64
# fits). Hence 44.5 dB on the median of 128 fits; a broken training path
# loses far more (the loss, one-step and PSNR checks of the SR + EMA
# config stand beside it).
N_FITS = {"FLAGSHIP_CONFIG": 128, "config_hash_strat_sr_ema.json": 1}
# The first N_EAGER_FITS of those fits take eager ``training_step`` calls,
# the rest replay one captured step (``training_steps``), and the eager
# fits' median is also held to a floor of its own, so that a fault of the
# eager path alone shows: the median of 16 fits has a standard error of
# ~1.2533 x 2.9 / 4 = 0.91 dB, and 42.5 dB lies 3.2 of them under the
# 45.375 dB median above (~0.1% of runs by chance).
N_EAGER_FITS = 16
EAGER_PSNR_FLOOR = 42.5


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
    from tcnn_tpu_torch.benchmarks.grid_second_order_times import demangle, parse_ptxas
    from tcnn_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build_libraries_timed(KERNELS)
    dt = time.perf_counter() - t0
    for name, (path, seconds) in built.items():
        src = os.path.relpath(_build.CSRC / f"{name}.cu")
        log(f"build: {src} -> {os.path.relpath(path)} ({seconds:.1f} s; all {len(built)} in parallel: {dt:.1f} s)")
        logfile = path.with_suffix(".log")
        if logfile.exists():
            report = parse_ptxas(logfile.read_text())
            readable = demangle(report)
            for fn, r in report.items():
                log(f"  ptxas: {_kernel_name(readable[fn])}: {r['registers']} registers, spill stores "
                    f"{r['spill_stores']} / loads {r['spill_loads']} bytes")


def _kernel_name(readable: str) -> str:
    """A demangled kernel name without its return type and parameter list:
    ``void ns::k<(int)64, (int)2>(ns::Args)`` -> ``ns::k<(int)64, (int)2>``."""
    depth, cut = 0, len(readable)
    for i in range(len(readable) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(readable[i], 0)
        if depth == 0 and readable[i] == "(":
            cut = i
            break
    return readable[:cut].removeprefix("void ").strip()


def _mlp_weights(gen, shapes, gain, device):
    """Uniform weights at gain / sqrt(fan_in), bf16 views of one buffer in
    flat-parameter order, as a network's layers are."""
    import torch

    flat = torch.cat([((torch.rand((rows * cols,), generator=gen, device=device) * 2 - 1) * (gain / np.sqrt(cols)))
                      for rows, cols in shapes]).to(torch.bfloat16)
    ws, off = [], 0
    for rows, cols in shapes:
        ws.append(flat[off:off + rows * cols].view(rows, cols))
        off += rows * cols
    return ws


def _shapes(in_w, width, n_hidden, out_w):
    if n_hidden == 0:
        return [(out_w, in_w)]
    return [(width, in_w)] + [(width, width)] * (n_hidden - 1) + [(out_w, width)]


# Batches of phase 3: one row, ragged last tiles around the kernel's 16- and
# 32-row warp tiles, and the flagship batch plus a ragged tail.
K1_BATCHES = (1, 15, 17, 31, 33, 1000, B_FLAG + 7)


def phase_kernel1():
    import torch

    from tcnn_tpu_torch.common import Activation
    from tcnn_tpu_torch.ops.ffmlp import ffmlp_forward, ffmlp_forward_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n = 0
    worst = 0.0
    acts = ((Activation.ReLU, Activation.NONE), (Activation.Sigmoid, Activation.Tanh),
            (Activation.Sine, Activation.Sigmoid))
    for width in (16, 32, 64, 128):
        for n_hidden in (0, 2, 5):
            for act, out_act in acts:
                ws = _mlp_weights(gen, _shapes(32, width, n_hidden, 16), 2.0, dev)
                for batch in K1_BATCHES:
                    x = (torch.rand((batch, 32), generator=gen, device=dev) * 2 - 1).to(torch.bfloat16)
                    got = ffmlp_forward(x, ws, act, out_act)
                    want = ffmlp_forward_plain(x, ws, act, out_act)
                    torch.cuda.synchronize()
                    worst = max(worst, bf16_close(got, want, f"ffmlp w{width} h{n_hidden} {act.value}/"
                                                              f"{out_act.value} B{batch}"))
                    n += 1
    # Every activation as the hidden one and as the output one, at the
    # flagship's shapes on a ragged batch.
    ws = _mlp_weights(gen, _shapes(32, 64, 2, 16), 1.0, dev)
    x = (torch.rand((B_FLAG + 7, 32), generator=gen, device=dev) * 2 - 1).to(torch.bfloat16)
    for a in Activation:
        for act, out_act in ((a, Activation.NONE), (Activation.ReLU, a)):
            worst = max(worst, bf16_close(ffmlp_forward(x, ws, act, out_act), ffmlp_forward_plain(x, ws, act, out_act),
                                          f"ffmlp flagship shapes {act.value}/{out_act.value} B{B_FLAG + 7}"))
            n += 1
    log(f"kernel1: {n} cases match the plain chain ({TOL_NOTE}); batches {K1_BATCHES}, every activation as the "
        f"hidden and as the output one; worst max|diff| {worst:.3e}")
    ws = _mlp_weights(gen, _shapes(32, 64, 2, 16), 1.0, dev)
    x = (torch.rand((B_FLAG, 32), generator=gen, device=dev) * 2 - 1).to(torch.bfloat16)
    got = ffmlp_forward(x, ws, Activation.ReLU, Activation.NONE)
    want = ffmlp_forward_plain(x, ws, Activation.ReLU, Activation.NONE)
    err = bf16_close(got, want, "ffmlp flagship shapes")
    check(torch.equal(got, ffmlp_forward(x, ws, Activation.ReLU, Activation.NONE)),
          "ffmlp flagship shapes: two calls on the same inputs differ")
    log(f"kernel1: flagship shapes (B 2^18, 32 -> 64 x2 -> 16, ReLU) max|diff| {err:.3e}; two calls give the same bits")
    return {"x": x, "ws": ws, "err": err}


def _boundary_points(scales, rng, per_level=256, dims=2):
    pts = []
    for s in scales:
        s32 = np.float32(s)
        k = rng.integers(0, int(np.ceil(s)) + 2, size=(per_level, dims)).astype(np.float32)
        x = (k - np.float32(0.5)) / s32
        pts += [x, np.nextafter(x, np.float32(np.inf)), np.nextafter(x, np.float32(-np.inf))]
    return np.concatenate(pts)


def phase_kernel2(flagship):
    import torch

    from tcnn_tpu_torch.encodings import create_encoding
    from tcnn_tpu_torch.encodings.grid import _INTERP_CODES as INTERP_CODES
    from tcnn_tpu_torch.ops import grid_encode as ge

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    results, v1_err = {}, 0.0
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
        # The earlier kernel (v1) on the same level table: bitwise equal.
        lv, interp = enc._levels_on(dev), INTERP_CODES[enc.interpolation_type]
        for dt in (torch.float32, torch.bfloat16):
            args = (x, params, lv, 2, enc.padded_output_width, interp, dt)
            new, old = ge.grid_encode(*args), ge.grid_encode_v1(*args)
            check(torch.equal(new.view(torch.int16 if dt == torch.bfloat16 else torch.int32),
                              old.view(torch.int16 if dt == torch.bfloat16 else torch.int32)),
                  f"grid {name}: the new kernel's {dt} output differs from the earlier kernel's")
            if dt == torch.float32:
                v1_err = max(v1_err, float((old - want).abs().max()))
        log(f"kernel2: {name}: {len(x_np)} points (2^18 uniform, 4096 outside [0,1], "
            f"{len(x_np) - B_FLAG - 4096} on cell boundaries) match the plain lookup "
            f"(fp32 rtol 1e-5 atol 1e-6), max|diff| {err:.3e}; bf16 output = rounded fp32; fp32 and bf16 outputs "
            f"bitwise equal to the earlier kernel (v1)")
        results[name] = (enc, params, x[:B_FLAG].contiguous(), err)
    results["v1_err"] = v1_err
    return results


def phase_own_table_dtype(flagship):
    """The encoding's own table_dtype on the card, the cases of
    tests/test_torch_port_grid.py (OWN_CASES) at the flagship's size: the
    kernels read fp32 on the levels the JAX package gathers unrounded
    (static levels of a stratified batch, separable levels of the raster,
    "fused", "quad_fused") and round the others; forward and input gradient
    (G1) against the plain path. Returns the forward's max |diff|."""
    import torch

    from tcnn_tpu_torch.encodings import create_encoding
    from tcnn_tpu_torch.ops import grid_encode as ge
    from tcnn_tpu_torch.utils.sampling import raster_centers_torch, stratified_uniform

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    bf16 = {"table_dtype": "bfloat16"}
    cases = {  # name: (config overrides, inputs, levels whose reads round)
        "stratified batch, bfloat16": (bf16, "stratified", 5),
        "stratified batch, float16": ({"table_dtype": "float16"}, "stratified", 5),
        "stratified raster 1024^2, bfloat16": (bf16, "raster", 5),
        "gather_strategy fused, bfloat16": (dict(bf16, gather_strategy="fused"), "uniform", 0),
        "gather_strategy quad_fused, bfloat16": (dict(bf16, gather_strategy="quad_fused"), "uniform", 0),
        "gather_strategy per_level, bfloat16": (dict(bf16, gather_strategy="per_level"), "uniform", 16),
    }
    worst = 0.0
    ge.LAUNCHES = ge.INPUT_LAUNCHES = 0
    for name, (over, kind, n_rounded) in cases.items():
        enc = create_encoding(2, dict(flagship["encoding"], **over), alignment=16)
        enc.output_dtype = torch.float32
        params = torch.rand(enc.n_params, generator=gen, device=dev) * 2 - 1
        if kind == "raster":
            with torch.no_grad():
                got = enc.apply_raster(params, 1024)
                want = enc._encode(params, raster_centers_torch(1024, 2, dev), None, plain=True,
                                   raster_sides=(1024, 1024))
            rounded, what = enc.rounded_levels(None, (1024, 1024)), "forward"
        else:
            x = (stratified_uniform(B_FLAG, 2, gen, device=dev) if kind == "stratified"
                 else torch.rand((B_FLAG, 2), generator=gen, device=dev))
            w = torch.randn((B_FLAG, 32), generator=gen, device=dev)
            outs = []
            for fn in (enc.apply, enc.apply_plain):
                xr = x.clone().requires_grad_(True)
                y = fn(params, xr)
                outs.append((y.detach(), torch.autograd.grad((y * w).sum(), xr)[0]))
            (got, dx), (want, dx_plain) = outs
            f32_close(dx, dx_plain, f"own table_dtype {name}: input gradient")
            rounded, what = enc.rounded_levels(B_FLAG), "forward and input gradient"
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(sum(rounded) == n_rounded, f"own table_dtype {name}: {sum(rounded)} rounded levels, not {n_rounded}")
        check(torch.allclose(got, want, rtol=1e-5, atol=1e-6), f"own table_dtype {name}: max|diff| {err:.3e}")
        worst = max(worst, err)
        log(f"kernel2: own table_dtype, flagship encoding, {name}: {n_rounded} of 16 levels round their reads "
            f"(rounded_levels, as the JAX package); {what} match the plain path (fp32 rtol 1e-5 atol 1e-6; "
            f"{TOL_F32_NOTE}), max|diff| {err:.3e}")
    check(ge.LAUNCHES > 0 and ge.INPUT_LAUNCHES > 0, "own table_dtype: the lookup or G1 kernel did not launch")
    return worst


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
    errs = {"dx": 0.0, "dW": 0.0}

    def case(width, n_hidden, act, batch, gain=2.0, in_w=32):
        ws = _mlp_weights(gen, _shapes(in_w, width, n_hidden, 16), gain, dev)
        x = (torch.rand((batch, in_w), generator=gen, device=dev) * 2 - 1).to(torch.bfloat16)
        g = (torch.rand((batch, 16), generator=gen, device=dev) * 2 - 1).to(torch.bfloat16)
        got = ffmlp_backward(x, g, ws, act, Activation.NONE)
        want = ffmlp_backward_plain(x, g, ws, act, Activation.NONE)
        torch.cuda.synchronize()
        name = f"ffmlp_bwd in{in_w} w{width} h{n_hidden} {act.value} B{batch}"
        if batch == 0:
            check(got[0].shape == (0, in_w) and all(not d.any() and d.shape == w.shape for d, w in zip(got[1], ws)),
                  f"{name}: an empty batch must give dx (0, {in_w}) and zero dW")
            return 0.0
        e_dx = bwd_close(got[0], want[0], name + " dx")
        e_dw = max(bwd_close(a, b, f"{name} dW{i}") for i, (a, b) in enumerate(zip(got[1], want[1])))
        errs["dx"], errs["dW"] = max(errs["dx"], e_dx), max(errs["dW"], e_dw)
        return max(e_dx, e_dw)

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
    # bench_image's shape (in 128, 128 x 5); an empty batch; a batch that is
    # no multiple of a 16-row tile, a 32-row K tile or the split's rows.
    for width, n_hidden, batch, in_w in ((128, 5, B_FLAG, 128), (128, 5, 1000, 128), (64, 2, 0, 32),
                                         (128, 5, 0, 128), (64, 2, B_FLAG + 4097, 32), (128, 5, 100_003, 128)):
        worst = max(worst, case(width, n_hidden, Activation.ReLU, batch, in_w=in_w))
        n += 1
    log(f"kernel ffmlp_bwd (walk + split-K dW + reduce): {n} cases (widths x depths {{0, 2, 5}} x ReLU/Sigmoid/Sine x "
        f"B {{1, 1000, 2^18}}, all 10 activations at w64, in 128 at 128 x 5 with B 2^18 and 1000, B = 0, "
        f"B = 2^18 + 4097 and 100,003) match the plain backward ({TOL_BWD_NOTE}); worst max|diff| {worst:.3e}")
    ws = _mlp_weights(gen, _shapes(32, 64, 2, 16), 1.0, dev)
    x = (torch.rand((B_FLAG, 32), generator=gen, device=dev) * 2 - 1).to(torch.bfloat16)
    g = ((torch.rand((B_FLAG, 16), generator=gen, device=dev) * 2 - 1) * 1e-3).to(torch.bfloat16)
    got = ffmlp_backward(x, g, ws, Activation.ReLU, Activation.NONE)
    want = ffmlp_backward_plain(x, g, ws, Activation.ReLU, Activation.NONE)
    err = max([bwd_close(got[0], want[0], "ffmlp_bwd flagship dx")]
              + [bwd_close(a, b, f"ffmlp_bwd flagship dW{i}") for i, (a, b) in enumerate(zip(got[1], want[1]))])
    log(f"kernel ffmlp_bwd: flagship shapes (B 2^18, 32 -> 64 x2 -> 16, ReLU) max|diff| {err:.3e}")
    # Determinism: no atomics, partials summed in split order.
    for what, (w_shapes, batch) in {"flagship": (_shapes(32, 64, 2, 16), B_FLAG),
                                    "128 x 5, in 128": (_shapes(128, 128, 5, 16), 100_003)}.items():
        wd = _mlp_weights(gen, w_shapes, 2.0, dev)
        xd = (torch.rand((batch, w_shapes[0][1]), generator=gen, device=dev) * 2 - 1).to(torch.bfloat16)
        gd = (torch.rand((batch, 16), generator=gen, device=dev) * 2 - 1).to(torch.bfloat16)
        a = ffmlp_backward(xd, gd, wd, Activation.Sine, Activation.NONE)
        b = ffmlp_backward(xd, gd, wd, Activation.Sine, Activation.NONE)
        torch.cuda.synchronize()
        check(torch.equal(a[0], b[0]) and all(torch.equal(u, v) for u, v in zip(a[1], b[1])),
              f"ffmlp_bwd {what}: two calls on the same inputs differ")
        log(f"kernel ffmlp_bwd: determinism at {what}, B = {batch}: two calls give bit-identical dx and dW")
    return {"x": x, "g": g, "ws": ws, "err": err, "err_dx": max(errs["dx"], err), "err_dw": max(errs["dW"], err)}


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
    # The stratified flagship batch (the training path's layout) in the
    # flagship's own classes and under factored_sr, and the 3D model at 2^18
    # in its training classes (13 levels add in bf16), level by level in each
    # level's class.
    from tcnn_tpu_torch.utils.sampling import stratified_uniform

    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    x_strat = stratified_uniform(B_FLAG, 2, gen, device=dev)
    enc3 = create_encoding(3, ENC3D, alignment=16)
    x3 = torch.rand((B_FLAG, 3), generator=gen, device=dev)
    dy3 = torch.randn((B_FLAG, 32), generator=gen, device=dev).bfloat16()
    cases = {
        "flagship stratified B=2^18, its classes": (enc, x_strat, dy),
        "flagship stratified B=2^18, factored_sr": (
            create_encoding(2, dict(flagship["encoding"], scatter_strategy="factored_sr"), alignment=16), x_strat, dy),
        "3D model B=2^18, its training classes": (enc3, x3, dy3),
    }
    for name, (e, xx, dd) in cases.items():
        classes = torch.from_numpy(e.gradient_classes(B_FLAG)).to(dev)
        got = ge.grid_backward(xx, dd, e._levels_on(dev), 2, ge.INTERP_LINEAR, classes)
        errs[name] = _levels_check(e, got, xx, dd, classes, f"grid_bwd {name}")
        plan = ge.backward_plan(e.level_table(), 2, B_FLAG, classes)
        log(f"kernel grid_bwd: {name}: matches the plain backward level by level in each level's class "
            f"({CLASS_TOL[0]}; bf16 levels: {CLASS_TOL[1]}); untouched entries exactly 0; levels privatised "
            f"{[l for l, p in enumerate(plan.privatised) if p]}; max|diff| {errs[name]:.3e}")
    idx = torch.from_numpy(rng.integers(0, 64, B_FLAG).astype(np.int32)).to(dev)
    rows = torch.from_numpy(rng.normal(0, 1, (B_FLAG, 4)).astype(np.float32)).to(dev)
    S_rows = sr.scatter_rows_plain(idx, rows.abs(), 64)
    ints = torch.from_numpy(rng.integers(-2, 3, (B_FLAG, 4)).astype(np.float32)).to(dev)
    idx_spread = torch.from_numpy(rng.integers(0, 2**14, B_FLAG).astype(np.int32)).to(dev)
    s_errs = {}
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, (contrib, acc) in GRAD_CLASSES.items():
        acc_dtype = torch.bfloat16 if acc else torch.float32
        private = [sr.scatter_rows_plan(B_FLAG, S, 4, acc, n_sms).private for S in (64, 2**14)]
        check(private[1] == 0 and (private[0] > 0) == (acc == 0),
              f"scatter_rows {name}: the plan privatises {private} blocks at 64 / 2^14 slots")
        got = sr.scatter_rows(idx, rows, 64, contrib, acc_dtype)
        plain = sr.scatter_rows_plain(idx, rows, 64, contrib, acc_dtype)
        exact = sr.scatter_rows_plain(idx, rows, 64, contrib, torch.float32)
        s_errs[name] = _class_check(got, plain, exact, S_rows, acc, f"scatter_rows {name}")
        same = torch.equal(sr.scatter_rows(idx_spread, ints, 2**14, contrib, acc_dtype),
                           sr.scatter_rows_plain(idx_spread, ints, 2**14, contrib, acc_dtype))
        check(same, f"scatter_rows {name}: small-integer sums are not exact")
        log(f"kernel scatter_rows: 2^18 rows x 4 into 64 slots ({private[0]} private blocks), class {name}: matches "
            f"the plain scatter ({CLASS_TOL[acc]}); small-integer rows into 2^14 slots (vector atomics, no private "
            f"block) bitwise equal; max|diff| {s_errs[name]:.3e}")
    # The JSON line's error: the fp32-accumulation comparisons (a bf16 sum's
    # difference is a few bf16 ulps of the sum, held by CLASS_TOL instead).
    fp32_cases = ("(none, fp32)", "(SR, fp32)", "flagship stratified B=2^18, its classes",
                  "flagship stratified B=2^18, factored_sr")
    return {"enc": enc, "x": x, "dy": dy, "levels": levels, "grid_err": max(errs[k] for k in fp32_cases),
            "scatter_err": s_errs["(none, fp32)"], "idx": idx, "rows": rows,
            "x_strat": x_strat, "enc3": enc3, "x3": x3, "dy3": dy3}


def _levels_check(enc, got, x, dy, classes, what, u=None):
    """The table gradient level by level in its class against the plain
    version: fp32 sums within 1e-5 S per entry, bf16 sums at most twice the
    plain sum's error against the fp32 sum of the same rounded contributions
    (CLASS_TOL); untouched entries exactly 0. ``u``: stochastic
    interpolation's uniforms, the plain version's too. Returns max |kernel
    - plain|."""
    import torch

    from tcnn_tpu_torch.ops import grid_encode as ge
    from tcnn_tpu_torch.ops.scatter_rows import ACC_BF16, ACC_F32

    levels, F = enc._levels_on(x.device), enc.n_features_per_level
    plain = ge.grid_backward_plain(x, dy, levels, F, ge.INTERP_LINEAR, classes, u)
    f32 = classes.clone()
    f32[:, 1] = torch.where(f32[:, 1] == ACC_BF16, ACC_F32, f32[:, 1])
    exact = ge.grid_backward_plain(x, dy, levels, F, ge.INTERP_LINEAR, f32, u)
    S = ge.contribution_magnitudes(x, dy, levels, F, ge.INTERP_LINEAR, u)
    torch.cuda.synchronize()
    check(got.shape == plain.shape and bool(torch.isfinite(got).all()), f"{what}: bad output")
    for lvl in range(enc.n_levels):
        lo, hi = int(enc.offset_table[lvl]) * F, int(enc.offset_table[lvl + 1]) * F
        acc = int(classes[lvl, 1])
        _class_check(got[lo:hi], plain[lo:hi], exact[lo:hi], S[lo:hi], 1 if acc == ACC_BF16 else 0,
                     f"{what} level {lvl}")
    check(not got[S == 0].any(), f"{what}: an untouched entry is not zero")
    return float((got - plain).abs().max())


def _load_synthetic_image():
    from tcnn_tpu_torch.samples.mlp_learning_an_image import synthetic_image

    return synthetic_image(512)


def _clone_state(tree):
    import torch

    if isinstance(tree, dict):
        return {k: _clone_state(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone_state(v) for v in tree]
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _flat_state(tree, prefix=""):
    if isinstance(tree, (dict, list)):
        out = {}
        for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
            out.update(_flat_state(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _compare_one_step(name, m, lr, step):
    """One step from the same state on the kernel path and on the plain
    path: ``step(plain)`` takes it (on the plain path with ``plain`` True)
    and returns the loss."""
    import torch

    trainer = m.trainer
    p0, s0 = trainer.params.clone(), _clone_state(trainer.opt_state)
    loss_k = step(False)
    p_k, s_k = trainer.params.clone(), _clone_state(trainer.opt_state)
    trainer.params = p0
    trainer.opt_state = _clone_state(s0)
    loss_p = step(True)
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


def _extra_fit(cfg, image, seed, eager: bool):
    """Another 1000-step fit from another sampler seed; returns its PSNR.
    ``eager``: ``training_step`` calls; else ``Trainer.training_steps``'
    replays of one captured step (the step ``training_step`` takes, its
    batch drawn on the card from the sampler's generator, registered with
    the graph, so each replay draws anew), without the host's 1-3 ms a
    step, which set most of this script's time over 127 eager fits."""
    import torch

    import tcnn_tpu_torch as tt
    from tcnn_tpu_torch.utils.sampling import stratified_uniform

    m = tt.create_from_config(2, 3, cfg, seed=SEED, device="cuda")
    h, w, _ = image.shape
    img = torch.from_numpy(image).cuda().reshape(h * w, 3)
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def drawn(d, i):
        xy = stratified_uniform(B_FLAG, 2, d["gen"])
        ij = torch.clamp((xy[:, 1] * h).long(), 0, h - 1) * w + torch.clamp((xy[:, 0] * w).long(), 0, w - 1)
        return xy, img[ij]

    if eager:
        losses = torch.stack([m.training_step(*drawn({"gen": gen}, i)) for i in range(N_TRAIN_STEPS)])
    else:
        losses = m.trainer.training_steps(drawn, N_TRAIN_STEPS, {"gen": gen})
    check(bool(torch.isfinite(losses).all()) and bool(torch.isfinite(m.params).all()),
          f"fit with sampler seed {seed}: non-finite losses or params")
    return _psnr(m, image)


def phase_train(name, cfg, card, image):
    import torch

    import tcnn_tpu_torch as tt
    from tcnn_tpu_torch.utils.profiling import profile_steps
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
    x, y = batch()
    t = m.trainer
    _compare_one_step(name, m, lr, lambda plain: (t.training_step_plain if plain else t.training_step)(x, y))

    _zero_counts(TRAIN_COUNTERS)
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
    launches = _read_counts(TRAIN_COUNTERS)
    losses = torch.stack(losses).float().cpu().numpy()
    check(np.isfinite(losses).all() and torch.isfinite(m.params).all(), f"{name}: non-finite loss or params")
    check(torch.isfinite(m.trainer.inference_params()).all(), f"{name}: non-finite inference params")
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    check(last < 0.1 * first, f"{name}: loss did not fall ({first:.4e} -> {last:.4e})")
    for k, v in launches.items():
        check(v > 0, f"{name}: kernel {k} was not launched on the training path")
    psnrs = [_psnr(m, image)]
    # After the fit's PSNR: 13 more steps, back to back, under the profiler.
    wall_p, busy, idle, kernels = profile_steps(lambda: m.training_step(*batch()))
    log(f"profile [{card}]: training_step [{name}] B=2^18, 10 steps back to back under torch.profiler: "
        f"{wall_p:.4f} ms/step, device busy {busy:.4f} ms, idle share {idle:.3f}, {len(kernels)} distinct device ops; "
        f"largest (ms/step): " + "; ".join(f"{k[:60]} {ms:.4f}" for k, ms in kernels[:8]))
    med = statistics.median(step_ms)
    log(f"train [{name}]: {N_TRAIN_STEPS} steps at B=2^18 on stratified batches of the synthetic 512^2 image: "
        f"loss {first:.4e} (mean of steps 0-9) -> {last:.4e} (steps {N_TRAIN_STEPS - 10}-{N_TRAIN_STEPS - 1}), "
        f"all finite; kernel launches {launches}")
    n_eager = min(N_EAGER_FITS, N_FITS[name])
    psnrs += [_extra_fit(cfg, image, SEED + k, k < n_eager) for k in range(1, N_FITS[name])]
    psnr = float(np.median(psnrs))
    if n_eager < len(psnrs):
        eager = float(np.median(psnrs[:n_eager]))
        log(f"train [{name}]: PSNR of the {n_eager} eager fits (training_step; the first {n_eager} above) median "
            f"{eager:.3f} dB (floor {EAGER_PSNR_FLOOR} dB), of the {len(psnrs) - n_eager} replayed "
            f"(training_steps) {float(np.median(psnrs[n_eager:])):.3f} dB")
        check(eager >= EAGER_PSNR_FLOOR, f"{name}: eager fits' median PSNR {eager:.2f} dB below {EAGER_PSNR_FLOOR} dB")
    log(f"train [{name}]: PSNR of inference_raster((512, 512)) vs the image {psnr:.3f} dB, median of "
        f"{len(psnrs)} fits from independent sampler seeds (mean {np.mean(psnrs):.3f}, range {min(psnrs):.2f}-"
        f"{max(psnrs):.2f}; each: {', '.join(f'{p:.2f}' for p in psnrs)}; floor {PSNR_FLOOR[name]} dB; the JAX "
        f"package read {JAX_TPU_PSNR[name]} dB on a TPU v5e)")
    check(psnr >= PSNR_FLOOR[name], f"{name}: PSNR {psnr:.2f} dB below {PSNR_FLOOR[name]} dB")
    log(f"time [{card}]: training_step [{name}] B=2^18: {med:.4f} ms/step, {B_FLAG / med * 1e3:.4e} samples/s "
        f"(host clock + synchronize, median of steps 100-{N_TRAIN_STEPS - 1}); {N_TRAIN_STEPS} steps with the "
        f"batch sampling in {wall:.2f} s")
    return {"launches": launches, "psnr": psnr, "ms": med, "loss": (first, last), "profile": dict(kernels)}


# The captured training step (Trainer.training_steps): steps each path
# runs against the training_step loop, and of the timed window.
N_GRAPH_STEPS = 20
N_TIMED_STEPS = 100
# The small grid model on which each new optimizer and loss runs five
# steps through both paths; Sigmoid keeps the predictions that
# CrossEntropy takes the log of, and Variance divides by, positive.
SMALL_CONFIG = {
    "encoding": {"otype": "HashGrid", "n_levels": 8, "n_features_per_level": 2, "log2_hashmap_size": 14,
                 "base_resolution": 8, "per_level_scale": 1.5},
    "network": {"otype": "FullyFusedMLP", "n_neurons": 64, "n_hidden_layers": 2, "output_activation": "Sigmoid"},
}
SMALL_OPTIMIZERS = [
    {"otype": "SGD", "learning_rate": 1e-1},
    {"otype": "Novograd", "learning_rate": 1e-2},
    {"otype": "Average", "n_samples": 4, "nested": {"otype": "Adam", "learning_rate": 1e-2}},
    {"otype": "Batched", "batch_size_multiplier": 2, "nested": {"otype": "Adam", "learning_rate": 1e-2}},
    {"otype": "Lookahead", "n_steps": 2, "nested": {"otype": "Adam", "learning_rate": 1e-2}},
    {"otype": "ExponentialDecay", "decay_base": 0.5, "decay_start": 2, "decay_interval": 2,
     "nested": {"otype": "Adam", "learning_rate": 1e-2}},
    {"otype": "Composite", "nested": [{"otype": "Novograd", "learning_rate": 1e-2, "n_params_to_optimize": 6144},
                                      {"otype": "EMA", "nested": {"otype": "Adam", "learning_rate": 1e-2}}]},
    {"otype": "Shampoo", "learning_rate": 1e-2},
]
SMALL_LOSSES = ["RelativeL2Luminance", "L1", "RelativeL1", "Mape", "Smape", "CrossEntropy", "Variance"]


def _image_batches(image, gen, n, batch):
    """``n`` stratified batches of the image, stacked on the card."""
    import torch

    from tcnn_tpu_torch.utils.sampling import stratified_uniform

    h, w, _ = image.shape
    img = torch.from_numpy(image).cuda().reshape(h * w, 3)
    xs = torch.stack([stratified_uniform(batch, 2, gen) for _ in range(n)])
    ij = torch.clamp((xs[..., 1] * h).long(), 0, h - 1) * w + torch.clamp((xs[..., 0] * w).long(), 0, w - 1)
    return {"x": xs, "t": img[ij]}


def _nth_batch(d, i):
    import torch

    idx = i.reshape(1).to(torch.int64)
    return torch.index_select(d["x"], 0, idx)[0], torch.index_select(d["t"], 0, idx)[0]


def _graph_vs_loop(name, graph, loop, data, n, lr, counters=None, again=None):
    """``n`` replays of the captured step on ``graph`` against ``n``
    training_step calls on ``loop`` from the same state on the same
    batches, held to _compare_one_step's tolerance: the first loss bitwise
    (the forward is deterministic), the others to 1e-4 relative; params and
    inference params max |diff| <= 2 lr (Adam's step is ~lr x sign(grad),
    and the table gradient's fp32 atomics add in another order, so a
    gradient near 0 may flip) and within 1e-2 relative in norm (its state
    bound; after many steps the atomics' differences reach most entries,
    as between two loops). With ``again`` (more trainers from the same
    seed) the same loop runs once more on each, and the losses are held to
    the larger of 1e-4 and twice the largest relative difference of those
    loops from the first: where the table gradient's fp32 atomics alone
    move two loops more than 1e-4 apart, the graph is held to the loop's
    own spread.
    Returns the two loss vectors, the largest relative loss difference,
    the params' largest difference and the ``counters`` (a
    TRAIN_COUNTERS-like table) of the training_steps call alone, set to 0
    just before it and read just after; with ``again`` also the loops'
    spread."""
    import torch

    if counters:
        _zero_counts(counters)
    got = graph.trainer.training_steps(_nth_batch, n, data)
    launches = _read_counts(counters) if counters else None
    def run_loop(m):
        return torch.stack([m.training_step(*_nth_batch(data, torch.tensor(k, device="cuda"))) for k in range(n)])

    want = run_loop(loop)
    spread = None if again is None else max(float(((run_loop(m) - want).abs() / want.abs()).max()) for m in again)
    torch.cuda.synchronize()
    check(torch.isfinite(got).all() and got.shape == (n,), f"{name}: non-finite or misshapen graph losses")
    check(torch.equal(got[0], want[0]), f"{name}: first loss graph {float(got[0])} vs loop {float(want[0])}")
    rel = float(((got - want).abs() / want.abs()).max())
    rtol = 1e-4 if spread is None else max(1e-4, 2 * spread)
    check(rel <= rtol, f"{name}: graph vs loop losses differ by {rel:.3e} relative (bound {rtol:.3e})")
    worst = 0.0
    for what, a, b in (("params", graph.params, loop.params),
                       ("inference params", graph.trainer.inference_params(), loop.trainer.inference_params())):
        d = (a - b).abs()
        rel_n = float((a - b).norm()) / max(float(b.norm()), 1e-30)
        check(torch.isfinite(a).all() and float(d.max()) <= 2 * lr * 1.0001 and rel_n <= 1e-2,
              f"{name}: {what} max|diff| {float(d.max()):.3e}, relative difference {rel_n:.3e} (norm)")
        worst = max(worst, float(d.max()))
    if again is not None:
        return got, want, rel, worst, launches, spread
    return got, want, rel, worst, launches


def _timed(fn, n_steps, reps=3):
    """Host clock around ``fn`` (``n_steps`` steps) between synchronisations;
    the median of ``reps`` calls, in ms a step."""
    import torch

    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3 / n_steps)
    return statistics.median(out), out


def phase_graph(card, configs, image):
    """Trainer.training_steps: one training step captured as a CUDA graph
    and replayed, against the training_step loop; its step time; the
    checkpoints; the ported optimizers and losses through both paths."""
    import tempfile

    import torch

    import tcnn_tpu_torch as tt
    from tcnn_tpu_torch.utils.profiling import profile_steps
    from tcnn_tpu_torch.utils import checkpoint
    from tcnn_tpu_torch.utils.sampling import stratified_uniform

    out = {}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    data = _image_batches(image, gen, N_GRAPH_STEPS, B_FLAG)
    flagship = None
    for name, cfg in configs.items():
        graph, loop, again = (tt.create_from_config(2, 3, cfg, seed=SEED, device="cuda") for _ in range(3))
        lr = float(loop.trainer.learning_rate)
        got, want, rel, worst, launches = _graph_vs_loop(name, graph, loop, data, N_GRAPH_STEPS, lr, TRAIN_COUNTERS)
        for k, v in launches.items():
            check(v > 0, f"{name}: kernel {k} was not launched by training_steps (warm-up and capture)")
        # The same loop again: how far two loops from one seed drift apart.
        for k in range(N_GRAPH_STEPS):
            again.training_step(*_nth_batch(data, torch.tensor(k, device="cuda")))
        d_gl, d_ll = graph.params - loop.params, again.params - loop.params
        log(f"graph [{name}]: training_steps({N_GRAPH_STEPS}) as one captured CUDA graph replayed vs "
            f"{N_GRAPH_STEPS} training_step calls, same seed and batches (B=2^18): losses {float(got[0]):.6f} -> "
            f"{float(got[-1]):.6f} vs {float(want[0]):.6f} -> {float(want[-1]):.6f}, first bitwise, max rel "
            f"{rel:.2e} (bound 1e-4); params and inference params max|diff| {worst:.3e} (bound 2 lr); params "
            f"graph vs loop max|diff| {float(d_gl.abs().max()):.3e}, norm {float(d_gl.norm()):.3e}, "
            f"{float((d_gl.abs() > 1e-6).float().mean()):.3f} of them beyond 1e-6; loop vs the same loop again "
            f"{float(d_ll.abs().max()):.3e}, {float(d_ll.norm()):.3e}, {float((d_ll.abs() > 1e-6).float().mean()):.3f} "
            f"(params norm {float(loop.params.norm()):.3e}); kernel launches of warm-up and capture (each replay "
            f"repeats the captured ones; counts at 0 just before the call, read just after): {launches}")
        out[name] = {"launches": launches, "rel": rel}
        if flagship is None:
            flagship = graph

    # Step time: the flagship step synced, batch drawn on the card, through
    # the graph and through training_step, in one call.
    h, w, _ = image.shape
    img = torch.from_numpy(image).cuda().reshape(h * w, 3)

    def batch(g):
        xy = stratified_uniform(B_FLAG, 2, g)
        return xy, img[torch.clamp((xy[:, 1] * h).long(), 0, h - 1) * w + torch.clamp((xy[:, 0] * w).long(), 0, w - 1)]

    def drawn(d, i):
        return batch(d["gen"])

    m = tt.create_from_config(2, 3, configs["FLAGSHIP_CONFIG"], seed=SEED, device="cuda")
    steps_data = {"gen": torch.Generator(device="cuda").manual_seed(SEED + 8)}
    loop_gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    t_cap = time.perf_counter()
    m.trainer.training_steps(drawn, N_TIMED_STEPS, steps_data)
    torch.cuda.synchronize()
    t_cap = time.perf_counter() - t_cap
    timings = {}
    for label, fn in (("training_step", lambda: [m.training_step(*batch(loop_gen)) for _ in range(N_TIMED_STEPS)]),
                      ("training_steps", lambda: m.trainer.training_steps(drawn, N_TIMED_STEPS, steps_data))):
        timings[label] = _timed(fn, N_TIMED_STEPS)
    # And in the other order, so that neither side always runs first.
    for label, fn in (("training_steps", lambda: m.trainer.training_steps(drawn, N_TIMED_STEPS, steps_data)),
                      ("training_step", lambda: [m.training_step(*batch(loop_gen)) for _ in range(N_TIMED_STEPS)])):
        ms, runs = _timed(fn, N_TIMED_STEPS)
        timings[label] = (timings[label][0], timings[label][1] + runs)
    profiles = {
        "training_step": profile_steps(lambda: m.training_step(*batch(loop_gen)), n=10),
        "training_steps": profile_steps(lambda: m.trainer.training_steps(drawn, 10, steps_data), n=2),
    }
    for label, per_call in (("training_step", 1), ("training_steps", 10)):
        wall_p, busy, idle, kernels = profiles[label]
        runs = timings[label][1]
        ms = statistics.median(runs)
        wall_p, busy = wall_p / per_call, busy / per_call
        log(f"time [{card}]: flagship {label} B=2^18 synced, batch drawn on the card: {ms:.4f} ms/step (median of "
            f"{len(runs)} windows of {N_TIMED_STEPS} steps: {', '.join(f'{r:.4f}' for r in runs)}); under "
            f"torch.profiler {wall_p:.4f} ms/step, device busy {busy:.4f} ms/step, idle share {idle:.3f} (1 - busy "
            f"/ the unprofiled synced time: {1 - busy / ms:.3f}); largest "
            f"(ms/call of {per_call} step(s)): " + "; ".join(f"{k[:50]} {v:.4f}" for k, v in kernels[:6]))
        out[f"{label}_ms"], out[f"{label}_busy_ms"], out[f"{label}_idle"] = ms, busy, idle
    log(f"time [{card}]: training_steps({N_TIMED_STEPS}) first call (warm-up, capture and {N_TIMED_STEPS} replays) "
        f"{t_cap:.3f} s; synced ms/step training_steps {out['training_steps_ms']:.4f} vs training_step "
        f"{out['training_step_ms']:.4f}")

    # Checkpoints of the Adam-only flagship trainer the graph trained.
    tr = flagship.trainer
    x = stratified_uniform(B_FLAG, 2, torch.Generator(device="cuda").manual_seed(SEED + 10))
    y_ref = tr.inference(x)
    t0 = time.perf_counter()
    text = json.dumps(tr.serialize(serialize_optimizer=True))
    fresh = tt.create_from_config(2, 3, configs["FLAGSHIP_CONFIG"], seed=SEED + 1, device="cuda")
    fresh.trainer.deserialize(json.loads(text))
    t_json = time.perf_counter() - t0
    check(torch.equal(fresh.trainer.inference(x), y_ref), "checkpoint: inference after serialize/deserialize differs")
    for k, v in tr.opt_state.items():
        check(torch.equal(fresh.trainer.opt_state[k], v), f"checkpoint: optimizer state {k} differs after JSON")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.npz")
        checkpoint.save_npz(path, tr)
        from_npz = tt.create_from_config(2, 3, configs["FLAGSHIP_CONFIG"], seed=SEED + 2, device="cuda")
        checkpoint.load_npz(path, from_npz.trainer)
    check(torch.equal(from_npz.trainer.inference(x), y_ref), "checkpoint: inference after save_npz/load_npz differs")
    for k, v in tr.opt_state.items():
        check(torch.equal(from_npz.trainer.opt_state[k], v), f"checkpoint: optimizer state {k} differs after npz")
    saved = tr.params.clone(), tt.optimizers.base.tree_map(torch.clone, tr.opt_state)
    resumed = []
    for other in (fresh, from_npz):
        tr.params, tr.opt_state = saved[0], tt.optimizers.base.tree_map(torch.clone, saved[1])
        a, b = _graph_vs_loop("resumed", flagship, other, data, 3, float(tr.learning_rate))[:2]
        resumed.append((float(a[-1]), float(b[-1])))
    log(f"checkpoint: serialize(True) -> json.dumps ({len(text) / 1e6:.1f} MB) -> deserialize in {t_json:.2f} s and "
        f"save_npz/load_npz of the flagship (715,760 params, Adam): inference bitwise equal on a 2^18 batch, "
        f"optimizer state bitwise equal; 3 steps resumed from each as the original (graph) and the restored "
        f"(loop) trainer, held as graph vs loop: last losses {resumed}")

    # The ported optimizers and losses on the small grid model, 5 steps
    # through training_steps against 5 through training_step.
    small = _image_batches(image, gen, 5, 2**14)
    results = []
    cases = [({"otype": "RelativeL2"}, o) for o in SMALL_OPTIMIZERS]
    cases += [({"otype": loss}, {"otype": "Adam", "learning_rate": 1e-2}) for loss in SMALL_LOSSES]
    for loss_cfg, opt_cfg in cases:
        cfg = dict(SMALL_CONFIG, loss=loss_cfg, optimizer=opt_cfg)
        label = f"{loss_cfg['otype']} + {opt_cfg['otype']}"
        g, lp = (tt.create_from_config(2, 3, cfg, seed=SEED, device="cuda") for _ in range(2))
        lr = max(float(lp.trainer.learning_rate), 1e-2)
        got, want, rel, worst, _ = _graph_vs_loop(label, g, lp, small, 5, lr)
        results.append(f"{label}: {float(got[0]):.4e} -> {float(got[-1]):.4e} (rel {rel:.1e}, params {worst:.1e})")
    log(f"graph: the ported optimizers and losses on a small grid model (8 levels, FFMLP 64x2, Sigmoid output, "
        f"B=2^14), 5 steps through training_steps vs training_step, the graph-vs-loop tolerance: " + "; ".join(results))
    return out


# The module-API slice on the repo's --protocol 3d model (bench.py:304-330,
# log2_hashmap_size 19 from bench.py:614): 13.0 M params, about 52 MB of
# fp32 table, more than the card's 50 MB L2.
ENC3D = {"otype": "HashGrid", "n_levels": 16, "n_features_per_level": 2, "log2_hashmap_size": 19,
         "base_resolution": 16, "per_level_scale": 1.5, "hash": "CoherentAdditive"}
NET3D = {"otype": "FullyFusedMLP", "n_neurons": 64, "n_hidden_layers": 2, "activation": "ReLU",
         "output_activation": "None"}
N_SDF_STEPS = 300
# Adam's learning rate: a linear warm-up to SDF_LR over SDF_WARMUP steps,
# then an exponential decay to SDF_LR_END at the last step.
SDF_LR, SDF_WARMUP, SDF_LR_END = 1e-2, 100, 1e-3
# The reference's MLP benchmark protocol (benchmarks/bench_mlp.py:23-80):
# B = 2^20, input = output = hidden width, 3 hidden layers, ReLU.
B_PACKED = 2**20
PACKED_WIDTHS = (16, 32, 64)
# Published peaks of one H100 SXM (NVIDIA's data sheet, dense) for the
# bounds: HBM bytes/s and operations/s by type; INT32 instructions a second
# (the Rng hash's bound): 132 SMs x 64 INT32 lanes (the Hopper architecture
# white paper: half the FP32 lanes) x 1.98 GHz, a multiply-add counted as
# one instruction.
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "fp32": 67e12, "int32": 132 * 64 * 1.98e9}
TOL_F32_NOTE = ("max|kernel - plain| <= 1e-5 max|plain| and ||kernel - plain|| <= 1e-5 ||plain|| (the same fp32 "
                "products; sums over levels, corners and dims in another order)")


def bound(n_bytes, n_ops, kind):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate and
    the operations over the peak rate of their type."""
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = n_ops / PEAK_OPS_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def f32_close(got, want, what: str) -> float:
    """Kernel vs plain, fp32 results: ``TOL_F32_NOTE``. Returns max |diff|."""
    got, want = got.float(), want.float()
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    check(bool(got.isfinite().all()), f"{what}: non-finite output")
    diff = (got - want).abs()
    err, scale = float(diff.max()), float(want.abs().max())
    rel = float(diff.norm()) / max(float(want.norm()), 1e-30)
    check(err <= 1e-5 * scale + 1e-30, f"{what}: max|diff| {err:.3e} > 1e-5 x {scale:.3e}")
    check(rel <= 1e-5, f"{what}: relative difference (norm) {rel:.3e} > 1e-5")
    return err


def phase_packed(card):
    """K7/K8 against their block-diagonal plain versions, then the
    bench_mlp protocol through FullyFusedMLP.apply_packed."""
    import torch

    from tcnn_tpu_torch.common import Activation
    from tcnn_tpu_torch.networks.fully_fused import FullyFusedMLP
    from tcnn_tpu_torch.ops import ffmlp
    from tcnn_tpu_torch.rng import make_rng

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    relu, none = Activation.ReLU, Activation.NONE
    n, worst_f, worst_b = 0, 0.0, 0.0
    for w in PACKED_WIDTHS:
        G = 128 // w
        for n_hidden in (3, 0):
            ws = _mlp_weights(gen, _shapes(w, w, n_hidden, w), 1.0, dev)
            for batch in (B_PACKED, G * 4099):  # 4099 packed rows: no multiple of a tile
                xp = torch.randn((batch // G, 128), generator=gen, device=dev).to(torch.bfloat16)
                gp = (torch.rand((batch // G, 128), generator=gen, device=dev) * 2 - 1).to(torch.bfloat16)
                name = f"packed w{w} h{n_hidden} B{batch}"
                got = ffmlp.ffmlp_forward_packed(xp, ws, relu, none)
                want = ffmlp.ffmlp_forward_packed_plain(xp, ws, relu, none)
                worst_f = max(worst_f, bf16_close(got, want, name + " forward"))
                dx, dws = ffmlp.ffmlp_backward_packed(xp, gp, ws, relu, none)
                dx_p, dws_p = ffmlp.ffmlp_backward_packed_plain(xp, gp, ws, relu, none)
                torch.cuda.synchronize()
                errs = [bwd_close(dx, dx_p, name + " dx")]
                errs += [bwd_close(a, b, f"{name} dW{i}") for i, (a, b) in enumerate(zip(dws, dws_p))]
                worst_b = max(worst_b, max(errs))
                n += 1
    log(f"kernel ffmlp_fwd_packed / ffmlp_bwd_packed: {n} cases (w in {PACKED_WIDTHS}, 3 and 0 hidden layers, "
        f"B = 2^20 and {4099} packed rows) match the block-diagonal plain versions (forward {TOL_NOTE}; backward "
        f"{TOL_BWD_NOTE}); worst max|diff| {worst_f:.3e} / {worst_b:.3e}")

    # The protocol, through the entry point, per width: inference, and
    # training as the gradient of sum(out) with respect to the params.
    out = {"err_fwd": worst_f, "err_bwd": worst_b}
    launches = {"ffmlp_fwd_packed": 0, "ffmlp_bwd_packed": 0}
    for w in PACKED_WIDTHS:
        net = FullyFusedMLP(input_width=w, output_width=w, n_neurons=w, n_hidden_layers=3)
        params = torch.from_numpy(net.initialize_params(make_rng(1337))).to(dev)
        p_train = params.clone().requires_grad_(True)
        x = np.random.default_rng(0).standard_normal((B_PACKED, w)).astype(np.float32)
        xp = torch.from_numpy(x).to(dev).to(torch.bfloat16).view(B_PACKED * w // 128, 128)

        def infer(params=params, net=net, xp=xp):
            with torch.no_grad():
                return net.apply_packed(params, xp)

        def train(net=net, xp=xp, p=p_train):
            return torch.autograd.grad(net.apply_packed(p, xp).float().sum(), p)[0]

        ffmlp.PACKED_LAUNCHES = ffmlp.PACKED_BWD_LAUNCHES = 0
        y, g = infer(), train()
        torch.cuda.synchronize()
        counts = (ffmlp.PACKED_LAUNCHES, ffmlp.PACKED_BWD_LAUNCHES)
        check(counts == (2, 1), f"packed w{w}: launches {counts}, expected (2, 1)")
        launches["ffmlp_fwd_packed"] += counts[0]
        launches["ffmlp_bwd_packed"] += counts[1]
        check(y.shape == (B_PACKED * w // 128, 128) and g.shape == params.shape, f"packed w{w}: shapes")
        with torch.no_grad():
            y_p = net.apply_packed_plain(params, xp)
        g_p = torch.autograd.grad(net.apply_packed_plain(p_train, xp).float().sum(), p_train)[0]
        e_y, e_g = bf16_close(y, y_p, f"packed w{w} inference"), bwd_close(g, g_p, f"packed w{w} gradient")
        t_inf, t_train = _host_ms(infer), _host_ms(train)
        out[w] = {"infer_ms": t_inf, "train_ms": t_train}
        log(f"time [{card}]: FullyFusedMLP.apply_packed w{w} 3 hidden B=2^20: inference {t_inf:.4f} ms "
            f"({B_PACKED / t_inf * 1e3:.4e} elements/s), training (grad of sum(out) wrt params) {t_train:.4f} ms "
            f"({B_PACKED / t_train * 1e3:.4e} elements/s) (host clock + synchronize, median of 11); output and "
            f"gradient match the plain path (max|diff| {e_y:.3e}, {e_g:.3e})")

    # Kernel against plain at the widest protocol shape, in turns.
    w = PACKED_WIDTHS[-1]
    ws = _mlp_weights(gen, _shapes(w, w, 3, w), 1.0, dev)
    xp = torch.randn((B_PACKED * w // 128, 128), generator=gen, device=dev).to(torch.bfloat16)
    gp = torch.ones((B_PACKED * w // 128, 128), dtype=torch.bfloat16, device=dev)
    fns = {
        ("kernel", "fwd"): lambda: ffmlp.ffmlp_forward_packed(xp, ws, relu, none),
        ("plain", "fwd"): lambda: ffmlp.ffmlp_forward_packed_plain(xp, ws, relu, none),
        ("kernel", "bwd"): lambda: ffmlp.ffmlp_backward_packed(xp, gp, ws, relu, none),
        ("plain", "bwd"): lambda: ffmlp.ffmlp_backward_packed_plain(xp, gp, ws, relu, none),
    }
    for which in ("fwd", "bwd"):
        runs = {"kernel": [], "plain": []}
        for kind in ("plain", "kernel", "kernel", "plain"):
            runs[kind].append(_event_ms(fns[(kind, which)]))
        out[which] = {k: statistics.median(v) for k, v in runs.items()}
    n_w = 4 * w * w
    out["fwd"]["bound"] = bound(2 * B_PACKED * w * 2 + n_w * 2, 2 * B_PACKED * n_w, "bf16")
    out["bwd"]["bound"] = bound(3 * B_PACKED * w * 2 + 2 * n_w * 2, 6 * B_PACKED * n_w, "bf16")
    for which in ("fwd", "bwd"):
        o = out[which]
        log(f"time [{card}]: kernel ffmlp_{which}_packed w{w} 3 hidden B=2^20: kernel {o['kernel']:.4f} ms, "
            f"plain (block-diagonal) {o['plain']:.4f} ms, bound {o['bound'][0]:.4f} ms ({o['bound'][1]}) "
            f"(CUDA events, median)")
    out["launches"] = launches
    return out


def _grid_inputs(cfg, rng, dev, batch, boundary=True):
    import torch

    from tcnn_tpu_torch.encodings import create_encoding

    enc = create_encoding(3, cfg, alignment=16)
    x_np = rng.uniform(0, 1, (batch, 3)).astype(np.float32)
    if boundary:
        x_np = np.concatenate([x_np, _boundary_points(enc.scales, rng, 256, dims=3).astype(np.float32)])
    t = {
        "enc": enc,
        "x": torch.from_numpy(x_np).to(dev),
        "params": torch.from_numpy(rng.uniform(-1, 1, enc.n_params).astype(np.float32)).to(dev),
        "dy": torch.from_numpy(rng.normal(0, 1, (len(x_np), 32)).astype(np.float32)).to(dev).to(torch.bfloat16),
        "cgx": torch.from_numpy(rng.normal(0, 1, (len(x_np), 3)).astype(np.float32)).to(dev),
        "cgp": torch.from_numpy(rng.normal(0, 1, enc.n_params).astype(np.float32)).to(dev),
    }
    t["classes_np"] = enc.gradient_classes(len(x_np))
    t["classes"] = torch.from_numpy(t["classes_np"]).to(dev)
    t["levels"] = enc._levels_on(dev)
    return t


def _grid_args(t):
    from tcnn_tpu_torch.encodings.grid import _INTERP_CODES

    return t["levels"], 2, _INTERP_CODES[t["enc"].interpolation_type]


def _table_grad_check(got, plain, exact, t, what):
    """The double backward's table gradient, level by level: fp32 sums
    within 1e-5 of the level's max |plain| (atomics add in any order); bf16
    sums at most twice the plain sequential sum's error against the fp32 sum
    of the same rounded contributions, in norm."""
    from tcnn_tpu_torch.ops.scatter_rows import ACC_BF16

    enc, F = t["enc"], 2
    check(got.shape == plain.shape and bool(got.isfinite().all()), f"{what}: bad output")
    for lvl in range(enc.n_levels):
        lo, hi = int(enc.offset_table[lvl]) * F, int(enc.offset_table[lvl + 1]) * F
        g, p, e = got[lo:hi], plain[lo:hi], exact[lo:hi]
        if t["classes_np"][lvl, 1] == ACC_BF16:
            e_k, e_p = float((g - e).norm()), float((p - e).norm())
            check(e_k <= 2 * e_p + 1e-6 * float(e.norm()), f"{what} level {lvl}: {e_k:.3e} > 2 x {e_p:.3e}")
        else:
            err = float((g - p).abs().max())
            check(err <= 1e-5 * float(p.abs().max()) + 1e-30, f"{what} level {lvl}: max|diff| {err:.3e}")
    return float((got - plain).abs().max())


def phase_grid_second_order():
    """G1 and G2 against their plain versions on the 3D model at B = 2^18
    plus cell-boundary points (+-1 ulp), in four variants."""
    import torch

    from tcnn_tpu_torch.ops import grid_encode as ge
    from tcnn_tpu_torch.ops.scatter_rows import ACC_F32

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 6)
    variants = {
        "Linear": ENC3D,
        "Smoothstep": dict(ENC3D, interpolation="Smoothstep"),
        "table_dtype bfloat16": dict(ENC3D, table_dtype="bfloat16"),
        "scatter_strategy factored_sr": dict(ENC3D, scatter_strategy="factored_sr"),
    }
    errs = {"g1": 0.0, "g2": 0.0}
    for name, cfg in variants.items():
        t = _grid_inputs(cfg, rng, dev, B_SDF)
        x, dy, params, cgx, cgp = t["x"], t["dy"], t["params"], t["cgx"], t["cgp"]
        args = _grid_args(t)
        got = ge.grid_backward_input(x, dy, params, *args)
        want = ge.grid_backward_input_plain(x, dy, params, *args)
        e1 = f32_close(got, want, f"grid_bwd_input {name}")
        exact_cls = t["classes"].clone()
        exact_cls[:, 1] = ACC_F32
        k = ge.grid_backward_backward(x, dy, params, *args, t["classes"], cgp, cgx)
        p = ge.grid_backward_backward_plain(x, dy, params, *args, t["classes"], cgp, cgx)
        exact = ge.grid_backward_backward_plain(x, dy, params, *args, exact_cls, cgp, cgx)[0]
        torch.cuda.synchronize()
        e2 = max(f32_close(k[1], p[1], f"grid_bwdbwd {name} d/dx"), f32_close(k[2], p[2], f"grid_bwdbwd {name} d/ddy"),
                 _table_grad_check(k[0], p[0], exact, t, f"grid_bwdbwd {name} d/dparams"))
        # Without a table-gradient cotangent (the eikonal path): same d/dx.
        k0 = ge.grid_backward_backward(x, dy, params, *args, t["classes"], None, cgx)
        p0 = ge.grid_backward_backward_plain(x, dy, params, *args, t["classes"], None, cgx)
        e2 = max(e2, f32_close(k0[1], p0[1], f"grid_bwdbwd {name} d/dx (cgx only)"))
        errs["g1"], errs["g2"] = max(errs["g1"], e1), max(errs["g2"], e2)
        log(f"kernel grid_bwd_input / grid_bwdbwd: 3D model, {name}: {len(x)} points (2^18 uniform, "
            f"{len(x) - B_SDF} on cell boundaries +-1 ulp) match the plain versions ({TOL_F32_NOTE}; table "
            f"gradient per level in its class, {t['classes_np'][:, 1].tolist()} accumulation codes); max|diff| "
            f"{e1:.3e} / {e2:.3e}")
    return errs


# The K2 counters: the backward as a whole and its two launches.
K2_COUNTERS = {
    "ffmlp_bwd": ("ffmlp", "BWD_LAUNCHES"), "ffmlp_bwd_walk": ("ffmlp", "WALK_LAUNCHES"),
    "ffmlp_bwd_dw": ("ffmlp", "DW_LAUNCHES"),
}
TRAIN_COUNTERS = {
    "ffmlp_fwd": ("ffmlp", "LAUNCHES"), "grid_fwd": ("grid_encode", "LAUNCHES"), **K2_COUNTERS,
    "adam_step": ("fused_adam", "LAUNCHES"), "grid_bwd": ("grid_encode", "BWD_LAUNCHES"),
}
SDF_COUNTERS = {
    "grid_fwd": ("grid_encode", "LAUNCHES"), "ffmlp_fwd": ("ffmlp", "LAUNCHES"),
    **K2_COUNTERS, "grid_bwd": ("grid_encode", "BWD_LAUNCHES"),
    "grid_bwd_input": ("grid_encode", "INPUT_LAUNCHES"), "grid_bwdbwd": ("grid_encode", "BWDBWD_LAUNCHES"),
}


def sdf_lr_factor(step, lr=SDF_LR, warmup=SDF_WARMUP, lr_end=SDF_LR_END):
    """The learning rate of ``step`` as a factor of ``lr``."""
    if step < warmup:
        return (step + 1) / warmup
    return (lr_end / lr) ** ((step - warmup) / max(N_SDF_STEPS - 1 - warmup, 1))


def phase_sdf(card, lr=SDF_LR, warmup=SDF_WARMUP, lr_end=SDF_LR_END):
    """The module-API slice: modules.NetworkWithInputEncoding on the 3D model,
    fitted to a sphere SDF with an eikonal term and torch.optim.Adam."""
    import torch

    from tcnn_tpu_torch import modules
    from tcnn_tpu_torch.benchmarks.grid_second_order_times import EIKONAL_WEIGHT, sdf_step, sphere_sdf
    from tcnn_tpu_torch.utils.profiling import profile_steps
    from tcnn_tpu_torch.ops import ffmlp, grid_encode

    mods = {"ffmlp": ffmlp, "grid_encode": grid_encode}
    dev = torch.device("cuda")
    m = modules.NetworkWithInputEncoding(3, 1, ENC3D, NET3D, seed=SEED)
    check(m.params.is_cuda and m.n_params == 13_051_984, f"sdf: module not on the card ({m.n_params} params)")
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)

    def batch():
        x = torch.rand((B_SDF, 3), generator=gen, device=dev)
        return x, sphere_sdf(x)

    def new_opt():
        opt = torch.optim.Adam(m.parameters(), lr=lr, betas=(0.9, 0.99), eps=1e-15)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda i: sdf_lr_factor(i, lr, warmup, lr_end))

    def plain(xx):
        return m.apply_plain(m.params, xx)[:, :1].float()

    # One step from the same state through the kernels and through the
    # plain versions.
    p0 = m.params.detach().clone()
    x, target = batch()
    loss_k = sdf_step(new_opt()[0], m, x.clone(), target)
    p_k = m.params.detach().clone()
    with torch.no_grad():
        m.params.copy_(p0)
    loss_p = sdf_step(new_opt()[0], plain, x.clone(), target)
    p_p = m.params.detach().clone()
    with torch.no_grad():
        m.params.copy_(p0)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(loss_k)) and bool(p_k.isfinite().all()), "sdf: non-finite kernel step")
    rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    d = (p_k - p_p).abs()
    moved = float((d > 1e-6).float().mean())
    check(rel <= 1e-3, f"sdf: one-step loss kernel {float(loss_k)} vs plain {float(loss_p)}")
    lr0 = lr * sdf_lr_factor(0, lr, warmup, lr_end)
    check(float(d.max()) <= 2 * lr0 * 1.0001 and moved <= 1e-2,
          f"sdf: params max|diff| {float(d.max()):.3e}, {moved:.2e} of them differ")
    log(f"sdf: one step from the same state, kernel vs plain path: loss {float(loss_k):.6f} vs {float(loss_p):.6f} "
        f"(rel {rel:.2e}, bound 1e-3: bf16 activations flip in another sum order); params max|diff| "
        f"{float(d.max()):.3e}, {moved:.2e} of them differ (Adam's first step is ~lr x sign(grad): bound 2 lr "
        f"and 1%)")

    opt, schedule = new_opt()
    for mod, attr in SDF_COUNTERS.values():
        setattr(mods[mod], attr, 0)
    losses, step_ms = [], []
    t_start = time.perf_counter()
    for i in range(N_SDF_STEPS):
        x, target = batch()
        if i >= 50:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        losses.append(sdf_step(opt, m, x, target))
        schedule.step()
        if i >= 50:
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = {k: getattr(mods[mod], attr) for k, (mod, attr) in SDF_COUNTERS.items()}
    losses = torch.stack(losses).float().cpu().numpy()
    check(np.isfinite(losses).all() and bool(m.params.isfinite().all()), "sdf: non-finite loss or params")
    first, last = float(losses[0]), float(losses[-10:].mean())
    x, target = batch()
    x.requires_grad_(True)
    f = m(x)
    (g,) = torch.autograd.grad(f, x, torch.ones_like(f))
    mae = float((f.detach() - target).abs().mean())
    eik = float((g.norm(dim=1) - 1).abs().mean())
    med = statistics.median(step_ms)
    log(f"sdf: {N_SDF_STEPS} steps at B=2^18 of L2 + {EIKONAL_WEIGHT} eikonal on a sphere SDF, torch.optim.Adam lr "
        f"{lr} (warm-up {warmup} steps, decay to {lr_end}): loss trace every 25 steps "
        f"{', '.join(f'{v:.4g}' for v in losses[::25])}; loss {first:.4e} (step 0) -> {last:.4e} (mean of the last 10), all finite; on fresh points mean "
        f"|f - sdf| {mae:.4e}, mean ||grad f| - 1| {eik:.4e}; kernel launches {launches}")
    log(f"time [{card}]: SDF step (module forward, create_graph input gradient, backward, torch Adam over 13.0 M "
        f"params) B=2^18: {med:.4f} ms/step, {B_SDF / med * 1e3:.4e} samples/s (host clock + synchronize, median of "
        f"steps 50-{N_SDF_STEPS - 1}); {N_SDF_STEPS} steps with sampling in {wall:.2f} s")
    check(last < 0.1 * first, f"sdf: loss did not fall below a tenth ({first:.4e} -> {last:.4e})")
    for k, v in launches.items():
        check(v > 0, f"sdf: kernel {k} was not launched on the module-API path")
    wall, busy, idle, kernels = profile_steps(lambda: sdf_step(opt, m, *batch()))
    log(f"profile [{card}]: SDF step B=2^18, 10 steps back to back under torch.profiler: {wall:.4f} ms/step, device "
        f"busy {busy:.4f} ms, idle share {idle:.3f}, {len(kernels)} distinct device ops; largest (ms/step): "
        + "; ".join(f"{name[:60]} {ms:.4f}" for name, ms in kernels[:12]))
    return {"launches": launches, "ms": med, "loss": (first, last), "losses": losses, "profile": dict(kernels)}


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


def _k2_bounds(batch, in_w, out_w, n_w, rows_padded, scratch_cols):
    """Bounds of K2 and of its two parts (bf16 bytes; bf16 operations):
    the whole backward (x, g and the weights read, dx and dW written; 6
    flops per weight a row), the walk (x, g, weights read; dx and the
    scratch written; the forward and dh products, 4 flops per weight a row)
    and the weight gradient (x and the scratch read, dW written; 2 flops per
    weight a row)."""
    scratch = rows_padded * scratch_cols * 2
    return {
        "ffmlp_bwd": bound(batch * (2 * in_w + out_w) * 2 + 2 * n_w * 2, 6 * batch * n_w, "bf16"),
        "walk": bound(batch * (2 * in_w + out_w) * 2 + n_w * 2 + scratch, 4 * batch * n_w, "bf16"),
        "dw": bound(batch * in_w * 2 + scratch + n_w * 2, 2 * batch * n_w, "bf16"),
    }


def phase_k2_times(card, kb):
    """K2 (walk + split-K dW + reduce) and the plain version in one call, in
    turns, at the flagship, at 128 x 5 with in 128 and at the K8 view; then
    the walk and the weight gradient on their own at the flagship, the
    latter beside torch.matmul(D_l.T, H_l) over the layers."""
    import torch

    from tcnn_tpu_torch.common import Activation
    from tcnn_tpu_torch.networks.activations import ACTIVATION_CODES
    from tcnn_tpu_torch.ops import ffmlp as F

    relu, none = Activation.ReLU, Activation.NONE
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    ws128 = _mlp_weights(gen, _shapes(128, 128, 5, 16), 1.0, dev)
    x128 = (torch.rand((B_FLAG, 128), generator=gen, device=dev) * 2 - 1).to(torch.bfloat16)
    g128 = (torch.rand((B_FLAG, 16), generator=gen, device=dev) * 2 - 1).to(torch.bfloat16)
    w = PACKED_WIDTHS[-1]
    ws8 = _mlp_weights(gen, _shapes(w, w, 3, w), 1.0, dev)
    xp = torch.randn((B_PACKED * w // 128, 128), generator=gen, device=dev).to(torch.bfloat16)
    gp = (torch.rand(xp.shape, generator=gen, device=dev) * 2 - 1).to(torch.bfloat16)
    x, g, ws = kb["x"], kb["g"], kb["ws"]
    cases = {
        "flagship (B=2^18, 32->64x2->16)": (
            lambda: F.ffmlp_backward(x, g, ws, relu, none),
            lambda: F.ffmlp_backward_plain(x, g, ws, relu, none), (B_FLAG, 32, 16, ws)),
        "128 x 5, in 128 (B=2^18, bench_image's net)": (
            lambda: F.ffmlp_backward(x128, g128, ws128, relu, none),
            lambda: F.ffmlp_backward_plain(x128, g128, ws128, relu, none), (B_FLAG, 128, 16, ws128)),
        "K8 view (w64, 3 hidden, B=2^20; plain: block-diagonal)": (
            lambda: F.ffmlp_backward_packed(xp, gp, ws8, relu, none),
            lambda: F.ffmlp_backward_packed_plain(xp, gp, ws8, relu, none), (B_PACKED, w, w, ws8)),
    }
    out = {}
    with torch.no_grad():
        for name, (new, plain, (batch, in_w, out_w, wl)) in cases.items():
            fns = {"plain": plain, "kernel": new}
            runs = {k: [] for k in fns}
            for kind in ("plain", "kernel", "kernel", "plain"):
                runs[kind].append(_event_ms(fns[kind]))
            r = {k: statistics.median(v) for k, v in runs.items()}
            n_w = sum(int(t.numel()) for t in wl)
            rows_padded = F.dw_split(batch, [tuple(t.shape) for t in wl])[0]
            n_hidden, width = len(wl) - 1, wl[0].shape[0]
            r["bound"] = _k2_bounds(batch, in_w, out_w, n_w, rows_padded, 2 * n_hidden * width + out_w)["ffmlp_bwd"]
            out[name] = r
            log(f"time [{card}]: K2 {name}: kernel (walk + dW + reduce) {r['kernel']:.4f} ms, plain "
                f"{r['plain']:.4f} ms, bound {r['bound'][0]:.4f} ms ({r['bound'][1]}) (CUDA events, median; turns "
                f"plain, kernel, kernel, plain)")

        # The parts at the flagship, from the same operands.
        width, n_hidden, out_w, flat = F._backward_operands("k2 parts", x, g, ws)
        dims = (width, n_hidden, out_w)
        split = F.dw_split(B_FLAG, [tuple(t.shape) for t in ws])
        codes = (ACTIVATION_CODES[relu], ACTIVATION_CODES[none])
        _, d_scr, h_scr = F._walk("k2 parts", x, g, flat, dims, codes, split[0])
        rows = split[0]
        ds, hs, col = [], [x], 0
        for t in ws:
            ds.append(d_scr[rows * col: rows * (col + t.shape[0])].view(rows, t.shape[0])[:B_FLAG])
            col += t.shape[0]
        for l in range(n_hidden):
            hs.append(h_scr[rows * l * width: rows * (l + 1) * width].view(rows, width)[:B_FLAG])
        # The product against the fp64 product of the walk's own scratch:
        # every entry within half a bf16 ulp of the exact sum (its one
        # rounding) plus the fp32 summation bound n 2^-24 (|D|^T |H|).
        dw = F._weight_grad("k2 parts", x, d_scr, h_scr, flat, dims, split)
        worst = 0.0
        for (d, h), got in zip(zip(ds, hs), dw.split([t.numel() for t in ws])):
            exact = d.double().T @ h.double()
            half_ulp = torch.where(exact != 0, 2.0 ** (torch.floor(torch.log2(exact.abs())) - 8), 0.0)
            tol = half_ulp + B_FLAG * 2.0**-24 * (d.double().abs().T @ h.double().abs())
            excess = (got.view(exact.shape).double() - exact).abs() - tol
            worst = max(worst, float(excess.max()))
        check(worst <= 0.0, f"k2 parts: the dW product is off the exact product of its inputs by {worst:.3e}")
        log(f"kernel ffmlp_bwd_dw: at the flagship every dW entry is within half a bf16 ulp of the fp64 product of "
            f"the walk's own D_l and H_l, plus the fp32 summation bound B 2^-24 (|D|^T |H|)")
        fns = {
            ("kernel", "walk"): lambda: F._walk("k2 parts", x, g, flat, dims, codes, split[0]),
            ("plain", "walk"): lambda: F.ffmlp_backward_walk_plain(x, g, ws, relu, none),
            ("kernel", "dw"): lambda: F._weight_grad("k2 parts", x, d_scr, h_scr, flat, dims, split),
            ("plain", "dw"): lambda: F.ffmlp_weight_grad_plain(ds, hs, split[1] * F.DW_TILE_K),
        }
        for which in ("walk", "dw"):
            runs = {"kernel": [], "plain": []}
            for kind in ("plain", "kernel", "kernel", "plain"):
                runs[kind].append(_event_ms(fns[(kind, which)]))
            out[which] = {k: statistics.median(v) for k, v in runs.items()}
        out["dw"]["library"] = _event_ms(lambda: [torch.matmul(d.T, h) for d, h in zip(ds, hs)])
        out["walk"]["library"] = None
    n_w = sum(int(t.numel()) for t in ws)
    bounds = _k2_bounds(B_FLAG, 32, 16, n_w, split[0], 2 * n_hidden * width + out_w)
    for which, what in (("walk", "walk (forward recompute, dx, D_l and H_l to scratch)"),
                        ("dw", f"split-K dW product + reduce ({split[2]} splits of {split[1]} K tiles)")):
        o = out[which]
        o["bound"] = bounds[which]
        log(f"time [{card}]: K2 part at the flagship: {what}: kernel {o['kernel']:.4f} ms, plain {o['plain']:.4f} ms, "
            f"bound {o['bound'][0]:.4f} ms ({o['bound'][1]})"
            + ("" if o["library"] is None else f", torch.matmul(D_l.T, H_l) over the 3 layers {o['library']:.4f} ms")
            + " (CUDA events, median)")
    return out


GRID_BWD_SHAPES = ("flagship stratified B=2^18", "flagship uniform B=2^18", "3D model B=2^18")


def _contribution_pairs(enc, x, dy):
    """Every (flat table row, fp32 contribution row) pair of the table
    gradient, precomputed with the plain version's corner arithmetic: what
    one index_add_ sums (the scatter alone, without the index arithmetic)."""
    import torch

    from tcnn_tpu_torch.ops import grid_encode as ge

    lt = enc.level_table().view(np.uint32).astype(np.int64)
    F, d = enc.n_features_per_level, enc.n_dims_to_encode
    bits = ge._corner_bits(d, ge.INTERP_LINEAR)
    rows, contribs = [], []
    g = dy.float()
    for lvl, row in enumerate(lt):
        idx, w = ge._level_rows(x, row, ge.INTERP_LINEAR, bits)
        rows.append(idx.reshape(-1))
        contribs.append((w[..., None] * g[:, None, lvl * F:(lvl + 1) * F]).reshape(-1, F))
    return torch.cat(rows), torch.cat(contribs)


def phase_grid_bwd_times(card, ks):
    """The table gradient at three shapes, each in its training classes: the
    kernel and the plain version in turns (plain, new, new, plain; CUDA
    events, median of each kind's two runs), beside one index_add_ of the
    precomputed (flat row, contribution) pairs, and the bound from the
    shapes."""
    import torch

    from tcnn_tpu_torch.ops import grid_encode as ge

    enc, enc3 = ks["enc"], ks["enc3"]
    inputs = {
        GRID_BWD_SHAPES[0]: (enc, ks["x_strat"], ks["dy"]),
        GRID_BWD_SHAPES[1]: (enc, ks["x"], ks["dy"]),
        GRID_BWD_SHAPES[2]: (enc3, ks["x3"], ks["dy3"]),
    }
    out = {}
    for shape, (e, x, dy) in inputs.items():
        classes_np = e.gradient_classes(B_FLAG)
        classes = torch.from_numpy(classes_np).to("cuda")
        levels = e._levels_on(x.device)
        plan = ge.backward_plan(e.level_table(), 2, B_FLAG, classes_np)
        fns = {
            "new": lambda: ge.grid_backward(x, dy, levels, 2, ge.INTERP_LINEAR, classes, plan),
            "plain": lambda: ge.grid_backward_plain(x, dy, levels, 2, ge.INTERP_LINEAR, classes),
        }
        runs = {k: [] for k in fns}
        with torch.no_grad():
            for kind in ("plain", "new", "new", "plain"):
                runs[kind].append(_event_ms(fns[kind]))
            rows, contribs = _contribution_pairs(e, x, dy)
            table = torch.zeros((e.n_params // 2, 2), device="cuda")
            library = _event_ms(lambda: table.index_add_(0, rows, contribs))
            del rows, contribs, table
        d, L = e.n_dims_to_encode, e.n_levels
        b = bound(B_FLAG * d * 4 + B_FLAG * 32 * 2 + e.n_params * 4, B_FLAG * L * 2**d * (2 + 2 * 2), "fp32")
        out[shape] = {k: statistics.median(v) for k, v in runs.items()}
        out[shape].update(library=library, bound=b, acc=classes_np[:, 1].tolist(),
                          privatised=[l for l, p in enumerate(plan.privatised) if p])
        r = out[shape]
        log(f"time [{card}]: table gradient, {shape}, accumulation codes {r['acc']}: kernel {r['new']:.4f} ms "
            f"(levels {r['privatised']} privatised), plain {r['plain']:.4f} ms, index_add_ of the {B_FLAG * L * 2**d} "
            f"precomputed fp32 (row, contribution) pairs {library:.4f} ms, bound {b[0]:.4f} ms ({b[1]}) "
            f"(CUDA events, median; in turns)")
    return out


LOOKUP_SHAPES = ("flagship stratified", "flagship uniform", "3D model uniform", "flagship raster 1024^2")


def phase_lookup_scatter_times(card):
    """``benchmarks.lookup_scatter_times``' lookup and scatter measurements:
    the lookup, new kernel and v1 in turns (each twice: in order, then in
    reverse; CUDA events, the mean of the two medians) at LOOKUP_SHAPES,
    with the compiler's report of both kernels; the row scatter beside
    index_add_ at its four shapes (device ms a call behind a spin kernel,
    call ms over back-to-back calls, the host's us a call)."""
    import torch

    from tcnn_tpu_torch.benchmarks import lookup_scatter_times as lst

    dev = torch.device("cuda")
    args = lst.build_parser().parse_args([])
    recs = lst.time_lookups(args, dev, card)
    lookup = {r["shape"]: r["ms"] for r in recs if r["what"] == "lookup"}
    for shape in LOOKUP_SHAPES:
        ms = lookup[shape]
        log(f"time [{card}]: lookup A/B {shape}: new kernel {ms['grid_encode']:.4f} ms, earlier kernel v1 "
            f"{ms['grid_encode_v1']:.4f} ms ({ms['grid_encode_v1'] / ms['grid_encode']:.2f}x) (CUDA events, in turns)")
    report = next(r for r in recs if r["what"] == "lookup compiler report")
    for name, k in report["sass"].items():
        log(f"lookup sass: {name}: {k['instructions']} instructions, calls {k['calls']}")
    scatter = {}
    for r in lst.time_scatters(args, dev, card):
        scatter[r["shape"]] = r
        d, c, h = r["device_ms"], r["call_ms"], r["host_us"]
        log(f"time [{card}]: scatter_rows vs index_add_, {r['shape']}: device ms a call {d['scatter_rows']:.4f} vs "
            f"{d['index_add_']:.4f}; call ms {c['scatter_rows']:.4f} vs {c['index_add_']:.4f}; host us a call "
            f"{h['scatter_rows']:.2f} vs {h['index_add_']:.2f}")
    return lookup, scatter


def phase_second_order_times(card):
    """``benchmarks.grid_second_order_times``' kernel measurements: G1, G2
    (cgx only, the SDF path; and with cgp), the 3D lookup and table gradient
    and their row0 / no-scatter variants, each twice in turns (CUDA events),
    G1's and G2's plain versions, and the compiler's report of both kernels
    (ptxas registers and spills, SASS instructions)."""
    import torch

    from tcnn_tpu_torch.benchmarks import grid_second_order_times as gso
    from tcnn_tpu_torch.encodings import create_encoding
    from tcnn_tpu_torch.ops import _build

    dev = torch.device("cuda")
    args = gso.build_parser().parse_args([])
    (rec,) = gso.time_kernels(args, dev, card, plain=True)
    ms = rec["ms"]
    log(f"time [{card}]: second order, 3D model B=2^18 uniform, bf16 dy, classes of the batch (accumulation codes "
        f"{rec['acc']}): " + "; ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
        + " (CUDA events, kernels in turns; row0: every level one row long; no scatter: no class table)")
    for name, k in gso.compiler_report(_build.build_library("grid_input_grad")).items():
        log(f"second order kernel: {name[:90]}: {k.get('registers')} registers, spill stores "
            f"{k.get('spill_stores')} / loads {k.get('spill_loads')} bytes, {k.get('instructions')} SASS instructions")
    enc = create_encoding(3, ENC3D, alignment=16)
    return {"ms": ms, "n_params": enc.n_params, "n_levels": enc.n_levels}


def phase_times(card, k1, k2, m, x_np, kb, ks):
    import torch

    from tcnn_tpu_torch.common import Activation
    from tcnn_tpu_torch.ops import scatter_rows as sr
    from tcnn_tpu_torch.ops.ffmlp import ffmlp_forward, ffmlp_forward_plain
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
    fns = {
        ("kernel", "k1"): lambda: ffmlp_forward(x, ws, relu, none),
        ("plain", "k1"): lambda: ffmlp_forward_plain(x, ws, relu, none),
        ("kernel", "k2"): lambda: enc.apply(params, xg),
        ("plain", "k2"): lambda: enc.apply_plain(params, xg),
        ("kernel", "adam_step"): lambda: opt.step(a_state, a_params, a_grads, 128.0),
        ("plain", "adam_step"): lambda: opt.step(a_state, a_params, a_grads, 128.0, plain=True),
        ("kernel", "scatter_rows"): lambda: sr.scatter_rows(ks["idx"], ks["rows"], 64),
        ("plain", "scatter_rows"): lambda: sr.scatter_rows_plain(ks["idx"], ks["rows"], 64),
    }
    # One PyTorch call that computes the same function, where there is one:
    # the fp32 row scatter is index_add_.
    s_out = torch.zeros((64, 4), device="cuda")
    s_idx = ks["idx"].long()
    library = {"scatter_rows": lambda: s_out.index_add_(0, s_idx, ks["rows"])}
    timed = ("k1", "k2", "adam_step", "scatter_rows")
    runs = {which: {"kernel": [], "plain": []} for which in timed}
    with torch.no_grad():
        for which in timed:
            for kind in order:
                runs[which][kind].append(_event_ms(fns[(kind, which)]))
        for which, fn in library.items():
            t[f"{which}_library_ms"] = _event_ms(fn)
        xd = torch.from_numpy(x_np).cuda()
        t["inference_ms"] = _host_ms(lambda: m.inference(xd))
        server = m.trainer.freeze_serving()
        t["raster_ms"] = _host_ms(lambda: server.raster(1024))
    for which in timed:
        for kind in ("kernel", "plain"):
            t[f"{which}_{kind}_ms"] = statistics.median(runs[which][kind])
    # Device time of one call, apart from the host's time to issue it (the
    # call times above are events over back-to-back calls): K1, and K3
    # through AdamOptimizer.step (the step count's increment and the
    # kernel) and alone.
    from tcnn_tpu_torch.benchmarks.probe_rows import device_ms
    from tcnn_tpu_torch.ops import fused_adam

    a_hp = fused_adam.hyperparams_of(opt, 715760, opt.n_matrix_weights, 128.0)
    with torch.no_grad():
        t["k1_device_ms"] = device_ms(fns[("kernel", "k1")], torch.device("cuda"), 21)
    t["adam_step_device_ms"] = device_ms(fns[("kernel", "adam_step")], torch.device("cuda"), 21)
    t["adam_step_kernel_device_ms"] = device_ms(lambda: fused_adam.adam_step(
        a_params, a_grads, a_state["first_moments"], a_state["second_moments"], a_state["param_steps"],
        a_state["step"], a_hp), torch.device("cuda"), 21)
    # G1 and G2 at the SDF path's shapes, beside the 3D lookup and table
    # gradient, by the benchmark entry point that records them.
    t["second_order"] = phase_second_order_times(card)
    so = t["second_order"]["ms"]
    t["grid_bwd_input_kernel_ms"], t["grid_bwd_input_plain_ms"] = so["G1"], so["G1 plain"]
    t["grid_bwdbwd_kernel_ms"], t["grid_bwdbwd_plain_ms"] = so["G2 cgx"], so["G2 cgx plain"]
    # The table gradient at three shapes; the JSON line takes the stratified
    # flagship batch, the training path's.
    t["grid_bwd_ab"] = phase_grid_bwd_times(card, ks)
    strat = t["grid_bwd_ab"][GRID_BWD_SHAPES[0]]
    t["grid_bwd_kernel_ms"], t["grid_bwd_plain_ms"] = strat["new"], strat["plain"]
    t["grid_bwd_library_ms"] = strat["library"]
    # The lookup against the earlier kernel (v1) at four shapes and the row
    # scatter against index_add_ (device and call time), by the benchmark
    # entry point that records them.
    t["lookup_ab"], t["scatter_ab"] = phase_lookup_scatter_times(card)
    # K2 and its parts.
    t["k2"] = phase_k2_times(card, kb)
    flag = t["k2"]["flagship (B=2^18, 32->64x2->16)"]
    t["ffmlp_bwd_kernel_ms"], t["ffmlp_bwd_plain_ms"] = flag["kernel"], flag["plain"]
    for part in ("walk", "dw"):
        p = t["k2"][part]
        t[f"ffmlp_bwd_{part}_kernel_ms"], t[f"ffmlp_bwd_{part}_plain_ms"] = p["kernel"], p["plain"]
        t[f"ffmlp_bwd_{part}_library_ms"] = p["library"]
    log(f"time [{card}]: kernel1 ffmlp_fwd B=2^18 32->64x2->16: kernel {t['k1_kernel_ms']:.4f} ms (device "
        f"{t['k1_device_ms']:.4f}), plain chain {t['k1_plain_ms']:.4f} ms (CUDA events, median)")
    log(f"time [{card}]: kernel adam_step device time a call (715,760 params): AdamOptimizer.step "
        f"{t['adam_step_device_ms']:.4f} ms (the step count's increment and the kernel), the kernel alone "
        f"{t['adam_step_kernel_device_ms']:.4f} ms, beside the call time {t['adam_step_kernel_ms']:.4f} ms of "
        f"back-to-back AdamOptimizer.step calls")
    log(f"time [{card}]: kernel2 grid_fwd flagship B=2^18: kernel {t['k2_kernel_ms']:.4f} ms, "
        f"plain lookup {t['k2_plain_ms']:.4f} ms (CUDA events, median)")
    log(f"time [{card}]: Trainer.inference B=2^18 (device input): {t['inference_ms']:.4f} ms "
        f"(host clock + synchronize, median of 11)")
    log(f"time [{card}]: FrozenServer.raster 1024x1024: {t['raster_ms']:.4f} ms "
        f"(host clock + synchronize, median of 11)")
    # Bounds from this run's shapes: each input read once, each output
    # written once; operations at their type's peak.
    n_w = sum(int(w.numel()) for w in ws)
    enc2, L2, F = enc, enc.n_levels, 2
    n_enc = enc2.n_params
    d3, n3, L3 = 3, t["second_order"]["n_params"], t["second_order"]["n_levels"]
    t["bounds"] = {
        "k1": bound(B_FLAG * (32 + 16) * 2 + n_w * 2, 2 * B_FLAG * n_w, "bf16"),
        "k2": bound(B_FLAG * 2 * 4 + n_enc * 4 + B_FLAG * 32 * 2, B_FLAG * L2 * 4 * (2 + 2 * F), "fp32"),
        "ffmlp_bwd": bound(B_FLAG * (2 * 32 + 16) * 2 + 2 * n_w * 2, 6 * B_FLAG * n_w, "bf16"),
        "ffmlp_bwd_walk": t["k2"]["walk"]["bound"],
        "ffmlp_bwd_dw": t["k2"]["dw"]["bound"],
        "adam_step": bound(715760 * 36, 715760 * 20, "fp32"),
        "grid_bwd": strat["bound"],
        "scatter_rows": bound(B_FLAG * 4 + B_FLAG * 4 * 4 + 64 * 4 * 4, B_FLAG * 4, "fp32"),
        "grid_bwd_input": bound(B_SDF * d3 * 4 * 2 + B_SDF * 32 * 2 + n3 * 4,
                                B_SDF * L3 * 8 * (2 * F + d3 * d3 + 2 * d3), "fp32"),
        "grid_bwdbwd": bound(B_SDF * d3 * 4 * 3 + B_SDF * 32 * 2 + B_SDF * 32 * 4 + 2 * n3 * 4,
                             B_SDF * L3 * 8 * (d3 ** 3 + 3 * d3 * d3 + 4 * d3 + 6 * F), "fp32"),
    }
    shapes = {
        "ffmlp_bwd": "B=2^18 32->64x2->16 ReLU (dx and dW)",
        "adam_step": "715,760 params, flagship hyperparameters",
        "scatter_rows": "2^18 rows x 4 into 64 slots, fp32",
        "grid_bwd_input": "3D model B=2^18, bf16 dy",
        "grid_bwdbwd": "3D model B=2^18, bf16 dy, input-gradient cotangent, table gradient in the 2^18 classes",
    }
    for which, shape in shapes.items():
        b = t["bounds"][which]
        lib = t.get(f"{which}_library_ms")
        log(f"time [{card}]: kernel {which} {shape}: kernel {t[which + '_kernel_ms']:.4f} ms, plain "
            f"{t[which + '_plain_ms']:.4f} ms, bound {b[0]:.4f} ms ({b[1]})"
            + (f", library call {lib:.4f} ms" if lib is not None else "") + " (CUDA events, median)")
    return t


PROBE_COUNTERS = {
    "probe_gather": ("probe_rows", "GATHER_LAUNCHES"), "probe_scatter": ("probe_rows", "SCATTER_LAUNCHES"),
    "probe_gather_dot": ("probe_rows", "DOT_LAUNCHES"), "scatter_rows": ("scatter_rows", "LAUNCHES"),
}
# Where each probe kernel's JSON times are taken: the gather and the
# scatter-add at the sweep's 3D grid level (2^24 rows of F = 2 into 2^19
# slots: at 2^18 rows a call lasts about as long as its launch); the
# gather-dot at P11's defaults (2^17 rows, S = 2^15, F = 8).
JSON_SHAPE = "S=2^19 F=2 B=2^24"


def _record(result, op, shape, source):
    """The probe run's record of ``op`` at ``shape`` from ``source``."""
    return next(r for r in result["probes"] if r["label"] == f"{op} {shape}" and r["source"] == source)


def _counters(table):
    """A table of counts, name -> (module, attribute) or (module, attribute,
    key) for a count kept in a dict (the table gradient's by route), as
    (module object, attribute, key or None)."""
    from tcnn_tpu_torch.ops import ffmlp, fused_adam, grid_encode, probe_rows, scatter_rows, sh_encode

    mods = {"ffmlp": ffmlp, "fused_adam": fused_adam, "grid_encode": grid_encode, "probe_rows": probe_rows,
            "scatter_rows": scatter_rows, "sh_encode": sh_encode}
    return {name: (mods[spec[0]], spec[1], spec[2] if len(spec) > 2 else None) for name, spec in table.items()}


def _zero_counts(table):
    for mod, attr, key in _counters(table).values():
        if key is None:
            setattr(mod, attr, 0)
        else:
            getattr(mod, attr)[key] = 0


def _read_counts(table):
    return {name: getattr(mod, attr) if key is None else getattr(mod, attr).get(key, 0)
            for name, (mod, attr, key) in _counters(table).items()}


def phase_probes(card):
    """The row gather and scatter probes: kernel against plain at the
    probes' default shapes, then the path (benchmarks.probe_rows with --sweep)
    with every count at 0, then the three probe kernels' JSON times, and
    the redesigned probe kernels' (P2, P8-P15, P17, P18) and P16's device
    times under the profiler beside their bounds."""
    import torch

    from tcnn_tpu_torch.benchmarks import probe_rows as drv
    from tcnn_tpu_torch.ops import probe_rows as pr

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    cases = drv.build_cases(drv.build_parser().parse_args([]), dev)
    errs = {"probe_gather": 0.0, "probe_scatter": 0.0, "probe_gather_dot": 0.0, "scatter_rows": 0.0}
    n = 0
    for case in cases:
        if case.plain is not None:
            errs[case.kernel] = max(errs[case.kernel], drv.check_case(case))
            n += 1
    # Rows outside the table read zeros (P1's fill_value) from every source;
    # the scatters skip them.
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    table = torch.randn((4096, 8), generator=gen, device=dev)
    idx = torch.randint(-100, 4096 + 100, (2**18,), generator=gen, device=dev, dtype=torch.int32)
    rows = torch.randn((2**18, 8), generator=gen, device=dev)
    want = pr.probe_gather_plain(table, idx)
    # SHARED also from a table 4 bytes off alignment (scalar copies); ASYNC
    # also in groups of 16 rows.
    odd = torch.empty(table.numel() + 1, device=dev)[1:].view(table.shape)
    odd.copy_(table)
    for t, source, kw in ((table, pr.SOURCE_L2, {}), (table, pr.SOURCE_L2, {"unroll": 8}),
                          (table, pr.SOURCE_SHARED, {}), (odd, pr.SOURCE_SHARED, {}),
                          (table, pr.SOURCE_ASYNC, {"in_flight": 64}), (table, pr.SOURCE_ASYNC, {"in_flight": 16})):
        check(torch.equal(pr.probe_gather(t, idx, source=source, **kw), want),
              f"probe_gather {pr.SOURCE_NAMES[source]} {kw} (alignment {pr.alignment(t)}): rows outside the table "
              f"do not read zeros")
    w = torch.randn((8, pr.DOT_COLS), generator=gen, device=dev)
    got, ref = pr.probe_gather_dot(table, idx, w), pr.probe_gather_dot_plain(table, idx, w)
    check(float((got - ref).abs().max()) <= drv.DOT_TOL * float(ref.abs().max()), "probe_gather_dot: outside rows")
    for t, flags in ((table, 0), (table.t().contiguous(), pr.FLAG_TRANSPOSED)):
        check(torch.equal(pr.probe_gather(t, idx, mode=pr.MODE_TILE_SUM, flags=flags),
                          pr.probe_gather_plain(t, idx, pr.MODE_TILE_SUM, flags=flags)),
              f"TILE_SUM flags {flags}: outside rows")
    # P17's route (planes staged in shared memory), rounded to bf16 too.
    for flags in (pr.FLAG_TRANSPOSED | pr.FLAG_FEATURE_MAJOR, pr.FLAG_TRANSPOSED | pr.FLAG_FEATURE_MAJOR | pr.FLAG_ROUND_BF16):
        check(torch.equal(pr.probe_gather(table.t().contiguous(), idx, flags=flags),
                          pr.probe_gather_plain(table.t().contiguous(), idx, flags=flags)),
              f"transposed feature-major flags {flags}: outside rows")
    for acc in (pr.ACC_GLOBAL, pr.ACC_SHARED):
        got, ref = pr.probe_scatter(idx, rows, 4096, pr.OP_ADD, acc), pr.probe_scatter_plain(idx, rows, 4096)
        S_abs = pr.probe_scatter_plain(idx, rows.abs(), 4096)
        check(bool(((got - ref).abs() <= drv.ADD_TOL * S_abs).all()), f"probe_scatter acc {acc}: outside rows")
    check(torch.equal(pr.probe_scatter(idx, rows, 4096, pr.OP_STORE_LAST),
                      pr.probe_scatter_plain(idx, rows, 4096, pr.OP_STORE_LAST)), "STORE_LAST: outside rows")
    torch.cuda.synchronize()
    log(f"probes: {n} cases at the probes' default shapes (P1-P19) match their plain versions (gathers, tile "
        f"sums, copies and STORE_LAST bit-exact; ADD within {drv.ADD_TOL} of the sum of |contributions| per entry; "
        f"the gather-dot within {drv.DOT_TOL} of max |plain|); rows outside the table read zeros from every "
        f"source and the scatters skip them; max|diff| {errs}")

    _zero_counts(PROBE_COUNTERS)
    pr.GATHER_ROUTE_LAUNCHES.clear()
    result = drv.main(["--sweep"])
    torch.cuda.synchronize()
    launches = _read_counts(PROBE_COUNTERS)
    routes = dict(sorted(pr.GATHER_ROUTE_LAUNCHES.items()))
    for k, v in launches.items():
        check(v > 0, f"probes: kernel {k} was not launched on the probe run's path")
    for route in ("shared", "async", "window", "copy"):
        check(routes.get(route, 0) > 0, f"probes: the gather's {route} route was not launched on the probe run's path")
    log(f"probes: kernel launches of the probe run (every count at 0 before it): {launches}; the gather's by route: "
        f"{routes}")

    # The sweep, by (operation, S, F, B): each source's ns/row beside the
    # library call's and the bytes bound (idx, the distinct rows touched and
    # the output once for the gather; idx, rows and the whole table once for
    # the scatter-add), all from the probe run.
    groups = {}
    for rec in result["probes"]:
        if rec["p"] == "sweep":
            op = "gather" if rec["label"].startswith("gather") else "scatter-add"
            groups.setdefault((op, rec["S"], rec["F"], rec["B"]), []).append(rec)
    for (op, S, F, B), recs in groups.items():
        lib = next(r for r in recs if r["library_ms"] is not None)
        parts = [f"{r['source']} {r['ns_per_row']:.4f}" for r in recs]
        log(f"probe sweep [{card}]: {op} S=2^{int(np.log2(S))} F={F} B=2^{int(np.log2(B))} ({recs[0]['touched']} rows "
            f"touched), ns/row by source: {'; '.join(parts)}; {lib['library']} {lib['library_ms'] * 1e6 / B:.4f}; "
            f"bound {recs[0]['bound_ms'] * 1e6 / B:.4f} ({recs[0]['bound_by']})")

    # Device time (CUDA events around one call queued behind a spin kernel:
    # the call's kernels and memsets) and call time (CUDA events over
    # back-to-back calls: the host's time or the device's, the larger) of
    # each probe case and of the JSON shape, kernel beside library call;
    # then the host's cost of a whole call, the wrapper beside torch.gather.
    for rec in result["probes"]:
        if rec["device_ms"] is None or (rec["p"] == "sweep" and not rec["label"].endswith(JSON_SHAPE)):
            continue
        lib = rec["library"] if rec["library_device_ms"] is not None else None
        log(f"probe times [{card}]: {rec['label']} [{rec['kernel']} {rec['source']}]: device ms a call: kernel "
            f"{rec['device_ms']:.4f}" + ("" if lib is None else f", {lib} {rec['library_device_ms']:.4f}")
            + f"; call ms: kernel {rec['ms']:.4f}" + ("" if lib is None else f", {lib} {rec['library_ms']:.4f}"))
    log(f"probe host [{card}]: us a call (host clock, no sync): "
        + "; ".join(f"{k} {v:.2f}" for k, v in result["host_us"].items()))

    # The JSON's times: the probe run's records of each probe kernel at its
    # JSON shape (kernel, plain and library call timed one after another).
    times = {}
    for name, rec in (("probe_gather", _record(result, "gather", JSON_SHAPE, "l2")),
                      ("probe_scatter", _record(result, "scatter-add", JSON_SHAPE, "global")),
                      ("probe_gather_dot", next(r for r in result["probes"] if r["p"] == "P11"))):
        times[name] = {"kernel": rec["ms"], "plain": rec["plain_ms"], "bound": (rec["bound_ms"], rec["bound_by"]),
                       "library": rec["library_ms"]}
        log(f"time [{card}]: kernel {name} ({rec['label']}): kernel {rec['ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})"
            + ("" if rec["library_ms"] is None else f", {rec['library']} {rec['library_ms']:.4f} ms")
            + " (CUDA events, median)")
    # The redesigned probe kernels and P16 at the probe run's shapes: each
    # kernel's own device time under torch.profiler beside its bounds (P13:
    # also the order bound of its in-order add chains at the SM clock
    # nvidia-smi reads while it runs; P17: also the random-sector floor of
    # reading it from L2 row by row; P10, P15, P12: their PyTorch
    # yardstick's device time and the write floor of their output), and
    # the redesigned kernels' registers and spills.
    from tcnn_tpu_torch.benchmarks import probe_times

    pt = probe_times.times(calls=100, reps=20)
    pt.pop("outputs")
    for p in probe_times.PROBES:
        rec = pt[p]
        extra = ""
        if p == "P13":
            extra = (f"; order bound {rec['order_bound_ms']:.4f} ms ({pr.TILE} dependent fp32 adds x "
                     f"{probe_times.FADD_CYCLES} cycles at {rec['sm_clock_mhz']:.0f} MHz, clocks.sm while it ran), "
                     f"{rec['order_bound_ms'] / rec['kernel_ms']:.3f} of it")
        elif p == "P11":
            extra = f"; index_select + matmul {rec['library_device_ms']:.4f} ms of device time (two calls)"
        elif p.startswith("P17"):
            extra = (f"; random-sector floor of the L2 route {rec['sector_floor_ms']:.4f} ms ({pt['sector_ns']:.5f} "
                     f"ns a sector x B F)")
        elif "l2_kernel_ms" in rec:
            extra = f"; the L2 route on the same inputs {rec['l2_kernel_ms']:.4f} ms under torch.profiler"
        elif p in probe_times.WINDOW_PROBES:
            extra = (f"; {rec['library']} {rec['library_device_ms']:.4f} ms of device time ({rec['library_calls']} "
                     f"call(s)); write floor (out.zero_() of the same output) {pt['write_floor_ms']:.4f} ms")
        log(f"probe device [{card}]: {p} {rec['label']} [{rec['source']}]: kernel {rec['kernel_ms']:.4f} ms under "
            f"torch.profiler (mean of the {rec['profiled_calls']} of 100 launches it recorded; the call's device "
            f"activities {rec['call_device_ms']:.4f}; events behind a spin {rec['event_ms']:.4f}, their floor "
            f"{pt['event_floor_ms']:.4f}); call {rec['call_ms']:.4f} ms; bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}), {rec['bound_share']:.3f} of it" + extra)
    regs = probe_times.ptxas()
    for name, (n_regs, spill_st, spill_ld) in regs.items():
        if any(k in name for k in ("gather_dot", "gather_tile_sum", "gather_planes", "store_last", "gather_rows_shared",
                                   "gather_rows_async", "gather_windows", "copy_tiles")):
            log(f"probe kernel: {name}: {n_regs} registers, spill stores {spill_st} B, spill loads {spill_ld} B")
            check(spill_st == 0 and spill_ld == 0, f"probes: {name} spills")
    keep = ("kernel_ms", "call_device_ms", "call_ms", "bound_ms", "bound_by", "max_abs_err")
    times["probe_gather_dot"]["device_ms"] = pt["P11"]["kernel_ms"]
    times["probe_gather"]["tile_sum"] = {k: pt["P13"][k] for k in keep + ("order_bound_ms", "sm_clock_mhz")}
    times["probe_gather"]["planes"] = {p: {k: pt[p][k] for k in keep + ("sector_floor_ms",)}
                                       for p in ("P17 S2=2^10", "P17 S2=2^15")}
    times["probe_scatter"]["store_last"] = {k: pt["P14"][k] for k in keep}
    times["probe_gather"]["shared_async"] = {p: {k: pt[p][k] for k in keep + ("l2_kernel_ms",)}
                                             for p in probe_times.ROW_PROBES}
    times["probe_gather"]["window_copy"] = {p: {k: pt[p][k] for k in keep + ("library", "library_device_ms")}
                                            for p in probe_times.WINDOW_PROBES}
    times["probe_gather"]["window_copy"]["write_floor_ms"] = pt["write_floor_ms"]
    times["probe_gather"]["routes"] = routes
    log(f"probes: phase {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "errs": errs, "times": times, "records": result["probes"]}


def _profile_ms(profile, kernel):
    """Device ms a step of the profiled kernels whose name holds ``kernel``."""
    return sum(ms for name, ms in profile.items() if kernel + "<" in name or kernel + "(" in name)


def fastest_rates(records):
    """{(operation, S): (ns/row, what)}: the fastest random-row rate of the
    probe sweep's 2^24 uniform rows of F = 2 into 2^S-row tables, over
    every source of the kernel and the library call (call times, CUDA
    events)."""
    best = {}
    for r in records:
        if r["p"] != "sweep" or r["B"] != 2**24 or r["F"] != 2:
            continue
        key = (r["label"].split()[0], r["S"])
        cands = [(r["ns_per_row"], f"{r['kernel']} {r['source']}")]
        if r["library_ms"] is not None:
            cands.append((r["library_ms"] * 1e6 / r["B"], r["library"]))
        for ns, what in cands:
            if key not in best or ns < best[key][0]:
                best[key] = (ns, what)
    return best


def phase_floors(card, records, t, train_profile, sdf_profile):
    """The grid kernels' random rows against the card's fastest measured
    rates from the probe sweep (2^24 uniform rows of F = 2; for each
    operation and table size the fastest source or library call of this
    run, named): the flagship's tables (levels of at most 2^15 rows, 2.8
    MB) at the 2^15 rates; the 3D model's at the rates of its own table
    (probe_rows.MODEL_3D_ROWS rows, 52 MB, more than the L2). Measured
    times: CUDA events (phase 13) or the profiles' device ms per step
    (launches per step named)."""
    from tcnn_tpu_torch.benchmarks.probe_rows import MODEL_3D_ROWS

    best = fastest_rates(records)
    for (op, S), (ns, what) in sorted(best.items()):
        log(f"floor rate [{card}]: {op} S={S}: {ns:.4f} ns/row, fastest of this run: {what}")
    rate = {key: ns for key, (ns, _) in best.items()}
    flag_rows, rows3d = B_FLAG * 16 * 4, B_SDF * 16 * 8
    ab = t["grid_bwd_ab"]
    S3 = MODEL_3D_ROWS
    cases = (
        ("lookup, flagship uniform (events)", flag_rows, ["gather"], (2**15, 2**15), t["k2_kernel_ms"]),
        ("lookup, flagship stratified (events)", flag_rows, ["gather"], (2**15, 2**15),
         t["lookup_ab"][LOOKUP_SHAPES[0]]["grid_encode"]),
        ("lookup, flagship stratified, earlier kernel v1 (events)", flag_rows, ["gather"], (2**15, 2**15),
         t["lookup_ab"][LOOKUP_SHAPES[0]]["grid_encode_v1"]),
        ("lookup, 3D (events)", rows3d, ["gather"], (S3, S3), t["lookup_ab"][LOOKUP_SHAPES[2]]["grid_encode"]),
        ("table gradient, flagship, stratified batch (events)", flag_rows, ["scatter-add"], (2**15, 2**15),
         ab[GRID_BWD_SHAPES[0]]["new"]),
        ("table gradient, flagship, uniform points (events)", flag_rows, ["scatter-add"], (2**15, 2**15),
         ab[GRID_BWD_SHAPES[1]]["new"]),
        ("table gradient in the training step, stratified batch (profile)", flag_rows, ["scatter-add"],
         (2**15, 2**15), _profile_ms(train_profile, "grid_backward_kernel")),
        ("lookup, 3D (profile)", rows3d, ["gather"], (S3, S3), _profile_ms(sdf_profile, "grid_forward_kernel")),
        ("G1, 3D (events)", rows3d, ["gather"], (S3, S3), t["grid_bwd_input_kernel_ms"]),
        ("table gradient, 3D, one of two launches (profile)", rows3d, ["scatter-add"], (S3, S3),
         _profile_ms(sdf_profile, "grid_backward_kernel") / 2),
        ("table gradient, 3D, training classes (events)", rows3d, ["scatter-add"], (S3, S3),
         ab[GRID_BWD_SHAPES[2]]["new"]),
        ("G2, 3D (events)", rows3d, ["gather", "scatter-add"], (S3, S3), t["grid_bwdbwd_kernel_ms"]),
    )
    for name, rows, ops, (s_lo, s_hi), ms in cases:
        lo = sum(rows * rate[(op, s_lo)] for op in ops) * 1e-6
        hi = sum(rows * rate[(op, s_hi)] for op in ops) * 1e-6
        lo, hi = min(lo, hi), max(lo, hi)
        whats = sorted({best[(op, s)][1] for op in ops for s in (s_lo, s_hi)})
        sizes = f"S = {s_lo}" if s_lo == s_hi else f"S = {s_lo}..{s_hi}"
        log(f"floor [{card}]: {name}: {rows} rows x {'+'.join(ops)} at the fastest random-row rates of {sizes} "
            f"({', '.join(whats)}): {lo:.4f}-{hi:.4f} ms; measured {ms:.4f} ms ({ms / hi:.2f}-{ms / lo:.2f}x)")


BENCH_COUNTERS = {
    "ffmlp_fwd": ("ffmlp", "LAUNCHES"), "grid_fwd": ("grid_encode", "LAUNCHES"),
    **K2_COUNTERS, "adam_step": ("fused_adam", "LAUNCHES"),
    "grid_bwd": ("grid_encode", "BWD_LAUNCHES"), "ffmlp_fwd_packed": ("ffmlp", "PACKED_LAUNCHES"),
    "ffmlp_bwd_packed": ("ffmlp", "PACKED_BWD_LAUNCHES"),
}
SAMPLE_PSNR_FLOOR = 30.0
# The JAX package's TPU v5e reading of the same config, stratified, no EMA
# (DOCUMENTATION.md:275).
SAMPLE_JAX_TPU_PSNR = 47.3


def _all_finite(tree) -> bool:
    if isinstance(tree, dict):
        return all(_all_finite(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return all(_all_finite(v) for v in tree)
    if isinstance(tree, float):
        return bool(np.isfinite(tree))
    return True


def phase_benches(card):
    """The port's benchmark entry points and the image-fit sample, with
    every count at 0 before them and read after."""
    from tcnn_tpu_torch.benchmarks import bench, bench_image, bench_mlp
    from tcnn_tpu_torch.samples import mlp_learning_an_image as sample

    _zero_counts(BENCH_COUNTERS)
    out = {}
    for name, argv in (("2d default", []), ("3d", ["--protocol", "3d"]),
                       ("reference-verbatim", ["--reference-verbatim"]), ("serving", ["--serving"])):
        t0 = time.perf_counter()
        result, runs = bench.main(argv)
        check(_all_finite(result) and result["value"] > 0, f"bench {name}: a value is not finite")
        losses = []
        for which, run in runs.items():
            if run is None:
                continue
            check(np.isfinite(run["final_loss"]) and run["final_loss"] < run["first_loss"],
                  f"bench {name} {which}: loss {run['first_loss']} -> {run['final_loss']}")
            losses.append(f"{which} loss {run['first_loss']:.4e} -> {run['final_loss']:.4e}")
        out[name] = result
        log(f"bench [{card}]: {name} ({' '.join(argv) or 'no flags'}): {result['metric']} {result['value']:.1f} "
            f"{result['unit']}" + (f", {'; '.join(losses)}" if losses else "") + f"; {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mlp = bench_mlp.main([])
    check(_all_finite(mlp) and all(e["elements_per_second"] > 0 for e in mlp), "bench_mlp: bad value")
    log(f"bench_mlp [{card}]: {len(mlp)} measurements, all finite; {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    img = bench_image.main([])
    for e in img:
        check(_all_finite(e) and e["final_loss"] < e["first_loss"],
              f"bench_image batch {e['batch']}: loss {e['first_loss']} -> {e['final_loss']}")
    log(f"bench_image [{card}]: {len(img)} batch sizes, all finite, every final loss below its first; "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fit = sample.main(["-", "-", str(N_TRAIN_STEPS)])
    curve = fit["loss_curve"]
    check(_all_finite(fit) and curve[-1][1] < curve[0][1], f"sample: loss {curve[0][1]} -> {curve[-1][1]}")
    log(f"sample [{card}]: mlp_learning_an_image, {N_TRAIN_STEPS} steps on the synthetic image: PSNR "
        f"{fit['psnr_db']:.3f} dB (floor {SAMPLE_PSNR_FLOOR} dB: single fits without EMA spread widely; the JAX "
        f"package read {SAMPLE_JAX_TPU_PSNR} dB on a TPU v5e), {fit['ms_per_step']:.3f} ms/step; "
        f"{time.perf_counter() - t0:.1f} s")
    check(fit["psnr_db"] >= SAMPLE_PSNR_FLOOR, f"sample: PSNR {fit['psnr_db']} dB below {SAMPLE_PSNR_FLOOR}")
    launches = _read_counts(BENCH_COUNTERS)
    for k, v in launches.items():
        check(v > 0, f"benches: kernel {k} was not launched on the benchmarks' path")
    log(f"benches: kernel launches of the benchmarks and the sample (every count at 0 before them): {launches}")
    return {"bench": out, "mlp": mlp, "image": img, "sample": fit, "launches": launches}


# The spherical-harmonics kernels (csrc/sh_encode.cu) against their plain
# versions: every degree, both output types, ragged batches, a strided
# input as a Composite hands it over.
SH_BATCHES = (1, 31, 1000, 2**18 + 7)
SH_TOL_NOTE = ("forward fp32 max|kernel - plain| <= 1e-5 max|plain| (the same fp32 operations in the same "
               "order, but torch divides by a scalar on the card as a multiply by its reciprocal); bf16 within one "
               "bf16 ulp of the plain fp32 value plus that 1e-5 max|plain|; dL/dx fp32 max|diff| <= 1e-5 max|plain| "
               "(forward-mode derivatives against autograd: the same terms summed in another order)")
# The NeRF path: the sample's own CONFIG (tcnn_tpu_torch/samples/
# nerf_synthetic.py) at 600 steps of 8192 rays x 32 samples (2^18 field
# evaluations a step).
NERF_STEPS, NERF_RAYS = 600, 8192
NERF_COUNTERS = {**TRAIN_COUNTERS, "sh_encode": ("sh_encode", "LAUNCHES"),
                 "sh_encode vector": ("sh_encode", "ROUTE_LAUNCHES", ("forward", "vector"))}
# The validation PSNR floors of the 600-step runs (dB), from 25 runs on an
# H100 (seeds 0-7; seed 0 seven times): 43.940-58.889 dB, median 54.557. The
# last step's weights dither without EMA (a late loss spike took one seed-0
# run to 43.940) and the table gradient's atomics make two runs of one
# seed differ (seed 0: 43.940-58.633), so one run is a poor gauge: the
# phase runs seeds 0-4 and holds their median to 45 dB (one run in 25 read
# below) and each run to 35 dB (a path that does not train stays near 10
# dB). The JAX package read 50.7 dB on a TPU v5e
# (samples/nerf_synthetic.py:19-20).
NERF_SEEDS = (0, 1, 2, 3, 4)
NERF_PSNR_FLOOR = 45.0
NERF_RUN_PSNR_FLOOR = 35.0
NERF_JAX_TPU_PSNR = 50.7
# tests/test_nerf_config.py's NERF_CONFIG (a copy: that file imports jax).
NERF_TEST_CONFIG = {
    "loss": {"otype": "L2"},
    "optimizer": {"otype": "Adam", "learning_rate": 1e-2},
    "encoding": {"otype": "Composite", "nested": [
        {"n_dims_to_encode": 3, "otype": "HashGrid", "n_levels": 8, "n_features_per_level": 2,
         "log2_hashmap_size": 13, "base_resolution": 4, "per_level_scale": 1.5, "hash": "CoherentAdditive",
         "gather_strategy": "quad"},
        {"n_dims_to_encode": 3, "otype": "SphericalHarmonics", "degree": 4}]},
    "network": {"otype": "FullyFusedMLP", "n_neurons": 64, "n_hidden_layers": 2},
}


# The double backward (tcnn_sh_backward_backward) against its plain
# version, and the direction-gradient penalty through the module API.
SH_BWDBWD_TOL_NOTE = ("d/dx and fp32 d/d(dL/dy): max|kernel - plain| <= 1e-5 max|plain| (closed-form second partials "
                      "against autograd of the plain vjp: the same terms summed in another order); bf16 d/d(dL/dy) "
                      "within one bf16 ulp of the plain fp32 value plus that 1e-5 max|plain|")
SH_PENALTY_STEPS = 6
SH_PENALTY_WEIGHT = 1e-3
SH_PENALTY_COUNTERS = {
    "sh_encode": ("sh_encode", "LAUNCHES"), "sh_encode_backward_input": ("sh_encode", "BWD_LAUNCHES"),
    "sh_encode_backward_backward": ("sh_encode", "BWDBWD_LAUNCHES"), "grid_fwd": ("grid_encode", "LAUNCHES"),
    "grid_bwd": ("grid_encode", "BWD_LAUNCHES"), "ffmlp_fwd": ("ffmlp", "LAUNCHES"),
}
SH_PENALTY_PATH = ("module API: direction-gradient penalty on the NeRF sample's network (the NeRF sample's own path "
                   "differentiates no direction: 0 there)")
SH_PENALTY_TOL_NOTE = ("the network's and the table's gradients each within 1e-2 of the plain path's in norm, and "
                       "p99 RAE <= 1e-2 over all parameters (tests/utils.py:match_rae(1e-2, percentile=99), as the "
                       "CPU tests hold a bf16 training step): the bf16 network's roundings flip where its fp32 inputs "
                       "differ in the last bits")


def _sh_bwdbwd_close(got, want, dtype, what):
    """``SH_BWDBWD_TOL_NOTE``; returns max |diff|."""
    import torch

    got, want = got.float(), want.float()
    check(got.shape == want.shape and bool(got.isfinite().all()), f"{what}: bad shape or non-finite values")
    diff = (got - want).abs()
    scale = float(want.abs().max())
    ulp = 0.0
    if dtype == torch.bfloat16:
        ulp = torch.where(want == 0, torch.zeros_like(want), torch.exp2(torch.floor(torch.log2(want.abs())) - 7))
    check(bool((diff <= ulp + 1e-5 * scale).all()), f"{what}: max|diff| {float(diff.max()):.3e} beyond "
          f"{SH_BWDBWD_TOL_NOTE}")
    return float(diff.max())


def _sh_bwdbwd_check(gen):
    """tcnn_sh_backward_backward against sh_backward_backward_plain at
    degrees 1-8 x SH_BATCHES x (strided x with a dL/dy 4 or 2 bytes past a
    16-byte boundary; contiguous) x dL/dy bf16, fp32 x the three need
    flags; one launch a call, zeros in the padding columns, two calls give
    the same bits. Returns (max |diff| of d/dx, of fp32 d/d(dL/dy), of
    bf16 d/d(dL/dy), cases)."""
    import torch

    from tcnn_tpu_torch.ops import sh_encode as sh

    err_x, err_dy = 0.0, {torch.bfloat16: 0.0, torch.float32: 0.0}
    n_cases = 0
    for degree in range(1, sh.MAX_DEGREE + 1):
        for batch in SH_BATCHES:
            wide = torch.rand((batch, 6), generator=gen, device="cuda")
            c = torch.randn((batch, 3), generator=gen, device="cuda")
            for misaligned in (True, False):
                x = wide[:, 3:] if misaligned else wide[:, :3].contiguous()
                pad = (-degree * degree) % 8 + misaligned
                width = pad + degree * degree
                for dtype in (torch.bfloat16, torch.float32):
                    flat = torch.randn((batch * width + misaligned,), generator=gen, device="cuda").to(dtype)
                    dy = flat[misaligned:].view(batch, width)
                    what = f"sh double backward degree {degree} B={batch} {dtype} pad {pad}"
                    want_x, want_dy = sh.sh_backward_backward_plain(x, dy, c, degree, pad)
                    for need_x, need_dy in ((True, True), (True, False), (False, True)):
                        before = sh.BWDBWD_LAUNCHES
                        got_x, got_dy = sh.sh_backward_backward(x, dy, c, degree, pad, need_x, need_dy)
                        check(sh.BWDBWD_LAUNCHES == before + 1, f"{what}: not one launch")
                        check((got_x is None) != need_x and (got_dy is None) != need_dy, f"{what}: need flags")
                        if need_x:
                            err_x = max(err_x, _sh_bwdbwd_close(got_x, want_x, torch.float32, f"{what} d/dx"))
                        if need_dy:
                            check(got_dy.dtype == dtype and not bool(got_dy[:, :pad].any()),
                                  f"{what}: d/d(dL/dy) dtype or padding columns")
                            err_dy[dtype] = max(err_dy[dtype], _sh_bwdbwd_close(got_dy, want_dy, dtype,
                                                                                 f"{what} d/d(dL/dy)"))
                        if need_x and need_dy:
                            both = got_x, got_dy
                        n_cases += 1
                    again = sh.sh_backward_backward(x, dy, c, degree, pad)
                    check(torch.equal(again[0], both[0]) and torch.equal(again[1], both[1]),
                          f"{what}: two calls differ")
    return err_x, err_dy[torch.float32], err_dy[torch.bfloat16], n_cases


def _sh_penalty_loss(m, plain, rays):
    """The NeRF sample's rendering loss of the module ``m`` on ``rays``
    (its field, sigma and rgb from the raw outputs, against the analytic
    scene) plus SH_PENALTY_WEIGHT times the mean square of d(sum of the rgb
    outputs) / d(direction columns), taken with create_graph; through
    ``m.apply_plain`` with ``plain``."""
    import torch

    from tcnn_tpu_torch.samples import nerf_synthetic as ns

    origins, dirs, jitter = rays
    target = ns.render(ns.gt_field, origins, dirs, jitter)
    penalty = []

    def field(pts, d):
        dd = ((d + 1.0) * 0.5).detach().requires_grad_(True)
        x = torch.cat([pts, dd], dim=1)
        out = (m.apply_plain(m.params, x)[:, :4] if plain else m(x)).float()
        (g,) = torch.autograd.grad(out[:, :3].sum(), dd, create_graph=True)
        penalty.append((g * g).mean())
        return torch.nn.functional.softplus(out[:, 3] - 1.0), torch.sigmoid(out[:, :3])

    pred = ns.render(field, origins, dirs, jitter)
    return ns.nerf_loss(pred, target) + SH_PENALTY_WEIGHT * penalty[0]


def _sh_penalty_path(card):
    """The direction-gradient penalty on the NeRF sample's own network
    (modules.NetworkWithInputEncoding(6, 4, CONFIG's encoding and network),
    256,480 params) at NERF_RAYS x 32 = 2^18 samples: one step's parameter
    gradient against the same step through apply_plain, then
    SH_PENALTY_STEPS steps of torch.optim.Adam with the counts at 0 just
    before and read just after."""
    import torch

    from tcnn_tpu_torch import modules
    from tcnn_tpu_torch.ops import sh_encode as sh
    from tcnn_tpu_torch.samples import nerf_synthetic as ns

    dev = torch.device("cuda")
    m = modules.NetworkWithInputEncoding(6, 4, ns.CONFIG["encoding"], ns.CONFIG["network"], seed=SEED + 23)
    check(m.n_params == 256480, f"sh penalty: {m.n_params} params")
    n_net = m._model.network.n_params
    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    rays = ns.draw_rays(NERF_RAYS, gen, dev)
    grads = {}
    for plain in (False, True):
        sh.PLAIN_BWDBWD_ON_CARD, before = 0, sh.BWDBWD_LAUNCHES
        loss = _sh_penalty_loss(m, plain, rays)
        (grads[plain],) = torch.autograd.grad(loss, m.params)
        if not plain:
            check(sh.BWDBWD_LAUNCHES == before + 1 and sh.PLAIN_BWDBWD_ON_CARD == 0,
                  f"sh penalty: {sh.BWDBWD_LAUNCHES - before} double-backward launches and "
                  f"{sh.PLAIN_BWDBWD_ON_CARD} plain double backwards on the card in one step")
    got, want = grads[False], grads[True]
    _grads_close(got, want, n_net, "sh penalty step", rtol=1e-2)
    diff, denom = (got - want).abs(), got.abs() + want.abs()
    rae = torch.where(denom == 0, torch.zeros_like(diff), 2 * diff / torch.where(denom == 0, 1, denom))
    p99 = float(rae.kthvalue(max(1, int(np.ceil(0.99 * rae.numel())))).values)
    check(p99 <= 1e-2, f"sh penalty step: p99 RAE of the parameter gradient {p99:.3e} > 1e-2")
    opt = torch.optim.Adam([m.params], lr=1e-2, betas=(0.9, 0.99), eps=1e-15)
    _zero_counts(SH_PENALTY_COUNTERS)
    sh.PLAIN_BWDBWD_ON_CARD = 0
    losses = []
    t0 = time.perf_counter()
    for _ in range(SH_PENALTY_STEPS):
        loss = _sh_penalty_loss(m, False, ns.draw_rays(NERF_RAYS, gen, dev))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts(SH_PENALTY_COUNTERS)
    losses = torch.stack(losses).cpu().numpy()
    check(np.isfinite(losses).all() and bool(m.params.isfinite().all()), "sh penalty: non-finite loss or params")
    check(float(losses[-1]) < float(losses[0]), f"sh penalty: loss {losses[0]:.4e} -> {losses[-1]:.4e}")
    for k, v in launches.items():
        check(v > 0, f"sh penalty: kernel {k} was not launched")
    check(launches["sh_encode_backward_backward"] == SH_PENALTY_STEPS,
          f"sh penalty: {launches['sh_encode_backward_backward']} double-backward launches in {SH_PENALTY_STEPS} steps")
    check(sh.PLAIN_BWDBWD_ON_CARD == 0, f"sh penalty: {sh.PLAIN_BWDBWD_ON_CARD} plain double backwards on the card")
    log(f"sh penalty [{card}]: the NeRF sample's network (modules.NetworkWithInputEncoding, 256,480 params) at "
        f"{NERF_RAYS} rays x {ns.N_SAMPLES} samples, rendering loss + {SH_PENALTY_WEIGHT} mean |d rgb / d dir|^2 "
        f"(create_graph), torch.optim.Adam lr 1e-2: one step's parameter gradient kernel vs apply_plain p99 RAE "
        f"{p99:.3e} ({SH_PENALTY_TOL_NOTE}); {SH_PENALTY_STEPS} steps, loss {', '.join(f'{v:.4e}' for v in losses)}, "
        f"{wall / SH_PENALTY_STEPS * 1e3:.2f} ms a step (host clock, first step included); kernel launches (counts "
        f"at 0 just before, read just after) {launches}; plain double backwards on the card: "
        f"{sh.PLAIN_BWDBWD_ON_CARD}")
    return {"launches": launches, "p99": p99, "ms": wall / SH_PENALTY_STEPS * 1e3}


def phase_sh_kernel(card):
    import torch

    from tcnn_tpu_torch.benchmarks import sh_times
    from tcnn_tpu_torch.ops import sh_encode as sh

    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    err_fwd = err_bwd = 0.0
    n_cases = 0
    sh.ROUTE_LAUNCHES.clear()
    for degree in range(1, sh.MAX_DEGREE + 1):
        for batch in SH_BATCHES:
            wide = torch.rand((batch, 6), generator=gen, device="cuda")
            for strided, which in itertools.product((True, False), ("vector", "staged")):
                x = wide[:, 3:] if strided else wide[:, :3].contiguous()
                pad = (-degree * degree) % 8 + (which == "staged")
                want = sh.sh_encode_plain(x, degree, pad, 1.0, torch.float32)
                before = dict(sh.ROUTE_LAUNCHES)
                got = sh.sh_encode(x, degree, pad, 1.0, torch.float32)
                err_fwd = max(err_fwd, f32_close(got, want, f"sh forward degree {degree} B={batch} fp32 {which}"))
                got16 = sh.sh_encode(x, degree, pad, 1.0, torch.bfloat16).float()
                check(sh.ROUTE_LAUNCHES.get(("forward", which), 0) == before.get(("forward", which), 0) + 2,
                      f"sh forward degree {degree} pad {pad}: not launched on the {which} route")
                ulp = torch.where(want == 0, torch.zeros_like(want),
                                  torch.exp2(torch.floor(torch.log2(want.abs())) - 7))
                check(bool(((got16 - want).abs() <= ulp + 1e-5 * want.abs().max()).all()),
                      f"sh forward degree {degree} B={batch} bf16 {which}: beyond one bf16 ulp of the plain value")
                check(bool((got16[:, :pad] == 1.0).all()), "sh: a padding column is not 1.0")
                for dy_dtype in (torch.bfloat16, torch.float32):
                    dy = torch.randn((batch, pad + degree * degree), generator=gen, device="cuda").to(dy_dtype)
                    want_dx = sh.sh_backward_input_plain(x, dy, degree, pad)
                    before = sh.ROUTE_LAUNCHES.get(("backward", which), 0)
                    got_dx = sh.sh_backward_input(x, dy, degree, pad)
                    check(sh.ROUTE_LAUNCHES.get(("backward", which), 0) == before + 1,
                          f"sh dL/dx degree {degree} pad {pad}: not launched on the {which} route")
                    if degree == 1:
                        check(not bool(got_dx.any()), "sh backward degree 1: the gradient of a constant is not 0")
                    else:
                        err_bwd = max(err_bwd, f32_close(got_dx, want_dx, f"sh dL/dx degree {degree} B={batch} "
                                                                          f"{which}"))
                    check(torch.equal(got_dx, sh.sh_backward_input(x, dy, degree, pad)),
                          f"sh dL/dx degree {degree}: two calls differ")
                check(torch.equal(got, sh.sh_encode(x, degree, pad, 1.0, torch.float32)),
                      f"sh forward degree {degree}: two calls differ")
                n_cases += 1
    torch.cuda.synchronize()
    routes = {f"{k} {w}": v for (k, w), v in sorted(sh.ROUTE_LAUNCHES.items())}
    log(f"kernel sh_encode: tcnn_sh_forward / tcnn_sh_backward_input vs plain on both routes, degrees 1-8 x B in "
        f"{SH_BATCHES} x (a strided (B, 6)[:, 3:] input; a contiguous one) x (the vector route's padding; one "
        f"column more, the staged route), fp32 and bf16 output, bf16 and fp32 dL/dy ({n_cases} cases; launches by "
        f"route {routes}): forward max|diff| {err_fwd:.3e}, dL/dx max|diff| {err_bwd:.3e}; two calls give the "
        f"same bits; tolerance: {SH_TOL_NOTE}")

    # Times at the NeRF path's shapes: 2^18 samples, degree 3, 7 pad
    # columns, bf16 out and dL/dy, the directions a column slice of the
    # (B, 6) input; device time (the kernel under the profiler; events
    # beside it) cold (a ring of 8 buffer sets beyond the L2) and warm, and
    # call time, the plain versions' in turns with the kernels' (plain,
    # kernel, kernel, plain).
    B = 2**18
    x = torch.rand((B, 6), generator=gen, device="cuda")[:, 3:]
    dy = torch.randn((B, 16), generator=gen, device="cuda").to(torch.bfloat16)
    fns = {
        ("kernel", "fwd"): lambda: sh.sh_encode(x, 3, 7, 1.0, torch.bfloat16),
        ("plain", "fwd"): lambda: sh.sh_encode_plain(x, 3, 7, 1.0, torch.bfloat16),
        ("kernel", "bwd"): lambda: sh.sh_backward_input(x, dy, 3, 7),
        ("plain", "bwd"): lambda: sh.sh_backward_input_plain(x, dy, 3, 7),
    }
    ms = {k: [] for k in fns}
    for side in ("plain", "kernel", "kernel", "plain"):
        for what in ("fwd", "bwd"):
            ms[(side, what)].append(_event_ms(fns[(side, what)]))
    dev_t = sh_times.times()
    # Operations: ~40 fp32 a sample forward, ~110 backward at degree 3, as
    # the kernels unroll them; bytes as sh_times.BYTES.
    bounds = {"fwd": bound(sh_times.BYTES["forward"], B * 40, "fp32"),
              "bwd": bound(sh_times.BYTES["backward"], B * 110, "fp32")}
    out = {}
    for what, key, label in (("fwd", "forward", "tcnn_sh_forward"), ("bwd", "backward", "tcnn_sh_backward_input")):
        d = dev_t[key]
        call, p = statistics.median(ms[("kernel", what)]), statistics.median(ms[("plain", what)])
        b = bounds[what][0]
        out[what] = {"kernel": d["cold_ms"], "plain": p, "bound": bounds[what], "library": None, "call_ms": call,
                     "warm_ms": d["warm_ms"]}
        log(f"time [{card}]: {label} B=2^18, degree 3, 7 pad columns, bf16, strided input: device ms (the kernel "
            f"under torch.profiler) cold {d['cold_ms']:.4f} ({b / d['cold_ms']:.2f} of the bound), warm "
            f"{d['warm_ms']:.4f} ({b / d['warm_ms']:.2f}: L2's rate, not HBM's); CUDA events around one call behind "
            f"a spin kernel cold {d['cold_event_ms']:.4f}, warm {d['warm_event_ms']:.4f} (their floor, a one-cycle "
            f"kernel: {dev_t['event_floor_ms']:.4f}); cold it moves {d['sector_bytes'] / 1e6:.1f} MB (the positions' "
            f"sectors, whole rows) at {d['cold_tb_s']:.3f} TB/s, PyTorch's copy_ of the (B, 16) bf16 rows over the "
            f"same buffers at {dev_t['copy_ of the (B, 16) bf16 rows']['cold_tb_s']:.3f}; call ms {call:.4f} (CUDA "
            f"events over 10 calls, median of plain, kernel, kernel, plain: the wrapper's host time); plain "
            f"{p:.4f} ms; bound {b:.4f} ms "
            f"({bounds[what][1]}); no single PyTorch call computes the SH basis")
    err_x, err_dy, err_dy16, n_bb = _sh_bwdbwd_check(gen)
    log(f"kernel sh_encode: tcnn_sh_backward_backward vs autograd of the plain vjp, degrees 1-8 x B in {SH_BATCHES} x "
        f"(a strided (B, 6)[:, 3:] input with a dL/dy 4 or 2 bytes past a 16-byte boundary; a contiguous one) x bf16 "
        f"and fp32 dL/dy x need (x, dL/dy), x, dL/dy ({n_bb} calls): d/dx max|diff| {err_x:.3e}, fp32 d/d(dL/dy) "
        f"{err_dy:.3e}, bf16 d/d(dL/dy) {err_dy16:.3e} (its bf16 rounding included); padding columns 0; two calls "
        f"give the same bits; tolerance: {SH_BWDBWD_TOL_NOTE}")
    penalty = _sh_penalty_path(card)
    for name, (degree, pad, dtype_name, _) in sh_times.BWDBWD_SHAPES.items():
        d = dev_t[f"double_backward {name}"]
        itemsize = 2 if dtype_name == "bfloat16" else 4
        b = bound(B * sh_times.bwdbwd_bytes(degree, pad, itemsize), B * sh_times.bwdbwd_ops(degree), "fp32")
        out[f"bwdbwd {name}"] = {"kernel": d["kernel_cold_ms"], "plain": d["plain_ms"], "bound": b, "library": None,
                                 "call_ms": d["kernel_call_ms"], "warm_ms": d["kernel_warm_ms"],
                                 "autograd_ms": d["autograd_cold_ms"]}
        log(f"time [{card}]: tcnn_sh_backward_backward B=2^18, degree {degree}, {pad} pad columns, {dtype_name} "
            f"dL/dy: device ms (the kernel under torch.profiler) cold {d['kernel_cold_ms']:.4f} "
            f"({b[0] / d['kernel_cold_ms']:.2f} of the bound), warm {d['kernel_warm_ms']:.4f}; call ms "
            f"{d['kernel_call_ms']:.4f}; torch.autograd.grad of ShBackwardFunction's dL/dx in (x, dL/dy), every device "
            f"op of the call: cold {d['autograd_cold_ms']:.4f}, warm {d['autograd_warm_ms']:.4f}, call "
            f"{d['autograd_call_ms']:.4f}; plain (sh_backward_backward_plain) {d['plain_ms']:.4f} ms; bound "
            f"{b[0]:.4f} ms ({b[1]}: {B * sh_times.bwdbwd_bytes(degree, pad, itemsize) / 1e6:.1f} MB, "
            f"{B * sh_times.bwdbwd_ops(degree) / 1e6:.0f} M fp32 operations); no PyTorch call differentiates the SH "
            f"basis twice")
    return {"err_fwd": err_fwd, "err_bwd": err_bwd, "err_bwdbwd": max(err_x, err_dy), "times": out, "routes": routes,
            "penalty": penalty}


def _nerf_grid_check(grid, pts, gen):
    """The NeRF grid's lookup and table gradient at the step's own shapes:
    the 2^18 clamped sample points of one step (many exactly 0 or 1), 8 3D
    levels x 2 features, 2^15 rows, table entries uniform in [-1, 1) and a
    bf16 dL/dy of the grid's width; the lookup against ``apply_plain`` (fp32
    rtol 1e-5 atol 1e-6, as kernel2), the table gradient level by level in
    its training classes (``_levels_check``)."""
    import torch

    dev = pts.device
    params = torch.rand((grid.n_params,), generator=gen, device=dev) * 2 - 1
    on_edge = float(((pts == 0) | (pts == 1)).any(dim=1).float().mean())
    dtype = grid.output_dtype
    with torch.no_grad():
        grid.output_dtype = torch.float32
        got = grid.apply(params, pts)
        want = grid.apply_plain(params, pts)
        grid.output_dtype = dtype
    torch.cuda.synchronize()
    check(got.shape == (pts.shape[0], grid.padded_output_width) and bool(torch.isfinite(got).all()),
          "nerf grid: bad lookup output")
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, rtol=1e-5, atol=1e-6), f"nerf grid: lookup max|diff| {err:.3e}")
    dy = torch.randn((pts.shape[0], grid.padded_output_width), generator=gen, device=dev).bfloat16()
    classes = torch.from_numpy(grid.gradient_classes(pts.shape[0])).to(dev)
    from tcnn_tpu_torch.ops import grid_encode as ge

    bwd = ge.grid_backward(pts, dy, grid._levels_on(dev), grid.n_features_per_level, ge.INTERP_LINEAR, classes)
    g_err = _levels_check(grid, bwd, pts, dy, classes, "nerf grid_bwd")
    log(f"kernel grid_fwd / grid_bwd at the NeRF step's shapes ({pts.shape[0]} clamped sample points, "
        f"{on_edge:.3f} of them on a face of [0,1]^3; {grid.n_levels} 3D levels x {grid.n_features_per_level}, "
        f"2^{grid.log2_hashmap_size} rows): lookup matches apply_plain (fp32 rtol 1e-5 atol 1e-6), max|diff| "
        f"{err:.3e}; table gradient matches the plain version level by level in its classes ({CLASS_TOL[0]}), "
        f"max|diff| {g_err:.3e}")


def phase_nerf(card):
    """The NeRF sample at full width (its own CONFIG: 256,480 params, 8192
    rays x 32 samples a step) through its entry point, every count at 0
    just before and read just after; then one step kernel vs plain and a
    profile of the step."""
    import torch

    import tcnn_tpu_torch as tt
    from tcnn_tpu_torch.utils.profiling import profile_steps
    from tcnn_tpu_torch.samples import nerf_synthetic as ns

    _zero_counts(NERF_COUNTERS)
    t0 = time.perf_counter()
    res = ns.main([str(NERF_STEPS), str(NERF_RAYS)])
    wall = time.perf_counter() - t0
    launches = _read_counts(NERF_COUNTERS)
    curve = res["loss_curve"]
    check(_all_finite(res), "nerf: a value is not finite")
    check(curve[-1][1] < 0.5 * curve[0][1], f"nerf: loss did not fall ({curve[0][1]:.4e} -> {curve[-1][1]:.4e})")
    for k, v in launches.items():
        check(v > 0, f"nerf: kernel {k} was not launched on the NeRF path")
    check(res["n_params"] == 256480, f"nerf: {res['n_params']} params")
    log(f"nerf [{card}]: samples.nerf_synthetic {NERF_STEPS} steps x {NERF_RAYS} rays x {ns.N_SAMPLES} samples "
        f"(2^18 field evaluations a step), 256,480 params: loss {curve[0][1]:.4e} -> {curve[-1][1]:.4e}; validation "
        f"PSNR {res['psnr_db']:.3f} dB, served view {res['served_psnr_db']:.3f} dB; {res['ms_per_step']:.4f} ms/step "
        f"(host clock, steps 1-{NERF_STEPS - 1}); served render {res['fps']:.1f} frames/s of {ns.VAL_RES}^2 x {ns.N_SAMPLES} "
        f"({res['evals_per_s'] / 1e6:.1f} M field evaluations/s); {wall:.1f} s in all; kernel launches (counts at 0 "
        f"just before, read just after): {launches}")
    psnrs = [res["psnr_db"]]
    for seed in NERF_SEEDS[1:]:
        other = ns.main([str(NERF_STEPS), str(NERF_RAYS), "--seed", str(seed)])
        check(_all_finite(other), f"nerf seed {seed}: a value is not finite")
        psnrs.append(other["psnr_db"])
    median = statistics.median(psnrs)
    log(f"nerf [{card}]: validation PSNR of seeds {NERF_SEEDS}: {', '.join(f'{v:.3f}' for v in psnrs)} dB, median "
        f"{median:.3f} (floors: median {NERF_PSNR_FLOOR}, each run {NERF_RUN_PSNR_FLOOR}; the JAX package read "
        f"{NERF_JAX_TPU_PSNR} dB on a TPU v5e)")
    check(median >= NERF_PSNR_FLOOR, f"nerf: median PSNR {median:.3f} dB below {NERF_PSNR_FLOOR} dB")
    check(min(psnrs) >= NERF_RUN_PSNR_FLOOR, f"nerf: a run's PSNR {min(psnrs):.3f} dB below {NERF_RUN_PSNR_FLOOR} dB")

    m = tt.create_from_config(6, 4, ns.CONFIG, seed=SEED, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    rays = ns.draw_rays(NERF_RAYS, gen, torch.device("cuda"))
    _compare_one_step("nerf", m, float(m.trainer.learning_rate), lambda plain: ns.train_step(m, *rays, plain=plain))
    _nerf_grid_check(m.model.encoding.nested[0], ns.sample_points(*rays)[0], gen)
    wall_p, busy, idle, kernels = profile_steps(lambda: ns.train_step(m, *ns.draw_rays(NERF_RAYS, gen, rays[0].device)))
    log(f"profile [{card}]: nerf train_step, 8192 rays x 32 samples, 10 steps back to back under torch.profiler: "
        f"{wall_p:.4f} ms/step, device busy {busy:.4f} ms, idle share {idle:.3f}, {len(kernels)} distinct device ops; "
        f"largest (ms/step): " + "; ".join(f"{k[:60]} {v:.4f}" for k, v in kernels[:10]))
    return {"launches": launches, "result": res, "profile": (wall_p, busy, idle, kernels)}


def phase_nerf_graph(card):
    """tests/test_nerf_config.py's NERF_CONFIG: 20 replays of the captured
    step (Trainer.training_steps) against 20 training_step calls, on the
    _graph_vs_loop tolerances, B = 2^18 positions and directions drawn on
    the card."""
    import math

    import torch

    import tcnn_tpu_torch as tt

    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    pos = torch.rand((N_GRAPH_STEPS, B_FLAG, 3), generator=gen, device="cuda")
    dirs = torch.rand((N_GRAPH_STEPS, B_FLAG, 3), generator=gen, device="cuda")
    t = torch.stack([torch.sin(4 * math.pi * pos[..., 0]) * 0.5 + 0.5, pos[..., 1] * dirs[..., 0],
                     (pos[..., 2] + dirs[..., 2]) / 2, pos[..., 0] * pos[..., 1]], -1)
    data = {"x": torch.cat([pos, dirs], -1), "t": t}
    # Two training_step loops of this config from one seed drift 0.85e-4 to
    # 2.8e-4 apart in loss by step 20 (the table gradient's fp32 atomics;
    # PERF.md §6), so the same loop runs on four more trainers and the
    # graph is held to their spread where it exceeds 1e-4.
    graph, loop, *again = (tt.create_from_config(6, 4, NERF_TEST_CONFIG, seed=SEED, device="cuda") for _ in range(6))
    got, want, rel, worst, launches, spread = _graph_vs_loop(
        "NERF_CONFIG", graph, loop, data, N_GRAPH_STEPS, float(loop.trainer.learning_rate), NERF_COUNTERS, again)
    for k, v in launches.items():
        check(v > 0, f"NERF_CONFIG: kernel {k} was not launched by training_steps (warm-up and capture)")
    check(float(got[-1]) < float(got[0]), f"NERF_CONFIG: loss {float(got[0])} -> {float(got[-1])}")
    log(f"graph [NERF_CONFIG]: training_steps({N_GRAPH_STEPS}) replayed vs {N_GRAPH_STEPS} training_step calls, "
        f"same seed and batches (B=2^18, Composite[HashGrid 2^13 + SH degree 4] -> FFMLP 64x2): losses "
        f"{float(got[0]):.6f} -> {float(got[-1]):.6f} vs {float(want[0]):.6f} -> {float(want[-1]):.6f}, first "
        f"bitwise, max rel {rel:.2e} (the same loop on four more trainers, largest: {spread:.2e}; bound max(1e-4, 2 x "
        f"that)); params and "
        f"inference params max|diff| {worst:.3e} (bound 2 lr); kernel launches of warm-up and capture: {launches}")
    return {"launches": launches, "rel": rel}


# The grid extras and the trainer's extras at the flagship's full width
# (FLAGSHIP_CONFIG, B = 2^18), one at a time: the Rng hash, fixed_point_pos
# (the sampler's points as uint32), stochastic interpolation through the
# Trainer (deterministic, as the JAX package's trainer) and through
# GridEncoding.apply(rng=generator) (the one-corner table gradient, via
# NetworkWithInputEncoding.apply and torch.optim.Adam), Shampoo and
# perturbation_sigma = 0.1.
EXTRA_FIT_STEPS = 100
EXTRA_PATHS = ("Rng", "fixed_point_pos", "stochastic_interpolation", "Shampoo", "perturbation_sigma")
# The table gradient's instantiation (library, C entry point) of each grid
# extra at the flagship's d = 2 (ops/grid_encode.py:_backward_route); the
# Trainer's stochastic_interpolation is deterministic: the common one.
EXTRA_ROUTES = {
    "Rng": ("grid_bwd_rng", "tcnn_grid_backward_rng"),
    "fixed_point_pos": ("grid_bwd_modes", "tcnn_grid_backward_fixed"),
    "stochastic_interpolation": ("grid_bwd_modes", "tcnn_grid_backward_sampled"),
}


def _extra_config(flagship, name):
    import copy

    cfg = copy.deepcopy(flagship)
    if name == "Rng":
        cfg["encoding"]["hash"] = "Rng"
    elif name == "fixed_point_pos":
        cfg["encoding"]["fixed_point_pos"] = True
    elif name == "stochastic_interpolation":
        cfg["encoding"]["stochastic_interpolation"] = True
    elif name == "Shampoo":
        cfg["optimizer"] = {"otype": "Shampoo", "learning_rate": 1e-2}
    return cfg


def _as_fixed(xy):
    """Positions in [0, 1) as uint32 fixed point (x * 2^32, floored)."""
    import torch

    return torch.clamp((xy.double() * 2.0**32).floor(), 0, 2**32 - 1).to(torch.int64).to(torch.uint32)


def _popcount(v):
    """Set bits of each uint32 value held in int64 (SWAR)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def _rng_ops(enc, x):
    """INT32 instructions the Rng hash needs for these positions, counting
    3 a 64-bit multiply or multiply-add (IMAD.WIDE and two IMAD), as
    csrc/grid_common.cuh:rng_corners computes the keys: per (sample, Rng
    level) whose fields stay apart, a multiply and a multiply-add per set bit
    of each field (below bit 64), 2 a dim for the upper neighbour's jump and
    2^(d+1) - 2 multiply-adds for the corners' states; per other pair, and
    per corner, the per-corner jump (rng_hash): 2 a set bit of the step and 1
    at the end. Returns (those instructions, the per-corner jump's for every
    pair, Rng levels, the share of pairs that jumped corner by corner). The
    set bits are this run's."""
    import torch

    from tcnn_tpu_torch.ops import grid_encode as ge
    from tcnn_tpu_torch.ops.pcg32_jump import rng_step

    lt = enc.level_table().view(np.uint32).astype(np.int64)
    d = x.shape[1]
    w = 64 // d
    bits = torch.from_numpy(ge._corner_bits(d, ge.INTERP_LINEAR)).to(x.device)
    ops, per_corner, n_levels, n_corner_pairs, n_pairs = 0, 0, 0, 0, 0
    for row in lt:
        if int(row[2]) != ge.MODE_RNG:
            continue
        pos_grid, _ = ge._level_cell(x, row, ge.INTERP_LINEAR)
        p = pos_grid & 0xFFFFFFFF
        hi, lo = rng_step((p[:, None, :] + bits[None]) & 0xFFFFFFFF)
        corner_ops = ((_popcount(hi) + _popcount(lo)) * 2 + 1).sum(dim=1) * 3
        apart = (p != 0xFFFFFFFF).all(dim=1)
        if w < 32:
            apart &= (p[:, :-1] + 1 < 2**w).all(dim=1)
        field_bits = sum(_popcount(p[:, i] & (2 ** min(32, 64 - i * w) - 1)) for i in range(d))
        cell_ops = (field_bits * 2 + 2 * d + 2 ** (d + 1) - 2) * 3
        ops += int(torch.where(apart, cell_ops, corner_ops).sum())
        per_corner += int(corner_ops.sum())
        n_corner_pairs += int((~apart).sum())
        n_pairs += len(p)
        n_levels += 1
    return ops, per_corner, n_levels, n_corner_pairs / max(n_pairs, 1)


def _extra_kernels(card, flagship):
    """Each new mode of the lookup and the table gradient (and G1 / G2 under
    Rng) against its plain version at the flagship's shapes, then their
    times beside the CoherentAdditive kernels, in one call."""
    import torch

    from tcnn_tpu_torch.encodings import create_encoding
    from tcnn_tpu_torch.ops import grid_encode as ge
    from tcnn_tpu_torch.ops.scatter_rows import ACC_BF16, CONTRIB_RN

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    B = B_FLAG
    encs = {name: create_encoding(2, _extra_config(flagship, name)["encoding"], alignment=16)
            for name in ("CoherentAdditive", "Rng", "fixed_point_pos", "stochastic_interpolation")}
    params = torch.rand((encs["Rng"].n_params,), generator=gen, device=dev) * 2 - 1
    x = torch.rand((B, 2), generator=gen, device=dev)
    x[:256] = torch.rand((256, 2), generator=gen, device=dev) * 1.4 - 0.2  # points outside [0, 1]
    xs = {name: _as_fixed(x.clamp(0, 1)) if name == "fixed_point_pos" else x for name in encs}
    dy = torch.randn((B, 32), generator=gen, device=dev).bfloat16()
    u = encs["stochastic_interpolation"]._uniforms(gen, B, dev)
    err, out = {}, {}
    for name, enc in encs.items():
        if name == "CoherentAdditive":
            continue
        xe = xs[name]
        enc.output_dtype = torch.float32
        with torch.no_grad():
            got, want = enc.apply(params, xe), enc.apply_plain(params, xe)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"extras {name}: bad lookup output")
        e = float((got - want).abs().max())
        if name == "Rng":  # the hash changes no float operation: bit for bit
            check(torch.equal(got, want), f"extras {name}: lookup not bitwise, max|diff| {e:.3e}")
        else:
            check(torch.allclose(got, want, rtol=1e-5, atol=1e-6), f"extras {name}: lookup max|diff| {e:.3e}")
        err[f"{name} fwd"] = e
        enc.output_dtype = torch.bfloat16
        uu = u if name == "stochastic_interpolation" else None
        stratified = False if uu is not None else None
        classes_sets = {"own classes": torch.from_numpy(enc.gradient_classes(B, stratified)).to(dev)}
        if name == "stochastic_interpolation":
            classes_sets["(RN, bf16)"] = torch.tensor([[CONTRIB_RN, ACC_BF16]] * enc.n_levels, dtype=torch.int32,
                                                      device=dev)
        route = EXTRA_ROUTES[name]
        for label, classes in classes_sets.items():
            before = ge.BWD_ROUTE_LAUNCHES.get(route, 0)
            g = ge.grid_backward(xe, dy, enc._levels_on(dev), 2, ge.INTERP_LINEAR, classes, u=uu)
            check(ge.BWD_ROUTE_LAUNCHES.get(route, 0) == before + 1,
                  f"extras {name} table gradient: {route[1]} of {route[0]} was not launched")
            e = _levels_check(enc, g, xe, dy, classes, f"extras {name} table gradient ({label})", u=uu)
            err[f"{name} bwd {label}"] = e
    # G1 and G2 under Rng (not on a training path: the kernels' check).
    enc = encs["Rng"]
    args = (enc._levels_on(dev), 2, ge.INTERP_LINEAR)
    cgx = torch.randn((B, 2), generator=gen, device=dev)
    cgp = torch.randn((enc.n_params,), generator=gen, device=dev)
    classes = torch.from_numpy(enc.gradient_classes(B)).to(dev)
    err["Rng G1"] = f32_close(ge.grid_backward_input(x, dy, params, *args),
                              ge.grid_backward_input_plain(x, dy, params, *args), "extras Rng G1")
    got = ge.grid_backward_backward(x, dy, params, *args, classes, cgp, cgx)
    want = ge.grid_backward_backward_plain(x, dy, params, *args, classes, cgp, cgx)
    err["Rng G2"] = max(f32_close(a, b, "extras Rng G2") for a, b in zip(got, want))
    log(f"kernel extras (flagship encoding, B=2^18, uniform points with 256 outside [0,1]; fixed point: the same "
        f"points as uint32; stochastic: one uniform per (sample, level) handed to kernel and plain alike): max "
        f"|kernel - plain| " + "; ".join(f"{k} {v:.3e}" for k, v in err.items()) + f"; lookup fp32 rtol 1e-5 atol "
        f"1e-6 (Rng: bitwise), table gradient {CLASS_TOL[0]} / {CLASS_TOL[1]}, G1/G2 {TOL_F32_NOTE}")

    # Times: each mode beside the CoherentAdditive kernels, plain, kernel,
    # kernel, plain; bf16 output and dy as on the training path.
    n_rng_ops, n_corner_ops, n_rng_levels, corner_share = _rng_ops(encs["Rng"], x)
    n_params = encs["Rng"].n_params
    lookup_bytes = B * 2 * 4 + n_params * 4 + B * 32 * 2
    bwd_bytes = B * 2 * 4 + B * 32 * 2 + n_params * 4
    fns = {}
    for name, enc in encs.items():
        xe, uu = xs[name], (u if name == "stochastic_interpolation" else None)
        cls = torch.from_numpy(enc.gradient_classes(B, False if uu is not None else None)).to(dev)
        lv = enc._levels_on(dev)
        plan = ge.backward_plan(enc.level_table(), 2, B, cls)
        if name != "stochastic_interpolation":  # its lookup is the deterministic one
            fns[(name, "fwd")] = (lambda e=enc, xx=xe: e.apply(params, xx),
                                  lambda e=enc, xx=xe: e.apply_plain(params, xx))
        fns[(name, "bwd")] = (
            lambda xx=xe, l=lv, c=cls, p=plan, q=uu: ge.grid_backward(xx, dy, l, 2, ge.INTERP_LINEAR, c, p, q),
            lambda xx=xe, l=lv, c=cls, q=uu: ge.grid_backward_plain(xx, dy, l, 2, ge.INTERP_LINEAR, c, q))
    ms = {k: {"kernel": [], "plain": []} for k in fns}
    with torch.no_grad():
        for side in ("plain", "kernel", "kernel", "plain"):
            for key, (kern, plain) in fns.items():
                if side == "kernel":
                    ms[key]["kernel"].append(_event_ms(kern))
                else:
                    ms[key]["plain"].append(_event_ms(plain, iters=1, reps=3))
    bounds = {
        ("Rng", "fwd"): bound(lookup_bytes, n_rng_ops, "int32"),
        ("Rng", "bwd"): bound(bwd_bytes, n_rng_ops, "int32"),
        ("fixed_point_pos", "fwd"): bound(lookup_bytes, B * 16 * 4 * (2 + 2 * 2), "fp32"),
        ("fixed_point_pos", "bwd"): bound(bwd_bytes, B * 16 * 4 * 2, "fp32"),
        ("stochastic_interpolation", "bwd"): bound(bwd_bytes + B * 16 * 4, B * 16 * 2, "fp32"),
        ("CoherentAdditive", "fwd"): bound(lookup_bytes, B * 16 * 4 * (2 + 2 * 2), "fp32"),
        ("CoherentAdditive", "bwd"): bound(bwd_bytes, B * 16 * 4 * 2, "fp32"),
    }
    for key, runs in ms.items():
        k, p = statistics.median(runs["kernel"]), statistics.median(runs["plain"])
        b = bounds.get(key)
        out[key] = {"kernel": k, "plain": p, "bound": b, "library": None}
        what = "lookup tcnn_grid_forward" if key[1] == "fwd" else "table gradient tcnn_grid_backward"
        log(f"time [{card}]: extras {key[0]} {what} B=2^18 (uniform points, bf16, its training classes): kernel "
            f"{k:.4f} ms, plain {p:.4f} ms (CUDA events, medians of plain, kernel, kernel, plain)"
            + (f", bound {b[0]:.4f} ms ({b[1]})" if b else "")
            + ("; no single PyTorch call computes a hashed interpolation" if key[0] != "CoherentAdditive" else ""))
    ca = out[("CoherentAdditive", "bwd")]["kernel"]
    fixed, sampled = out[("fixed_point_pos", "bwd")]["kernel"], out[("stochastic_interpolation", "bwd")]["kernel"]
    log(f"time [{card}]: extras table gradients beside CoherentAdditive's over the same points ({ca:.4f} ms): "
        f"fixed_point_pos ({EXTRA_ROUTES['fixed_point_pos'][1]}) {fixed:.4f} ms, {fixed / ca:.4f}x (target 1.05x); "
        f"stochastic ({EXTRA_ROUTES['stochastic_interpolation'][1]}) {sampled:.4f} ms, {sampled / ca:.4f}x (target "
        f"0.5x)")
    log(f"extras Rng bound: {n_rng_levels} of 16 levels take the Rng hash; {n_rng_ops:.4e} INT32 instructions "
        f"for this run's cells as the kernels hash them (3 a 64-bit multiply-add; a cell whose fields stay apart: "
        f"2 a set bit of its fields, 2 a dim and 2^(d+1) - 2 for its corners; else per corner 2 a set bit of its "
        f"step and 1) at {PEAK_OPS_S['int32']:.4e}/s; the per-corner jump of every cell would take "
        f"{n_corner_ops:.4e}; (sample, Rng level) pairs that jumped corner by corner: {corner_share:.6f}")
    return {"err": err, "times": out, "rng_corner_share": corner_share}


def _extra_path(name, cfg, card, image, gen):
    """One extra's trainer path at full width: one step kernel vs plain from
    the same state, then EXTRA_FIT_STEPS steps through training_steps with
    the counts at 0 just before and read just after; the loss falls; its
    synced ms/step through the graph."""
    import torch

    import tcnn_tpu_torch as tt

    m = tt.create_from_config(2, 3, cfg, seed=SEED, device="cuda")
    if name == "perturbation_sigma":
        m.trainer = tt.Trainer(m.model, cfg["optimizer"], cfg["loss"], seed=SEED, perturbation_sigma=0.1)
    data = _image_batches(image, gen, EXTRA_FIT_STEPS, B_FLAG)
    fixed = name == "fixed_point_pos"
    if fixed:
        data["x"] = _as_fixed(data["x"]).to(torch.int64)

    def batch(d, i):
        x, y = _nth_batch(d, i)
        return (x.to(torch.uint32), y) if fixed else (x, y)

    t = m.trainer
    x0, y0 = batch(data, torch.zeros((), dtype=torch.int32, device="cuda"))
    state = None if t.perturbation_generator is None else t.perturbation_generator.get_state()

    def one(plain):
        if state is not None:
            t.perturbation_generator.set_state(state)
        return (t.training_step_plain if plain else t.training_step)(x0, y0)

    _compare_one_step(f"extras {name}", m, float(t.learning_rate), one)
    counters = {k: v for k, v in TRAIN_COUNTERS.items() if not (name == "Shampoo" and k == "adam_step")}
    if name in ("Rng", "fixed_point_pos"):  # the table gradient's own instantiation
        counters[EXTRA_ROUTES[name][0]] = ("grid_encode", "BWD_ROUTE_LAUNCHES", EXTRA_ROUTES[name])
    _zero_counts(counters)
    losses = t.training_steps(batch, EXTRA_FIT_STEPS, data)
    launches = _read_counts(counters)
    losses = losses.float().cpu().numpy()
    check(np.isfinite(losses).all() and bool(torch.isfinite(m.params).all()), f"extras {name}: non-finite loss")
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    check(last < 0.5 * first, f"extras {name}: loss did not fall ({first:.4e} -> {last:.4e})")
    for k, v in launches.items():
        check(v > 0, f"extras {name}: kernel {k} was not launched by training_steps")
    ms, runs = _timed(lambda: t.training_steps(batch, EXTRA_FIT_STEPS, data), EXTRA_FIT_STEPS)
    log(f"extras [{name}]: training_steps({EXTRA_FIT_STEPS}) at B=2^18 on stratified batches of the synthetic image: "
        f"loss {first:.4e} (mean of steps 0-9) -> {last:.4e} (steps {EXTRA_FIT_STEPS - 10}-{EXTRA_FIT_STEPS - 1}); "
        f"kernel launches of warm-up, capture and {EXTRA_FIT_STEPS} replays (counts at 0 just before, read just "
        f"after): {launches}")
    log(f"time [{card}]: extras [{name}] training_steps replayed, B=2^18: {ms:.4f} ms/step (host clock over "
        f"{EXTRA_FIT_STEPS} steps synced at their ends, median of {len(runs)}: {', '.join(f'{r:.4f}' for r in runs)})")
    return {"launches": launches, "loss": (first, last), "ms": ms, "model": m, "data": data, "batch": batch}


def _stochastic_apply_path(cfg, card, image, gen):
    """Stochastic interpolation's one-corner table gradient on the module
    API: NetworkWithInputEncoding.apply(params, x, rng=generator), a
    RelativeL2 loss and torch.optim.Adam, eagerly. One gradient kernel vs
    plain with the same uniforms, then EXTRA_FIT_STEPS steps with the counts
    at 0 just before and read just after."""
    import torch

    import tcnn_tpu_torch as tt

    model = tt.create_from_config(2, 3, cfg, seed=SEED, device="cuda").model
    data = _image_batches(image, gen, EXTRA_FIT_STEPS, B_FLAG)
    rng = torch.Generator(device="cuda").manual_seed(SEED + 42)

    def loss_of(out, y):
        pred = out[:, :3].float()
        return torch.mean((pred - y) ** 2 / (pred.detach() ** 2 + 0.01))

    x0, y0 = _nth_batch(data, torch.zeros((), dtype=torch.int64, device="cuda"))
    u = model.encoding._uniforms(rng, B_FLAG, x0.device)
    grads = {}
    for plain in (False, True):
        apply = model.apply_plain if plain else model.apply
        (grads[plain],) = torch.autograd.grad(loss_of(apply(model.params, x0, rng=u), y0), model.params)
    torch.cuda.synchronize()
    n_net = model.network.n_params
    rel = {}
    for part, sl in (("network", slice(0, n_net)), ("grid", slice(n_net, None))):
        a, b = grads[False][sl], grads[True][sl]
        rel[part] = float((a - b).norm()) / max(float(b.norm()), 1e-30)
        check(rel[part] <= 1e-2, f"extras stochastic apply: {part} gradient relative difference {rel[part]:.3e}")
    opt = torch.optim.Adam([model.params], lr=1e-2, betas=(0.9, 0.99), eps=1e-15)
    counters = {k: v for k, v in TRAIN_COUNTERS.items() if k != "adam_step"}
    counters["grid_bwd_modes"] = ("grid_encode", "BWD_ROUTE_LAUNCHES", EXTRA_ROUTES["stochastic_interpolation"])
    _zero_counts(counters)
    losses = []
    for i in range(EXTRA_FIT_STEPS):
        x, y = _nth_batch(data, torch.tensor(i, device="cuda"))
        loss = loss_of(model.apply(model.params, x, rng=rng), y)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    launches = _read_counts(counters)
    losses = torch.stack(losses).cpu().numpy()
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    check(np.isfinite(losses).all() and last < 0.5 * first, f"extras stochastic apply: loss {first:.4e} -> {last:.4e}")
    for k, v in launches.items():
        check(v > 0, f"extras stochastic apply: kernel {k} was not launched")
    log(f"extras [stochastic_interpolation, apply(rng=generator)]: the gradient kernel vs plain with the same "
        f"uniforms: relative difference (norm) network {rel['network']:.3e}, grid {rel['grid']:.3e} (bound 1e-2: bf16 "
        f"network); {EXTRA_FIT_STEPS} eager steps of NetworkWithInputEncoding.apply(rng=generator) + torch.optim.Adam "
        f"at B=2^18: loss {first:.4e} -> {last:.4e}; kernel launches (counts at 0 just before, read just after): "
        f"{launches}")
    return {"launches": launches, "loss": (first, last)}


def phase_extras(card, flagship, image):
    """The extras' kernels against their plain versions and timed, then
    each extra's path at full width."""
    import torch

    kernels = _extra_kernels(card, flagship)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 43)
    paths = {name: _extra_path(name, _extra_config(flagship, name), card, image, gen) for name in EXTRA_PATHS}
    paths["stochastic apply"] = _stochastic_apply_path(_extra_config(flagship, "stochastic_interpolation"), card,
                                                       image, gen)
    # Shampoo's cost a flagship step: the same replayed steps with Adam.
    base = _extra_path("Adam", _extra_config(flagship, "Adam"), card, image, gen)
    sh = paths["Shampoo"]
    t_sh = sh["model"].trainer
    x, y = sh["batch"](sh["data"], torch.zeros((), dtype=torch.int32, device="cuda"))
    eager = _timed(lambda: t_sh.training_step(x, y), 1, reps=7)[0]
    log(f"time [{card}]: extras Shampoo's cost: the flagship step through training_steps {sh['ms']:.4f} ms/step with "
        f"Shampoo against {base['ms']:.4f} with Adam (same batches; the Newton iteration's 30 steps on every "
        f"matrix, every step, so that the schedule stays on the device); eagerly one training_step {eager:.4f} ms "
        f"(host clock, synced, median of 7)")
    for p in paths.values():
        p.pop("model", None), p.pop("data", None)
    return {"kernels": kernels, "paths": paths, "shampoo_ms": (sh["ms"], base["ms"], eager)}


# The counts of the kernels that the sample paths (the SDF, realtime-render
# and ray-marcher samples, the host sampler's training) launch; each such
# phase sets them to 0 just before its path and reads them just after.
SAMPLE_COUNTERS = {**TRAIN_COUNTERS, "grid_bwd_input": ("grid_encode", "INPUT_LAUNCHES"),
                   "grid_bwdbwd": ("grid_encode", "BWDBWD_LAUNCHES")}


def _grads_close(got, want, n_net, what, rtol=1e-2):
    """The network part ``[:n_net]`` and the table part of two gradients,
    each within ``rtol`` of ``want`` in norm."""
    for part, sl in (("network", slice(0, n_net)), ("table", slice(n_net, None))):
        a, b = got[sl].float(), want[sl].float()
        check(bool(a.isfinite().all()), f"{what}: non-finite {part} gradient")
        rel = float((a - b).norm()) / max(float(b.norm()), 1e-30)
        check(rel <= rtol, f"{what}: {part} gradient relative difference {rel:.3e} > {rtol}")
        log(f"{what}: {part} gradient kernel vs plain, relative difference (norm) {rel:.3e} (bound {rtol}: the bf16 "
            f"network's roundings flip where its fp32 inputs differ in the last bits)")


def phase_sdf_sample(card):
    """samples.sdf_learning at its own CONFIG (8 levels of 2^15, Smoothstep,
    CutlassMLP, the trainer's Adam at loss scale 1): one step kernel vs
    plain from one state, then fit() at its defaults (200 steps of 8192),
    held to the JAX sample test's criteria, then its ms/step and profile."""
    import torch

    import tcnn_tpu_torch as tt
    from tcnn_tpu_torch.samples import sdf_learning as ss
    from tcnn_tpu_torch.utils.profiling import profile_steps, sync

    m = tt.create_from_config(3, 1, ss.CONFIG, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
    x, d = ss.draw(8192, gen)
    params = m.model.params
    terms = {}
    for plain in (False, True):
        loss, (data, eik) = ss.total_loss(m.model, params, x, d, plain=plain)
        (g,) = torch.autograd.grad(loss, params)
        terms[plain] = ([float(v.detach()) for v in (loss, data, eik)], g)
    for name, a, b in zip(("loss", "data", "eik"), terms[False][0], terms[True][0]):
        rel = abs(a - b) / abs(b)
        check(np.isfinite(a) and rel <= 1e-3, f"sdf sample: {name} kernel {a} vs plain {b}")
    log(f"sdf sample: total_loss at B=8192, kernel vs plain: loss, data, eik {terms[False][0]} vs {terms[True][0]} "
        f"(bound 1e-3 relative)")
    _grads_close(terms[False][1], terms[True][1], m.model.network.n_params, "sdf sample")
    _compare_one_step("sdf sample", m, float(m.trainer.learning_rate),
                      lambda plain: ss.train_step(m, x, d, plain=plain)[0])

    _zero_counts(SAMPLE_COUNTERS)
    t0 = time.perf_counter()
    data_v, eik_v, history = ss.fit()
    wall = time.perf_counter() - t0
    launches = _read_counts(SAMPLE_COUNTERS)
    check(np.isfinite([data_v, eik_v, *history]).all(), "sdf sample: a value is not finite")
    check(history[-1] < 0.2 * history[0], f"sdf sample: loss did not fall below a fifth: {history}")
    check(data_v < 5e-3 and eik_v < 0.5, f"sdf sample: validation sdf-l2 {data_v:.3e} (< 5e-3), eikonal {eik_v:.3e} "
          f"(< 0.5)")
    for k in ("grid_fwd", "grid_bwd", "grid_bwd_input", "grid_bwdbwd", "adam_step"):
        check(launches[k] > 0, f"sdf sample: kernel {k} was not launched")
    log(f"sdf sample [{card}]: fit() 200 steps of 8192: logged losses {', '.join(f'{v:.4e}' for v in history)}; "
        f"validation sdf-l2 {data_v:.4e} (< 5e-3), eikonal residual {eik_v:.4e} (< 0.5); {wall:.2f} s in all; kernel "
        f"launches (counts at 0 just before, read just after): {launches}")

    m = tt.create_from_config(3, 1, ss.CONFIG, device="cuda")
    step = lambda: ss.train_step(m, *ss.draw(8192, gen))  # noqa: E731
    for _ in range(5):
        step()
    sync(m.params)
    n = 50
    t0 = time.perf_counter()
    for _ in range(n):
        out = step()
    sync(out[0])
    ms = (time.perf_counter() - t0) * 1e3 / n
    wall_p, busy, idle, kernels = profile_steps(step)
    log(f"time [{card}]: sdf sample step (8192 points, d = 3 Smoothstep lookup, G1, G2, table gradient, CutlassMLP, "
        f"Adam kernel): {ms:.4f} ms/step (host clock, {n} steps synced at the ends); under torch.profiler "
        f"{wall_p:.4f} ms/step, device busy {busy:.4f} ms, idle share {idle:.3f}; largest (ms/step): "
        + "; ".join(f"{k[:60]} {v:.4f}" for k, v in kernels[:8]))
    return {"launches": launches, "ms": ms, "busy": busy, "idle": idle, "sdf_l2": data_v, "eik": eik_v}


def phase_realtime_render(card):
    """samples.realtime_render at --steps 300 --side 512 --frames 120: the
    training steps through training_steps, then the static and moving
    views through a FrozenServer; one frame of each against the plain path
    with the same frozen params, and each kernel's launches a frame."""
    import torch

    from tcnn_tpu_torch.ops import ffmlp, grid_encode
    from tcnn_tpu_torch.samples import realtime_render as rr
    from tcnn_tpu_torch.utils.sampling import raster_centers_torch

    _zero_counts(SAMPLE_COUNTERS)
    t0 = time.perf_counter()
    res = rr.main(["--steps", "300", "--side", "512", "--frames", "120"])
    wall = time.perf_counter() - t0
    launches = _read_counts(SAMPLE_COUNTERS)
    check(np.isfinite([res["loss"], res["static_fps"], res["moving_fps"]]).all(), "realtime render: not finite")
    for k in TRAIN_COUNTERS:
        check(launches[k] > 0, f"realtime render: kernel {k} was not launched")
    server = res["server"]
    base = rr.base_grid(512, "cuda")
    per_frame = {}
    for what, frame, x in (("static", lambda: server.raster((512, 512)), raster_centers_torch((512, 512), 2, "cuda")),
                           ("moving", lambda: server(rr.view(base, 37, 120)), rr.view(base, 37, 120))):
        ffmlp.LAUNCHES = grid_encode.LAUNCHES = 0
        y = frame()
        per_frame[what] = {"grid_fwd": grid_encode.LAUNCHES, "ffmlp_fwd": ffmlp.LAUNCHES}
        with torch.no_grad():
            want = server.model.apply_plain(server._params, x)[:, :3].float()
        err = bf16_close(y, want, f"realtime render {what} frame")
        log(f"realtime render: one {what} 512^2 frame against the plain path with the same frozen params: max|diff| "
            f"{err:.3e} ({TOL_NOTE})")
    log(f"realtime render [{card}]: trained 300 steps (loss {res['loss']:.4e}); static view {res['static_fps']:.1f} "
        f"FPS, moving view {res['moving_fps']:.1f} FPS (120 frames of 512^2 each, synced at the ends); launches a "
        f"frame: {per_frame}; {wall:.2f} s in all; kernel launches of the run (counts at 0 just before, read just "
        f"after): {launches}")
    return {"launches": launches, "static_fps": res["static_fps"], "moving_fps": res["moving_fps"],
            "per_frame": per_frame}


def _march_close(got, want, raw_max, what):
    """A march against the plain march: colour within 2.25 and transmittance
    within 1 times 4 bf16 ulps of the largest raw output (the MLP's bf16
    outputs agree to 4 ulps; sigmoid' <= 1/4, softplus' and exp' <= 1, and
    the steps' alpha * dt sum to 1)."""
    ulp4 = 4 * 2.0 ** (np.floor(np.log2(raw_max)) - 7)
    ec = float((got[0] - want[0]).abs().max())
    et = float((got[1] - want[1]).abs().max())
    check(bool(got[0].isfinite().all()) and bool(got[1].isfinite().all()), f"{what}: non-finite render")
    check(ec <= 2.25 * ulp4 and et <= ulp4, f"{what}: colour max|diff| {ec:.3e} (bound {2.25 * ulp4:.3e}), "
          f"transmittance {et:.3e} (bound {ulp4:.3e})")
    return ec, et, ulp4


def phase_ray_marcher(card):
    """samples.fused_ray_marcher: the Marcher (one CUDA graph of all 64
    steps) against the eager march through the kernels (bit for bit) and
    through the plain versions (bf16 bound), at the sample's params and at
    random tables; replays repeat bit for bit; the launches at capture and
    a replay; ms a render, graph beside eager; then the sample's main."""
    import torch

    from tcnn_tpu_torch.ops import ffmlp, grid_encode
    from tcnn_tpu_torch.samples import fused_ray_marcher as fm

    dev = torch.device("cuda")
    model, params = fm.make_model(dev)
    origins, dirs = fm.make_rays(fm.N_RAYS, dev)
    rng = np.random.default_rng(SEED + 41)
    n_net = model.network.n_params
    shaped = torch.from_numpy(np.concatenate([rng.uniform(-0.3, 0.3, n_net),
                                              rng.uniform(-2, 2, model.n_params - n_net)]).astype(np.float32)).to(dev)
    tilted = dirs + torch.from_numpy(rng.uniform(-0.3, 0.3, (fm.N_RAYS, 3)).astype(np.float32)).to(dev)
    out = {}
    for name, p, d in (("sample params", params, dirs), ("random tables, tilted rays", shaped, tilted)):
        _zero_counts(SAMPLE_COUNTERS)
        marcher = fm.Marcher(model, p, fm.N_RAYS, fm.N_STEPS)
        torch.cuda.synchronize()
        at_capture = _read_counts(SAMPLE_COUNTERS)
        _zero_counts(SAMPLE_COUNTERS)
        a = marcher(origins, d)
        b = marcher(origins, d)
        torch.cuda.synchronize()
        per_replay = _read_counts(SAMPLE_COUNTERS)
        check(at_capture["grid_fwd"] == at_capture["ffmlp_fwd"] == 2 * fm.N_STEPS,
              f"ray marcher: launches at capture {at_capture}")
        check(per_replay["grid_fwd"] == per_replay["ffmlp_fwd"] == 0, f"ray marcher: launches in replays {per_replay}")
        check(all(torch.equal(u, v) for u, v in zip(a, b)), "ray marcher: two replays differ")
        eager = fm.render_plain(model, p, origins, d)
        check(all(torch.equal(u, v) for u, v in zip(a, eager)), "ray marcher: graph differs from the eager march")
        plain = fm.render_plain(model, p, origins, d, plain=True)
        with torch.no_grad():
            raw_max = max(float(model.apply_plain(p, origins + d * ((i + 0.5) / fm.N_STEPS)).float().abs().max())
                          for i in range(fm.N_STEPS))
        ec, et, ulp4 = _march_close(a, plain, raw_max, f"ray marcher ({name})")
        ms_graph = _event_ms(lambda: marcher(origins, d), iters=10, reps=5)
        ms_eager = _event_ms(lambda: fm.render_plain(model, p, origins, d), iters=10, reps=5)
        out[name] = {"at_capture": at_capture, "ms_graph": ms_graph, "ms_eager": ms_eager}
        log(f"ray marcher [{card}] ({name}): {fm.N_RAYS} rays x {fm.N_STEPS} steps; graph replay vs eager march "
            f"through the kernels: bitwise equal; two replays bitwise equal; vs the plain march: colour max|diff| "
            f"{ec:.3e}, transmittance {et:.3e} (bounds {2.25 * ulp4:.3e} / {ulp4:.3e}: 2.25 and 1 times 4 bf16 ulps "
            f"of max|raw| {raw_max:.4f}); mean colour {a[0].mean(0).tolist()}, mean transmittance "
            f"{float(a[1].mean()):.4f}; launches at construction (warm-up + capture) {at_capture['grid_fwd']} "
            f"lookups, {at_capture['ffmlp_fwd']} K1, in two replays {per_replay['grid_fwd']} / "
            f"{per_replay['ffmlp_fwd']}; ms a render (CUDA events, median of 5 x 10): graph {ms_graph:.4f}, eager "
            f"{ms_eager:.4f} ({ms_eager / ms_graph:.2f}x), graph {fm.N_RAYS / ms_graph * 1e3:.4e} rays/s")
    res = fm.main([])
    check(_all_finite(res), "ray marcher: the sample's main printed a value that is not finite")
    launches = out["sample params"]["at_capture"]
    return {"launches": launches, "times": out}


def _check_in_tiles(xy):
    """Fails unless sample ``j`` of a stratified (strata^2, 2) batch lies
    strictly inside raster tile ``j`` (dim 0 fastest): floor(x * strata) ==
    tile in exact arithmetic (an fp32 value times an int is exact in
    float64)."""
    strata = int(round(np.sqrt(xy.shape[0])))
    ids = np.arange(xy.shape[0])
    for d, tile in ((0, ids % strata), (1, ids // strata)):
        outside = int(np.sum(np.floor(xy[:, d].astype(np.float64) * strata) != tile))
        check(outside == 0, f"host sampler: {outside} samples outside their tile in dim {d}")


def phase_host_sampler(card, flagship):
    """utils.data.HostImageSampler: native on this machine, its contract on
    the 512^2 image at 2^18 stratified samples, its batches a second, and
    100 FLAGSHIP_CONFIG training_step calls fed from it beside the same
    steps fed from batches drawn on the card."""
    import torch

    import tcnn_tpu_torch as tt
    from tcnn_tpu_torch.runtime import native
    from tcnn_tpu_torch.utils.data import HostImageSampler
    from tcnn_tpu_torch.utils.profiling import sync
    from tcnn_tpu_torch.utils.sampling import stratified_uniform

    image = _load_synthetic_image()
    h, w, _ = image.shape
    with HostImageSampler(image, B_FLAG, stratified=True, seed=SEED) as s:
        is_native = s.native
        check(is_native, f"host sampler: the native helper did not build or load ({native.build_error})")
        xy, rgb = s.next()
        px = np.minimum((xy[:, 0] * w).astype(np.int64), w - 1)
        py = np.minimum((xy[:, 1] * h).astype(np.int64), h - 1)
        check(np.array_equal(rgb, image[py, px]), "host sampler: rgb is not the pixel at xy")
        _check_in_tiles(xy)
        check(0 <= xy.min() and xy.max() < 1, "host sampler: positions outside [0, 1)")
        n = 50
        t0 = time.perf_counter()
        for _ in range(n):
            s.next()
        batches_per_s = n / (time.perf_counter() - t0)

        n_steps = 100
        _zero_counts(SAMPLE_COUNTERS)
        m = tt.create_from_config(2, 3, flagship, seed=SEED, device="cuda")
        first = float(m.training_step(*s.next()))
        t0 = time.perf_counter()
        for _ in range(n_steps):
            loss = m.training_step(*s.next())
        last = sync(loss)
        ms_host = (time.perf_counter() - t0) * 1e3 / n_steps
        launches = _read_counts(SAMPLE_COUNTERS)
    check(np.isfinite([first, last]).all() and last < first, f"host sampler: loss {first} -> {last}")
    for k in TRAIN_COUNTERS:
        check(launches[k] > 0, f"host sampler: kernel {k} was not launched")
    m = tt.create_from_config(2, 3, flagship, seed=SEED, device="cuda")
    img = torch.from_numpy(image).cuda().reshape(h * w, 3)
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def card_step():
        x = stratified_uniform(B_FLAG, 2, gen)
        ij = torch.clamp((x[:, 1] * h).long(), 0, h - 1) * w + torch.clamp((x[:, 0] * w).long(), 0, w - 1)
        return m.training_step(x, img[ij])

    sync(card_step())
    t0 = time.perf_counter()
    for _ in range(n_steps):
        loss = card_step()
    sync(loss)
    ms_card = (time.perf_counter() - t0) * 1e3 / n_steps
    log(f"host sampler [{card}]: native {is_native}; 512^2 image, 2^18 stratified samples a batch: rgb is the pixel "
        f"at xy; every sample strictly inside its own tile; {batches_per_s:.2f} batches/s from the sampler alone ({n} next() calls); "
        f"FLAGSHIP_CONFIG training_step fed from the sampler {ms_host:.4f} ms/step (loss {first:.4e} -> {last:.4e}) "
        f"beside {ms_card:.4f} ms/step fed from batches drawn on the card ({n_steps} steps each, synced at the "
        f"ends); kernel launches fed from the sampler (counts at 0 just before, read just after): {launches}")
    return {"launches": launches, "batches_per_s": batches_per_s, "ms_host": ms_host, "ms_card": ms_card}


# The multi-GPU layer (tcnn_tpu_torch.parallel), on the one card: ranks are
# processes spawned by parallel.launch.run_ranks that all use cuda:0 through
# the gloo backend (NCCL takes one card a rank; it runs at world size 1).
# Each rank loads the libraries the build phase made and asserts that it
# imports neither jax nor tcnn_tpu.
PAR_DP_STEPS = 20
PAR_NCCL_STEPS = 5
PAR_TP_STEPS = 5
PAR_TP4_STEPS = 3
B_TP4 = 2**16
# The JAX package's flagship DP lockstep (tests/test_parallel.py): loss 5e-2
# relative; params rtol 2e-2, atol 2e-4. On the card the table gradient's
# fp32 atomics make two runs of one trainer differ, a rank rounds its own
# MLP weight gradient to bf16 before the sum (DP), a rank's partial
# features sum in another order before their bf16 rounding (TP), and Adam
# moves a param whose gradient is near zero by up to 2 lr a step where its
# sign flips; so the params are held within 2 lr a step and 1e-2 relative
# in norm (_graph_vs_loop's bound for two runs of one trainer, per step),
# and the count outside the JAX tolerance is printed beside the same count
# between two runs of the single trainer.
PAR_LOSS_RTOL, PAR_PARAM_RTOL, PAR_PARAM_ATOL = 5e-2, 2e-2, 2e-4
# The first TP step's loss: the JAX TP test's rtol (tests/test_table_parallel.py).
PAR_TP_FIRST_RTOL = 5e-5
# The --protocol 3d model for table parallelism. Its single-trainer
# reference takes the sharded lookup's function: every affine level folds
# its corners (per_level) and every table gradient sums in fp32 ("xla"),
# the class of the JAX package's autodiff of its sharded lookup, where the
# 3D model's own "auto" classes add 13 levels in bf16.
TP3D_ENCODING = {**ENC3D, "gather_strategy": "per_level", "scatter_strategy": "xla"}
PAR_COUNTERS = {**TRAIN_COUNTERS,
                "grid_fwd_windowed": ("grid_encode", "WINDOWED_LAUNCHES"),
                "grid_bwd_windowed": ("grid_encode", "BWD_ROUTE_LAUNCHES", ("grid_sharded", "tcnn_grid_backward_windowed"))}
WINDOWED_TOL_NOTE = ("forward: max|kernel - plain| <= 1e-5 max|plain| (the same fp32 products, each corner in the "
                     "same order); table gradient: max|kernel - plain| <= 1e-5 max|plain| (fp32 atomics add in any "
                     "order); the sum over the shards against the unsharded per_level lookup and table gradient, "
                     "the same bound")


def _par_config(flagship, dims):
    import copy

    if dims == 2:
        return copy.deepcopy(flagship)
    return {"loss": dict(flagship["loss"]), "optimizer": dict(flagship["optimizer"]),
            "encoding": dict(TP3D_ENCODING), "network": dict(NET3D)}


def _par_batch(i, batch, dims, image=None):
    """Batch ``i`` of the parallel phase, the same in every process: drawn on
    the card from seed SEED + 100 + i; 2D: stratified positions and the
    synthetic image's pixels there; 3D: uniform positions and analytic
    targets."""
    import torch

    from tcnn_tpu_torch.utils.sampling import stratified_uniform

    gen = torch.Generator(device="cuda").manual_seed(SEED + 100 + i)
    if dims == 2:
        h, w, _ = image.shape
        x = stratified_uniform(batch, 2, gen)
        ij = torch.clamp((x[:, 1] * h).long(), 0, h - 1) * w + torch.clamp((x[:, 0] * w).long(), 0, w - 1)
        return x, image.reshape(h * w, 3)[ij]
    x = torch.rand((batch, 3), generator=gen, device="cuda")
    t = torch.stack([torch.sin(7 * x[:, 0]) * torch.cos(5 * x[:, 1]), torch.cos(6 * x[:, 2]),
                     x[:, 0] * x[:, 1] + x[:, 2]], dim=1)
    return x, 0.5 + 0.5 * t


def _par_assert_port_only(what):
    check("jax" not in sys.modules and "tcnn_tpu" not in sys.modules, f"{what}: a rank imported jax or tcnn_tpu")


PAR_TIMED_STEPS = 10


def _par_train(step, n_steps, batch, dims, image):
    """``n_steps`` of ``step(x, t)`` on the phase's batches: (losses, the
    all_reduce count of each step)."""
    from tcnn_tpu_torch.parallel import collectives

    losses, reduces = [], []
    for i in range(n_steps):
        x, t = _par_batch(i, batch, dims, image)
        before = collectives.ALL_REDUCES
        losses.append(step(x, t))
        reduces.append(collectives.ALL_REDUCES - before)
    return [float(v) for v in losses], reduces


def _par_ms(step, batch, dims, image, n_steps=PAR_TIMED_STEPS):
    """ms a step of ``step(x, t)`` over ``n_steps`` more steps on the
    phase's batches (drawn on the card before the timed loop), after the
    compared ones, synced at the ends."""
    import torch

    batches = [_par_batch(i, batch, dims, image) for i in range(n_steps)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for x, t in batches:
        loss = step(x, t)
    float(loss)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n_steps


def _par_single(cfg, n_steps, batch, dims, image):
    """The single-process port trainer on the phase's batches: losses,
    params, ms a step and the card's peak bytes of its state and steps."""
    import torch

    import tcnn_tpu_torch as tt

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    m = tt.create_from_config(dims, 3, cfg, seed=SEED, device="cuda")
    losses, _ = _par_train(m.trainer.training_step, n_steps, batch, dims, image)
    out = {"losses": losses, "params": m.trainer.params.cpu().numpy(),
           "peak_bytes": torch.cuda.max_memory_allocated() - before}
    out["ms"] = _par_ms(m.trainer.training_step, batch, dims, image)
    return out


def _par_dp(cfg, n_steps, image, mesh=None):
    """DataParallelTrainer over ``mesh`` (default: every rank) on the
    phase's 2D batches: losses, params, ms a step, all_reduces a step, the
    kernels' launches (counts at 0 just before, read just after)."""
    import torch

    import tcnn_tpu_torch as tt
    from tcnn_tpu_torch.parallel import DataParallelTrainer, make_mesh

    m = tt.create_from_config(2, 3, cfg, seed=SEED, device="cuda")
    dp = DataParallelTrainer(m.trainer, mesh if mesh is not None else make_mesh())
    _zero_counts(PAR_COUNTERS)
    torch.cuda.reset_peak_memory_stats()
    losses, reduces = _par_train(dp.training_step, n_steps, B_FLAG, 2, image)
    out = {"losses": losses, "params": m.trainer.params.cpu().numpy(), "reduces": reduces,
           "launches": _read_counts(PAR_COUNTERS), "peak_bytes": torch.cuda.max_memory_allocated()}
    out["ms"] = _par_ms(dp.training_step, B_FLAG, 2, image)
    return out


def _par_tp(cfg, shape, n_steps, batch):
    """TableParallelTrainer over a (data, model) mesh of ``shape`` on the
    phase's 3D batches, its wrapped trainer on the host so that the card
    holds only the sharded state: losses, params (first rank), ms a step,
    the card's peak bytes, the kernels' launches."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import tcnn_tpu_torch as tt
    from tcnn_tpu_torch.parallel import TableParallelTrainer

    mesh = init_device_mesh("cuda", shape, mesh_dim_names=("data", "model"))
    host = tt.create_from_config(3, 3, cfg, seed=SEED, device="cpu")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    tp = TableParallelTrainer(host.trainer, mesh)
    check(np.array_equal(tp.params, host.trainer.params.numpy()), "TP: the sharded params do not reassemble")
    _zero_counts(PAR_COUNTERS)
    losses, reduces = _par_train(tp.training_step, n_steps, batch, 3, None)
    launches = _read_counts(PAR_COUNTERS)
    peak = torch.cuda.max_memory_allocated() - before
    params = tp.params
    tp.sync_to_trainer()
    check(np.array_equal(host.trainer.params.numpy(), params), "TP: sync_to_trainer did not write the params")
    return {"losses": losses, "params": params if dist.get_rank() == 0 else None,
            "ms": _par_ms(tp.training_step, batch, 3, None, 5), "reduces": reduces, "launches": launches,
            "peak_bytes": peak, "local_n_params": tp.tpg.local_n_params}


def _par_serve(flagship):
    """FLAGSHIP_CONFIG's FrozenServer over every rank: a 2^18 batch and the
    1024^2 raster, the whole output on every rank."""
    import torch

    import tcnn_tpu_torch as tt
    from tcnn_tpu_torch.parallel import make_mesh

    m = tt.create_from_config(2, 3, flagship, seed=SEED, device="cuda")
    m.trainer.params = torch.from_numpy(flagship_params(m.model, np.random.default_rng(SEED + 7)))
    server = m.trainer.freeze_serving(mesh=make_mesh())
    x = torch.rand((B_FLAG, 2), generator=torch.Generator(device="cuda").manual_seed(SEED + 8), device="cuda")
    _zero_counts(PAR_COUNTERS)
    y, r = server(x), server.raster(1024)
    return {"batch": y.cpu().numpy(), "raster": r.cpu().numpy(), "launches": _read_counts(PAR_COUNTERS)}


def _par_rank_nccl(rank, world, flagship):
    """(a): DataParallelTrainer over a one-rank NCCL mesh beside the plain
    Trainer in the same process, step by step on the same batches."""
    import torch

    import tcnn_tpu_torch as tt
    from tcnn_tpu_torch.parallel import DataParallelTrainer, make_mesh

    _par_assert_port_only("parallel (a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    image = torch.from_numpy(_load_synthetic_image()).cuda()
    single = tt.create_from_config(2, 3, flagship, seed=SEED, device="cuda")
    m = tt.create_from_config(2, 3, flagship, seed=SEED, device="cuda")
    dp = DataParallelTrainer(m.trainer, make_mesh())
    out = {"backend": torch.distributed.get_backend(), "single": [], "dp": []}
    for i in range(PAR_NCCL_STEPS):
        x, t = _par_batch(i, B_FLAG, 2, image)
        out["single"].append(float(single.trainer.training_step(x, t)))
        out["dp"].append(float(dp.training_step(x, t)))
    out["single_params"] = single.trainer.params.cpu().numpy()
    out["dp_params"] = m.trainer.params.cpu().numpy()
    again = tt.create_from_config(2, 3, flagship, seed=SEED, device="cuda")
    out["again"] = [float(again.trainer.training_step(*_par_batch(i, B_FLAG, 2, image))) for i in range(PAR_NCCL_STEPS)]
    out["again_params"] = again.trainer.params.cpu().numpy()
    out["ms"] = {"dp": _par_ms(dp.training_step, B_FLAG, 2, image),
                 "single": _par_ms(single.trainer.training_step, B_FLAG, 2, image)}
    _par_assert_port_only("parallel (a)")
    return out


def _par_rank_gloo2(rank, world, flagship):
    """(b) data parallelism, (c) table parallelism on a (1, 2) mesh and (d)
    sharded serving, two gloo ranks on cuda:0."""
    import torch
    import torch.distributed as dist

    _par_assert_port_only("parallel (b-d)")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"collectives": _gloo_collectives()}
    image = torch.from_numpy(_load_synthetic_image()).cuda()
    out["dp"] = _par_dp(_par_config(flagship, 2), PAR_DP_STEPS, image)
    dist.barrier()
    out["tp"] = _par_tp(_par_config(flagship, 3), (1, 2), PAR_TP_STEPS, B_FLAG)
    dist.barrier()
    out["serve"] = _par_serve(flagship)
    _par_assert_port_only("parallel (b-d)")
    return out


def _gloo_collectives():
    """Which collectives gloo takes on CUDA tensors here: each tried once."""
    import torch
    import torch.distributed as dist

    world = dist.get_world_size()
    t = torch.ones(4, device="cuda")
    took = {}
    for name, fn in (
        ("all_reduce", lambda: dist.all_reduce(t)),
        ("broadcast", lambda: dist.broadcast(t, src=0)),
        ("all_gather", lambda: dist.all_gather([torch.empty_like(t) for _ in range(world)], t)),
        ("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(torch.empty(4 * world, device="cuda"), t)),
    ):
        try:
            fn()
            torch.cuda.synchronize()
            took[name] = True
        except (RuntimeError, ValueError) as e:
            took[name] = str(e).splitlines()[0][:120]
    return took


def _par_rank_gloo4(rank, world, flagship):
    """(c) table parallelism on a (2, 2) mesh, four gloo ranks on cuda:0."""
    import torch

    _par_assert_port_only("parallel (c, 4 ranks)")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = _par_tp(_par_config(flagship, 3), (2, 2), PAR_TP4_STEPS, B_TP4)
    _par_assert_port_only("parallel (c, 4 ranks)")
    return out


def _par_lockstep(what, got, want, again, lr, first_rtol=None):
    """Losses within PAR_LOSS_RTOL (the first within ``first_rtol`` where
    given); params max|diff| <= 2 lr a step and within 1e-2 relative in norm
    (see PAR_LOSS_RTOL). Returns the worst loss ratio, the params' max |diff|
    and the count of params outside the JAX lockstep's (rtol, atol) beside
    that count between ``want`` and ``again``, a second run of the single
    trainer."""
    rel = [abs(g - w) / max(abs(w), 1e-30) for g, w in zip(got["losses"], want["losses"])]
    check(all(np.isfinite(got["losses"])), f"{what}: non-finite loss {got['losses']}")
    if first_rtol is not None:
        check(rel[0] <= first_rtol, f"{what}: first loss {got['losses'][0]!r} vs {want['losses'][0]!r} "
              f"(relative {rel[0]:.3e} > {first_rtol})")
    check(max(rel) <= PAR_LOSS_RTOL, f"{what}: losses {got['losses']} vs {want['losses']} (worst {max(rel):.3e})")
    p, q = got["params"], want["params"]

    def outside(a):
        return int(np.sum(np.abs(a - q) > PAR_PARAM_ATOL + PAR_PARAM_RTOL * np.abs(q)))

    err = float(np.abs(p - q).max())
    rel_n = float(np.linalg.norm(p - q)) / max(float(np.linalg.norm(q)), 1e-30)
    bound_ = 2 * lr * len(got["losses"]) * 1.0001
    check(np.isfinite(p).all() and err <= bound_ and rel_n <= 1e-2,
          f"{what}: params max|diff| {err:.3e} (bound {bound_:.2e}), relative difference {rel_n:.3e} (norm)")
    return {"loss_rel": max(rel), "max_diff": err, "outside": outside(p), "outside_again": outside(again["params"]),
            "n": p.size}


def _lockstep_note(r):
    return (f"worst loss ratio {r['loss_rel']:.3e}, params max|diff| {r['max_diff']:.3e}; {r['outside']} of "
            f"{r['n']} params outside rtol {PAR_PARAM_RTOL} atol {PAR_PARAM_ATOL}, beside {r['outside_again']} "
            f"between two runs of the single trainer")


def _windowed_check(cfg, dims, batch, n_shards, rng):
    """The windowed lookup and table gradient against their plain versions
    on the card, shard by shard, at ``batch`` uniform points plus
    cell-boundary points; the sum over the shards against the unsharded
    per_level lookup and table gradient. Each launch must move its count.
    Returns the worst max |diff| of the forward and the table gradient."""
    import torch

    from tcnn_tpu_torch.encodings import create_encoding
    from tcnn_tpu_torch.encodings.grid import _INTERP_CODES
    from tcnn_tpu_torch.ops import grid_encode as ge
    from tcnn_tpu_torch.ops.scatter_rows import ACC_F32, CONTRIB_NONE
    from tcnn_tpu_torch.parallel.table_parallel import TableParallelGrid

    enc = create_encoding(dims, {**cfg, "gather_strategy": "per_level"}, alignment=16)
    F, L = enc.n_features_per_level, enc.n_levels
    interp = _INTERP_CODES[enc.interpolation_type]
    x_np = rng.uniform(0, 1, (batch, dims)).astype(np.float32)
    x_np = np.concatenate([x_np, _boundary_points(enc.scales, rng, 256, dims=dims).astype(np.float32)])
    x = torch.from_numpy(x_np).cuda()
    params = rng.uniform(-1, 1, enc.n_params).astype(np.float32)
    dy = torch.from_numpy(rng.normal(0, 1, (len(x_np), L * F)).astype(np.float32)).cuda()
    full_levels = ge.level_table_on(enc.level_table(), x.device)
    classes = torch.tensor([[CONTRIB_NONE, ACC_F32]] * L, dtype=torch.int32, device="cuda")
    want_y = ge.grid_encode_plain(x, torch.from_numpy(params).cuda(), full_levels, F, L * F, interp, torch.float32)
    want_g = ge.grid_backward_plain(x, dy, full_levels, F, interp, classes)
    err_f = err_b = 0.0
    sum_y, grads = torch.zeros_like(want_y), []
    for shard in range(n_shards):
        tpg = _shard_grid(enc, n_shards, shard)
        local = torch.from_numpy(tpg.local_params(params)).cuda()
        levels, windows = tpg._tables_on(x.device)
        n0, r0 = ge.WINDOWED_LAUNCHES, ge.BWD_ROUTE_LAUNCHES.get(ge.WINDOWED_BWD_ROUTE, 0)
        y = ge.grid_encode_windowed(x, local, levels, windows, F, interp)
        g = ge.grid_backward_windowed(x, dy, levels, windows, F, interp)
        torch.cuda.synchronize()
        check(ge.WINDOWED_LAUNCHES == n0 + 1, "windowed lookup: the launch did not move its count")
        check(ge.BWD_ROUTE_LAUNCHES[ge.WINDOWED_BWD_ROUTE] == r0 + 1,
              "windowed table gradient: the launch did not move its route's count")
        y_plain = ge.grid_encode_plain(x, local, levels, F, L * F, interp, torch.float32, windows)
        g_plain = ge.grid_backward_plain(x, dy, levels, F, interp, classes, window=windows)
        err_f = max(err_f, f32_close(y, y_plain, f"windowed lookup shard {shard}/{n_shards}"))
        check(g.shape == g_plain.shape and bool(g.isfinite().all()), "windowed table gradient: bad output")
        e = float((g - g_plain).abs().max())
        check(e <= 1e-5 * float(g_plain.abs().max()), f"windowed table gradient shard {shard}: max|diff| {e:.3e}")
        err_b = max(err_b, e)
        sum_y += y
        grads.append(g.cpu().numpy())
    f32_close(sum_y, want_y, f"windowed lookup summed over {n_shards} shards vs the unsharded lookup")
    tpg = _shard_grid(enc, n_shards, 0)
    full_g = tpg.unshard_params(np.concatenate(grads))
    e = float(np.abs(full_g - want_g.cpu().numpy()).max())
    check(e <= 1e-5 * float(want_g.abs().max()), f"windowed table gradients unsharded vs the full one: {e:.3e}")
    return err_f, err_b


def _shard_grid(enc, n_shards, shard):
    """A TableParallelGrid of ``enc`` for rank ``shard`` of ``n_shards``,
    without a process group (the kernels' checks and times)."""
    from tcnn_tpu_torch.parallel import TableParallelGrid

    return TableParallelGrid(enc, None, shard=(shard, n_shards))


def _windowed_times(cfg, dims, batch, n_shards):
    """The windowed kernels at the TP path's shape (shard 0 of
    ``n_shards``, ``batch`` uniform points) and their plain versions, in
    turns; each call's bound from its inputs."""
    import torch

    from tcnn_tpu_torch.encodings import create_encoding
    from tcnn_tpu_torch.encodings.grid import _INTERP_CODES
    from tcnn_tpu_torch.ops import grid_encode as ge
    from tcnn_tpu_torch.ops.scatter_rows import ACC_F32, CONTRIB_NONE

    rng = np.random.default_rng(SEED + 31)
    enc = create_encoding(dims, cfg, alignment=16)
    F, L = enc.n_features_per_level, enc.n_levels
    interp = _INTERP_CODES[enc.interpolation_type]
    tpg = _shard_grid(enc, n_shards, 0)
    levels, windows = tpg._tables_on(torch.device("cuda"))
    x = torch.from_numpy(rng.uniform(0, 1, (batch, dims)).astype(np.float32)).cuda()
    local = torch.from_numpy(rng.uniform(-1, 1, tpg.local_n_params).astype(np.float32)).cuda()
    dy = torch.from_numpy(rng.normal(0, 1, (batch, L * F)).astype(np.float32)).cuda()
    classes = torch.tensor([[CONTRIB_NONE, ACC_F32]] * L, dtype=torch.int32, device="cuda")
    plan = tpg._plan(batch)
    calls = {
        "fwd": (lambda: ge.grid_encode_windowed(x, local, levels, windows, F, interp),
                lambda: ge.grid_encode_plain(x, local, levels, F, L * F, interp, torch.float32, windows)),
        "bwd": (lambda: ge.grid_backward_windowed(x, dy, levels, windows, F, interp, plan),
                lambda: ge.grid_backward_plain(x, dy, levels, F, interp, classes, window=windows)),
    }
    out = {}
    for what, (kernel, plain) in calls.items():
        p1, k1, k2, p2 = _event_ms(plain, 2, 3), _event_ms(kernel), _event_ms(kernel), _event_ms(plain, 2, 3)
        out[what] = {"kernel": statistics.median([k1, k2]), "plain": statistics.median([p1, p2]), "library": None}
    C = 2**dims
    table_bytes = tpg.local_n_params * 4
    # The lookup: x read, the rank's rows read, the partial features
    # written; per (sample, level, corner) the weight (d - 1 products) and
    # F multiply-adds. The table gradient: x and dL/dy read, the rank's
    # gradient written; the same weight and F products per corner.
    ops = batch * L * C * ((dims - 1) + 2 * F)
    out["fwd"]["bound"] = bound(x.numel() * 4 + table_bytes + batch * L * F * 4, ops, "fp32")
    out["bwd"]["bound"] = bound(x.numel() * 4 + dy.numel() * 4 + table_bytes, ops, "fp32")
    return out


def phase_parallel(card, flagship):
    """The multi-GPU layer on the one card: the windowed kernels against
    their plain versions, then (a) DP over a one-rank NCCL mesh, (b) DP on
    two gloo ranks, (c) TP on (1, 2) and (2, 2) meshes, (d) sharded
    serving, each held against the single-process port."""
    import torch

    import tcnn_tpu_torch as tt
    from tcnn_tpu_torch.parallel.launch import run_ranks

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 30)
    err_f, err_b = 0.0, 0.0
    for cfg, dims, batch, n in ((flagship["encoding"], 2, B_FLAG, 2), (flagship["encoding"], 2, 4096, 3),
                                (ENC3D, 3, B_FLAG, 2), (ENC3D, 3, 4096, 4)):
        ef, eb = _windowed_check(cfg, dims, batch, n, rng)
        err_f, err_b = max(err_f, ef), max(err_b, eb)
    log(f"parallel: windowed lookup and table gradient vs plain (flagship encoding at 2^18 over 2 shards and "
        f"4096 over 3, the 3D model at 2^18 over 2 and 4096 over 4, plus cell-boundary points): max|diff| "
        f"{err_f:.3e} / {err_b:.3e} ({WINDOWED_TOL_NOTE})")

    image = torch.from_numpy(_load_synthetic_image()).cuda()
    t0 = time.perf_counter()
    a = run_ranks(_par_rank_nccl, 1, flagship, backend="nccl")[0]
    dt_a = time.perf_counter() - t0
    check(a["backend"] == "nccl", f"parallel (a): backend {a['backend']}")
    check(a["dp"][0] == a["single"][0], f"parallel (a): first loss {a['dp'][0]!r} is not bitwise the plain "
          f"trainer's {a['single'][0]!r}")
    lr = flagship["optimizer"]["learning_rate"]
    ra = _par_lockstep("parallel (a) NCCL world 1", {"losses": a["dp"], "params": a["dp_params"]},
                       {"losses": a["single"], "params": a["single_params"]},
                       {"losses": a["again"], "params": a["again_params"]}, lr)
    log(f"parallel (a) [{card}]: DataParallelTrainer over a one-rank NCCL mesh, FLAGSHIP_CONFIG at B = 2^18, "
        f"{PAR_NCCL_STEPS} steps beside the plain Trainer: first loss bitwise equal ({a['dp'][0]!r}); "
        f"{_lockstep_note(ra)}; {a['ms']['dp']:.4f} ms/step beside {a['ms']['single']:.4f} for the plain Trainer "
        f"({PAR_TIMED_STEPS} steps each, synced at the ends; {dt_a:.1f} s with the rank's start)")

    single_dp, again_dp = (_par_single(_par_config(flagship, 2), PAR_DP_STEPS, B_FLAG, 2, image) for _ in range(2))
    single_tp, again_tp = (_par_single(_par_config(flagship, 3), PAR_TP_STEPS, B_FLAG, 3, None) for _ in range(2))
    t0 = time.perf_counter()
    r2 = run_ranks(_par_rank_gloo2, 2, flagship)
    dt_2 = time.perf_counter() - t0
    log(f"parallel: gloo on CUDA tensors takes {r2[0]['collectives']}")
    # (b)
    dp0, dp1 = r2[0]["dp"], r2[1]["dp"]
    check(dp0["losses"] == dp1["losses"], "parallel (b): the ranks' losses differ")
    check(np.array_equal(dp0["params"], dp1["params"]), "parallel (b): the replicas' params differ")
    check(all(n == 1 for n in dp0["reduces"]), f"parallel (b): all_reduces a step {dp0['reduces']}, not 1")
    for k in TRAIN_COUNTERS:
        check(dp0["launches"][k] > 0, f"parallel (b): kernel {k} was not launched")
    rb = _par_lockstep("parallel (b) DP gloo 2 ranks", dp0, single_dp, again_dp, lr)
    log(f"parallel (b) [{card}]: DataParallelTrainer, 2 gloo ranks on cuda:0, FLAGSHIP_CONFIG at global B = 2^18 "
        f"stratified, {PAR_DP_STEPS} steps vs the single trainer: {_lockstep_note(rb)}; replicas bitwise equal; all_reduces a step {dp0['reduces'][0]}; "
        f"{dp0['ms']:.4f} ms/step (gloo: host-bound, rank 0, synced at the ends) beside {single_dp['ms']:.4f} "
        f"single; peak {dp0['peak_bytes'] / 2**20:.1f} / {dp1['peak_bytes'] / 2**20:.1f} MiB a rank beside "
        f"{single_dp['peak_bytes'] / 2**20:.1f} single; launches "
        f"(rank 0) {dp0['launches']}")
    # (c) on (1, 2)
    tp0, tp1 = r2[0]["tp"], r2[1]["tp"]
    check(tp0["losses"] == tp1["losses"], "parallel (c): the ranks' losses differ")
    check(all(n == 1 for n in tp0["reduces"]), f"parallel (c): all_reduces a step {tp0['reduces']}, not 1")
    rc = _par_lockstep("parallel (c) TP (1, 2)", tp0, single_tp, again_tp, lr, PAR_TP_FIRST_RTOL)
    for k in ("grid_fwd_windowed", "grid_bwd_windowed", "ffmlp_fwd", "ffmlp_bwd", "adam_step"):
        check(tp0["launches"][k] > 0 and tp1["launches"][k] > 0, f"parallel (c): kernel {k} was not launched")
    check(tp0["launches"]["grid_fwd"] == 0 and tp0["launches"]["grid_bwd"] == 0,
          "parallel (c): the unsharded grid kernels ran on the TP path")
    log(f"parallel (c) [{card}]: TableParallelTrainer on a (data 1, model 2) mesh, the --protocol 3d model "
        f"(13.0 M params, 52 MB of table) at B = 2^18, {PAR_TP_STEPS} steps vs the single trainer: first loss "
        f"ratio {abs(tp0['losses'][0] - single_tp['losses'][0]) / single_tp['losses'][0]:.3e} (<= "
        f"{PAR_TP_FIRST_RTOL}), {_lockstep_note(rc)}; {tp0['ms']:.4f} ms/step (gloo) "
        f"beside {single_tp['ms']:.4f} single; the card's peak bytes of the sharded state and step "
        f"{tp0['peak_bytes'] / 2**20:.1f} / {tp1['peak_bytes'] / 2**20:.1f} MiB a rank beside the single "
        f"trainer's {single_tp['peak_bytes'] / 2**20:.1f} ({tp0['local_n_params']} of "
        f"{tp0['local_n_params'] * 2} table params a rank); launches (rank 0) {tp0['launches']}")
    # (d)
    m = tt.create_from_config(2, 3, flagship, seed=SEED, device="cuda")
    m.trainer.params = torch.from_numpy(flagship_params(m.model, np.random.default_rng(SEED + 7)))
    server = m.trainer.freeze_serving()
    x = torch.rand((B_FLAG, 2), generator=torch.Generator(device="cuda").manual_seed(SEED + 8), device="cuda")
    s_single = {"batch": server(x).cpu().numpy(), "raster": server.raster(1024).cpu().numpy()}
    equal = {}
    for what in ("batch", "raster"):
        got, want = r2[0]["serve"][what], s_single[what]
        check(np.array_equal(got, r2[1]["serve"][what]), f"parallel (d): the ranks' {what} outputs differ")
        equal[what] = bool(np.array_equal(got, want))
        if not equal[what]:
            bf16_close(torch.from_numpy(got), torch.from_numpy(want), f"parallel (d) sharded {what}")
    for k in ("grid_fwd", "ffmlp_fwd"):
        check(all(r["serve"]["launches"][k] > 0 for r in r2), f"parallel (d): kernel {k} was not launched")
    log(f"parallel (d) [{card}]: FrozenServer over 2 gloo ranks, FLAGSHIP_CONFIG with random params: the 2^18 "
        f"batch {'bitwise equal to' if equal['batch'] else 'bf16_close to'} the single server's, the 1024^2 raster "
        f"{'bitwise equal' if equal['raster'] else 'bf16_close'} ({dt_2:.1f} s for (b)-(d) with the ranks' start)")

    # (c) on (2, 2)
    single_tp4, again_tp4 = (_par_single(_par_config(flagship, 3), PAR_TP4_STEPS, B_TP4, 3, None) for _ in range(2))
    t0 = time.perf_counter()
    r4 = run_ranks(_par_rank_gloo4, 4, flagship)
    dt_4 = time.perf_counter() - t0
    check(all(r["losses"] == r4[0]["losses"] for r in r4), "parallel (c, 4 ranks): the ranks' losses differ")
    check(all(n == 2 for n in r4[0]["reduces"]),
          f"parallel (c, 4 ranks): all_reduces a step {r4[0]['reduces']}, not 2 (features, then gradients)")
    rc4 = _par_lockstep("parallel (c) TP (2, 2)", r4[0], single_tp4, again_tp4, lr, PAR_TP_FIRST_RTOL)
    log(f"parallel (c) [{card}]: TableParallelTrainer on a (data 2, model 2) mesh, 4 gloo ranks, the 3D model at "
        f"B = 2^16, {PAR_TP4_STEPS} steps vs the single trainer: {_lockstep_note(rc4)}; {r4[0]['ms']:.4f} ms/step (gloo) beside {single_tp4['ms']:.4f} single; peak "
        f"{', '.join(f'{r['peak_bytes'] / 2**20:.1f}' for r in r4)} MiB a rank beside the single trainer's "
        f"{single_tp4['peak_bytes'] / 2**20:.1f} ({dt_4:.1f} s with the ranks' start)")

    times = _windowed_times(ENC3D, 3, B_FLAG, 2)
    for what, t in times.items():
        log(f"time [{card}]: windowed {'lookup' if what == 'fwd' else 'table gradient'}, the 3D model's shard 0 "
            f"of 2 at B = 2^18: kernel {t['kernel']:.4f} ms, plain {t['plain']:.4f} ms, bound {t['bound'][0]:.4f} "
            f"ms ({t['bound'][1]})")
    launches = {
        name: {"TP (1, 2), 2^18": sum(r["tp"]["launches"][name] for r in r2),
               "TP (2, 2), 2^16": sum(r["launches"][name] for r in r4)}
        for name in ("grid_fwd_windowed", "grid_bwd_windowed")
    }
    log(f"parallel: phase in {time.perf_counter() - t_phase:.1f} s")
    return {"err_fwd": err_f, "err_bwd": err_b, "times": times, "launches": launches}


# The higher orders (phase 12g): the curvature-regularised SDF fit on the
# 3D model through the module API (B_HO points a step, HO_FIT_STEPS steps),
# the table-gradient penalty through stochastic interpolation and through
# fixed_point_pos (HO_PENALTY_STEPS steps each), and one table-parallel
# eikonal step over 2 gloo ranks against the single process.
B_HO = 2**16
HO_FIT_STEPS = 200
HO_PENALTY_STEPS = 20
HO_PENALTY_WEIGHT = 1e-3
HO_FIT_COUNTERS = {
    "grid_fwd": ("grid_encode", "LAUNCHES"), "grid_bwd": ("grid_encode", "BWD_LAUNCHES"),
    "grid_bwd_input": ("grid_encode", "INPUT_LAUNCHES"), "grid_bwdbwd": ("grid_encode", "BWDBWD_LAUNCHES"),
    "grid_bwd3": ("grid_encode", "THIRD_LAUNCHES"),
    "ffmlp_fwd": ("ffmlp", "LAUNCHES"), "ffmlp_bwd": ("ffmlp", "BWD_LAUNCHES"),
}
# The curvature step's time before G3 (PR 24's chip_smoke runs, NVIDIA H100
# 80GB HBM3, 700.00 W: the third order autograd of the plain G2).
HO_CURVATURE_MS_PR24 = (91.17, 110.02)
HO_TP_COUNTERS = {
    "grid_fwd_windowed": ("grid_encode", "WINDOWED_LAUNCHES"),
    "grid_bwd_windowed": PAR_COUNTERS["grid_bwd_windowed"],
    "grid_bwd_input_windowed": ("grid_encode", "WINDOWED_INPUT_LAUNCHES"),
    "grid_bwdbwd_windowed": ("grid_encode", "WINDOWED_BWDBWD_LAUNCHES"),
    "grid_bwd3_windowed": ("grid_encode", "WINDOWED_THIRD_LAUNCHES"),
    "grid_fwd": ("grid_encode", "LAUNCHES"), "grid_bwd_input": ("grid_encode", "INPUT_LAUNCHES"),
    "grid_bwdbwd": ("grid_encode", "BWDBWD_LAUNCHES"), "grid_bwd3": ("grid_encode", "THIRD_LAUNCHES"),
}
HO_TOL_NOTE = ("the one TP step against the single process: loss within PAR_LOSS_RTOL (PERF.md section 2), the "
               "network's and the table's gradients within 1e-2 of the norm (a bf16 network whose roundings flip "
               "in another sum order)")


def _ho_windowed_kernels(card, rng):
    """The windowed G1 and G2 on the 3D model's shard 0 of 2 against their
    plain versions at B = 2^18 plus cell-boundary points, then timed at
    2^18 beside them, with their bounds."""
    import torch

    from tcnn_tpu_torch.encodings import create_encoding
    from tcnn_tpu_torch.encodings.grid import _INTERP_CODES
    from tcnn_tpu_torch.ops import grid_encode as ge

    dev = torch.device("cuda")
    enc = create_encoding(3, TP3D_ENCODING, alignment=16)
    F, L, d = enc.n_features_per_level, enc.n_levels, 3
    interp = _INTERP_CODES[enc.interpolation_type]
    tpg = _shard_grid(enc, 2, 0)
    levels, windows = tpg._tables_on(dev)
    x_np = np.concatenate([rng.uniform(0, 1, (B_FLAG, d)), _boundary_points(enc.scales, rng, 256, dims=d)])
    x = torch.from_numpy(x_np.astype(np.float32)).to(dev)
    n, n_local = len(x_np), tpg.local_n_params
    local = torch.from_numpy(rng.uniform(-1, 1, n_local).astype(np.float32)).to(dev)
    cgp = torch.from_numpy(rng.normal(0, 1, n_local).astype(np.float32)).to(dev)
    dy = torch.from_numpy(rng.normal(0, 1, (n, L * F)).astype(np.float32)).to(dev)
    cgx = torch.from_numpy(rng.normal(0, 1, (n, d)).astype(np.float32)).to(dev)
    classes = ge._f32_classes(L, dev)
    n0 = (ge.WINDOWED_INPUT_LAUNCHES, ge.WINDOWED_BWDBWD_LAUNCHES)
    e1 = f32_close(ge.grid_backward_input_windowed(x, dy, local, levels, windows, F, interp),
                   ge.grid_backward_input_plain(x, dy, local, levels, F, interp, windows), "windowed G1 shard 0/2")
    got = ge.grid_backward_backward_windowed(x, dy, local, levels, windows, F, interp, cgp, cgx)
    want = ge.grid_backward_backward_plain(x, dy, local, levels, F, interp, classes, cgp, cgx, windows)
    torch.cuda.synchronize()
    check((ge.WINDOWED_INPUT_LAUNCHES, ge.WINDOWED_BWDBWD_LAUNCHES) == (n0[0] + 1, n0[1] + 1),
          "windowed G1 / G2: a launch did not move its count")
    e2 = max(f32_close(got[1], want[1], "windowed G2 d/dx"), f32_close(got[2], want[2], "windowed G2 d/d(dL_dy)"))
    check(got[0].shape == want[0].shape == (n_local,) and bool(got[0].isfinite().all()), "windowed G2: bad d/dparams")
    e = float((got[0] - want[0]).abs().max())
    check(e <= 1e-5 * float(want[0].abs().max()), f"windowed G2 d/dparams: max|diff| {e:.3e}")
    e2 = max(e2, e)
    log(f"higher orders: windowed G1 / G2 (the 3D model's shard 0 of 2, {n} points: 2^18 uniform and "
        f"{n - B_FLAG} on cell boundaries +-1 ulp; G2 with cgp and cgx) match their plain versions "
        f"({TOL_F32_NOTE}; G2's local table gradient within 1e-5 of max |plain|): max|diff| {e1:.3e} / {e2:.3e}")
    x, dy, cgx = x[:B_FLAG], dy[:B_FLAG], cgx[:B_FLAG]
    calls = {
        "grid_bwd_input_windowed": (lambda: ge.grid_backward_input_windowed(x, dy, local, levels, windows, F, interp),
                                    lambda: ge.grid_backward_input_plain(x, dy, local, levels, F, interp, windows)),
        "grid_bwdbwd_windowed": (
            lambda: ge.grid_backward_backward_windowed(x, dy, local, levels, windows, F, interp, cgp, cgx),
            lambda: ge.grid_backward_backward_plain(x, dy, local, levels, F, interp, classes, cgp, cgx, windows)),
    }
    B = B_FLAG
    # G1: x and dL/dy read, the rank's rows read, dL/dx written; per (sample,
    # level, corner) the d^2 products of the weight derivatives, the F-dot
    # and d multiply-adds (every corner's weights on every rank). G2: x,
    # cgx, dL/dy read, the rank's rows and cgp read, d/dx, d/d(dL_dy) and
    # the rank's table gradient written; as phase 13's G2 operations.
    bounds = {
        "grid_bwd_input_windowed": bound(B * d * 4 * 2 + B * L * F * 4 + n_local * 4,
                                         B * L * 8 * (2 * F + d * d + 2 * d), "fp32"),
        "grid_bwdbwd_windowed": bound(B * d * 4 * 3 + B * L * F * 4 * 2 + 3 * n_local * 4,
                                      B * L * 8 * (d ** 3 + 3 * d * d + 4 * d + 6 * F), "fp32"),
    }
    times = {}
    for name, (kernel, plain) in calls.items():
        p1, k1, k2, p2 = _event_ms(plain, 2, 3), _event_ms(kernel), _event_ms(kernel), _event_ms(plain, 2, 3)
        times[name] = {"kernel": statistics.median([k1, k2]), "plain": statistics.median([p1, p2]),
                       "bound": bounds[name], "library": None}
        log(f"time [{card}]: {name}, the 3D model's shard 0 of 2 at B = 2^18 (fp32 dL/dy"
            + (", cgp and cgx" if "bwdbwd" in name else "") + f"): kernel {k1:.4f} / {k2:.4f} ms, plain "
            f"{p1:.4f} / {p2:.4f} ms (in turns, CUDA events), bound {bounds[name][0]:.4f} ms ({bounds[name][1]})")
    return {"err": {"grid_bwd_input_windowed": e1, "grid_bwdbwd_windowed": e2}, "times": times}


def _g3_bound(B, d, L, F, n_params, dy_bytes):
    """G3's bound on B points of a Linear grid with the curvature loss's
    cotangents (cgx, g_x, g_dy; no cgp, no g_params). Bytes: x, cgx, g_x
    read, dL/dy (``dy_bytes`` a value) and g_dy read, the table read and
    d/dparams written once, d/dx, d/dcgx and d/d(dL_dy) written. Operations
    per (sample, level, corner), fp32, only what Linear needs (the fraction
    weights' second and third derivatives are 0: the Hessian's diagonal is
    zero and the third derivative has only the entries whose three indices
    differ): the weight, its d gradient entries,
    the Hessian's d(d-1)/2 distinct entries and the third derivative's
    C(d, 3), each a product of d factors (d - 1 multiplies); a = cgx.grad w
    and h = g_x.(H cgx) (2d); H cgx and H g_x (2d(d-1)); T3[g_x, cgx]
    (d(d-1)(d-2)); the F-dots <g_l, T_c> and <g_dy_l, T_c> (2F); the outputs
    d/dparams (2F), d/d(dL_dy) (F), d/dcgx and d/dx (4d)."""
    n_bytes = B * d * 4 * 3 + B * L * F * (dy_bytes + 4) + n_params * 4 * 2 + B * d * 4 * 2 + B * L * F * 4
    weights = (1 + d + d * (d - 1) // 2 + d * (d - 1) * (d - 2) // 6) * (d - 1)
    per_corner = weights + 2 * d + 2 * d * (d - 1) + d * (d - 1) * (d - 2) + 5 * F + 4 * d
    return bound(n_bytes, B * L * 2 ** d * per_corner, "fp32")


def _ho_third_order_kernels(card, rng):
    """G3 on the 3D model at B_HO plus cell-boundary points (bf16 dL/dy, the
    classes of that batch) and the windowed G3 on its TP form's shard 0 of
    2, each against its plain version with every cotangent and with the
    curvature loss's (cgx, g_x, g_dy); then, at B_HO, G3 with the curvature
    loss's operands timed beside its plain version and beside G2 with that
    loss's (cgx only), and the windowed G3 beside its plain version, with
    their bounds."""
    import torch

    from tcnn_tpu_torch.encodings import create_encoding
    from tcnn_tpu_torch.ops import grid_encode as ge
    from tcnn_tpu_torch.ops.scatter_rows import ACC_F32

    dev = torch.device("cuda")
    t = _grid_inputs(ENC3D, rng, dev, B_HO)
    x, dy, params, cgx, cgp = t["x"], t["dy"], t["params"], t["cgx"], t["cgp"]
    n, (levels, F, interp) = len(x), _grid_args(t)
    g_x = torch.from_numpy(rng.normal(0, 1, (n, 3)).astype(np.float32)).to(dev)
    g_dy = torch.from_numpy(rng.normal(0, 1, (n, 32)).astype(np.float32)).to(dev)
    g_p = torch.from_numpy(rng.normal(0, 1, t["enc"].n_params).astype(np.float32)).to(dev)
    cls = t["classes"]
    exact_cls = cls.clone()
    exact_cls[:, 1] = ACC_F32
    n0 = ge.THIRD_LAUNCHES
    err, scale = 0.0, 0.0
    for what, cots in (("every cotangent", (cgp, cgx, g_p, g_x, g_dy)), ("the curvature loss's", (None, cgx, None,
                                                                                                     g_x, g_dy))):
        ops = (x, dy, params, levels, F, interp)
        k = ge.grid_backward3(*ops, cls, *cots)
        p = ge.grid_third_order_plain(*ops, cls, *cots)
        exact = ge.grid_third_order_plain(*ops, exact_cls, *cots)
        torch.cuda.synchronize()
        for i, name in ((1, "d/dx"), (2, "d/d(dL_dy)"), (4, "d/dcgx")):
            err = max(err, f32_close(k[i], p[i], f"grid_bwd3 {what} {name}"))
        for i, name in ((0, "d/dparams"), (3, "d/dcgp")):
            if p[i] is None:
                check(k[i] is None, f"grid_bwd3 {what}: {name} where none is wanted")
            else:
                err = max(err, _table_grad_check(k[i], p[i], exact[i], t, f"grid_bwd3 {what} {name}"))
                scale = max(scale, float(p[i].abs().max()))
    check(ge.THIRD_LAUNCHES == n0 + 2, "grid_bwd3: a launch did not move its count")
    log(f"higher orders: G3 (3D model, {n} points: 2^16 uniform and {n - B_HO} on cell boundaries +-1 ulp; bf16 dL/dy; "
        f"every cotangent, and the curvature loss's) matches its plain version ({TOL_F32_NOTE}; d/dparams and d/dcgp "
        f"per level in its class, accumulation codes {t['classes_np'][:, 1].tolist()}): max|diff| {err:.3e} "
        f"(max |plain| of d/dparams and d/dcgp {scale:.3e}; a bf16 level's sums differ by bf16 ulps of theirs)")
    tpg = _shard_grid(create_encoding(3, TP3D_ENCODING, alignment=16), 2, 0)
    lv_w, windows = tpg._tables_on(dev)
    n_local, L = tpg.local_n_params, tpg.encoding.n_levels
    local = torch.from_numpy(rng.uniform(-1, 1, n_local).astype(np.float32)).to(dev)
    w_ops = {k_: torch.from_numpy(rng.normal(0, 1, n_local).astype(np.float32)).to(dev) for k_ in ("cgp", "g_p")}
    dy32 = dy.float()[:, : L * F].contiguous()
    n0 = ge.WINDOWED_THIRD_LAUNCHES
    wargs = (x, dy32, local, lv_w, windows, F, interp, w_ops["cgp"], cgx, w_ops["g_p"], g_x,
             g_dy[:, : L * F].contiguous())
    k = ge.grid_backward3_windowed(*wargs)
    classes_w = ge._f32_classes(L, dev)
    p = ge.grid_third_order_plain(x, dy32, local, lv_w, F, interp, classes_w, w_ops["cgp"], cgx, w_ops["g_p"], g_x,
                                  wargs[-1], windows)
    torch.cuda.synchronize()
    check(ge.WINDOWED_THIRD_LAUNCHES == n0 + 1, "grid_bwd3_windowed: a launch did not move its count")
    err_w, scale_w = 0.0, 0.0
    for i, name in ((1, "d/dx"), (2, "d/d(dL_dy)"), (4, "d/dcgx")):
        err_w = max(err_w, f32_close(k[i], p[i], f"grid_bwd3_windowed {name}"))
    for i, name in ((0, "d/dparams"), (3, "d/dcgp")):
        check(k[i].shape == (n_local,) and bool(k[i].isfinite().all()), f"grid_bwd3_windowed {name}: bad output")
        e, scale_w = float((k[i] - p[i]).abs().max()), max(scale_w, float(p[i].abs().max()))
        check(e <= 1e-5 * float(p[i].abs().max()), f"grid_bwd3_windowed {name}: max|diff| {e:.3e}")
        err_w = max(err_w, e)
    log(f"higher orders: windowed G3 (the 3D model's TP form, shard 0 of 2, {n} points, fp32 dL/dy, every cotangent) "
        f"matches its plain version ({TOL_F32_NOTE}; the local d/dparams and d/dcgp, fp32 atomics, within 1e-5 of "
        f"max |plain|, here {scale_w:.3e}): max|diff| {err_w:.3e}")
    B = B_HO
    x, dy, cgx, g_x, g_dy = x[:B], dy[:B], cgx[:B], g_x[:B], g_dy[:B]
    cls_b = torch.from_numpy(t["enc"].gradient_classes(B)).to(dev)
    wargs = (x, dy32[:B], local, lv_w, windows, F, interp, None, cgx, None, g_x, g_dy[:, : L * F].contiguous())
    calls = {
        "grid_bwd3": (lambda: ge.grid_backward3(x, dy, params, levels, F, interp, cls_b, None, cgx, None, g_x, g_dy),
                      lambda: ge.grid_third_order_plain(x, dy, params, levels, F, interp, cls_b, None, cgx, None, g_x,
                                                        g_dy)),
        "grid_bwd3_windowed": (lambda: ge.grid_backward3_windowed(*wargs),
                               lambda: ge.grid_third_order_plain(*wargs[:2], local, lv_w, F, interp, classes_w,
                                                                 None, cgx, None, g_x, wargs[-1], windows)),
    }
    n_params = t["enc"].n_params
    check(t["enc"].interpolation_type == "Linear", "grid_bwd3: _g3_bound counts a Linear grid's operations")
    bounds = {"grid_bwd3": _g3_bound(B, 3, t["enc"].n_levels, F, n_params, 2),
              "grid_bwd3_windowed": _g3_bound(B, 3, L, F, n_local, 4)}
    times = {}
    for name, (kernel, plain) in calls.items():
        p1, k1, k2, p2 = _event_ms(plain, 2, 3), _event_ms(kernel), _event_ms(kernel), _event_ms(plain, 2, 3)
        times[name] = {"kernel": statistics.median([k1, k2]), "plain": statistics.median([p1, p2]),
                       "bound": bounds[name], "library": None}
        log(f"time [{card}]: {name}, the 3D model" + (" (TP form, shard 0 of 2, fp32 dL/dy)" if "windowed" in name
                                                      else " (bf16 dL/dy, the 2^16 classes)")
            + f" at B = 2^16 with the curvature loss's cotangents (cgx, g_x, g_dy): kernel {k1:.4f} / {k2:.4f} ms, "
            f"plain {p1:.4f} / {p2:.4f} ms (in turns, CUDA events), bound {bounds[name][0]:.4f} ms "
            f"({bounds[name][1]})")
    g2 = lambda: ge.grid_backward_backward(x, dy, params, levels, F, interp, cls_b, None, cgx)  # noqa: E731
    g3 = calls["grid_bwd3"][0]
    g2a, g3a, g3b, g2b = _event_ms(g2), _event_ms(g3), _event_ms(g3), _event_ms(g2)
    log(f"time [{card}]: G3 beside G2 on the curvature path's operands, the 3D model at B = 2^16 (G2: cgx, the "
        f"classes' table gradient; G3: cgx, g_x, g_dy): G2 {g2a:.4f} / {g2b:.4f} ms, G3 {g3a:.4f} / {g3b:.4f} ms "
        f"(in turns, CUDA events)")
    return {"err": {"grid_bwd3": err, "grid_bwd3_windowed": err_w}, "times": times,
            "g2_ms": statistics.median([g2a, g2b])}


def _ho_flagship_cotangent_kernels(card, flagship, rng):
    """The cgp terms on the flagship encoding at B = 2^18 plus cell-boundary
    points: the sampled-corner gather (fp32 and uint32 positions) bitwise
    against its plain version, and the fixed_point_pos cotangent lookup (the
    lookup kernel with cgp as its table) against its plain version; then
    the gather timed beside its plain version, with its bound."""
    import torch

    from tcnn_tpu_torch.encodings import create_encoding
    from tcnn_tpu_torch.encodings.grid import _INTERP_CODES
    from tcnn_tpu_torch.ops import grid_encode as ge

    dev = torch.device("cuda")
    enc = create_encoding(2, flagship["encoding"], alignment=16)
    F, L, d, width = enc.n_features_per_level, enc.n_levels, 2, enc.padded_output_width
    interp = _INTERP_CODES[enc.interpolation_type]
    levels = enc._levels_on(dev)
    x_np = np.concatenate([rng.uniform(0, 1, (B_FLAG, d)), _boundary_points(enc.scales, rng, 256, dims=d)])
    n = len(x_np)
    x = torch.from_numpy(x_np.astype(np.float32)).to(dev)
    xu = _as_fixed(x)
    u = torch.from_numpy(rng.uniform(0, 1, (n, L)).astype(np.float32)).to(dev)
    cgp = torch.from_numpy(rng.normal(0, 1, enc.n_params).astype(np.float32)).to(dev)
    n0 = ge.SAMPLED_LAUNCHES
    for what, pos in (("fp32", x), ("uint32", xu)):
        got = ge.grid_encode_sampled(pos, cgp, levels, u, F, width, interp)
        want = ge.grid_encode_sampled_plain(pos, cgp, levels, u, F, width, interp)
        check(got.shape == (n, width) and torch.equal(got, want),
              f"sampled-corner gather ({what} positions): not bitwise its plain version")
    check(ge.SAMPLED_LAUNCHES == n0 + 2, "sampled-corner gather: a launch did not move its count")
    fenc = create_encoding(2, dict(flagship["encoding"], fixed_point_pos=True), alignment=16)
    flevels = fenc._levels_on(dev)
    classes = torch.from_numpy(fenc.gradient_classes(n)).to(dev)
    e_fixed = f32_close(ge._cgp_term(xu, cgp, flevels, classes, None, F, width, interp, False),
                        ge._cgp_term(xu, cgp, flevels, classes, None, F, width, interp, True),
                        "fixed_point_pos cotangent lookup")
    log(f"higher orders: the sampled-corner gather (flagship encoding, {n} points: 2^18 uniform and {n - B_FLAG} on "
        f"cell boundaries +-1 ulp; fp32 and uint32 positions) is bitwise its plain version; the fixed_point_pos "
        f"cotangent lookup (tcnn_grid_forward with cgp as its table) matches its plain version ({TOL_F32_NOTE}): "
        f"max|diff| {e_fixed:.3e}")
    x, u = x[:B_FLAG], u[:B_FLAG]
    kernel = lambda: ge.grid_encode_sampled(x, cgp, levels, u, F, width, interp)  # noqa: E731
    plain = lambda: ge.grid_encode_sampled_plain(x, cgp, levels, u, F, width, interp)  # noqa: E731
    p1, k1, k2, p2 = _event_ms(plain, 2, 3), _event_ms(kernel), _event_ms(kernel), _event_ms(plain, 2, 3)
    B = B_FLAG
    # x and the uniforms read, the sampled rows read (at most the table),
    # the (B, width) output written; per (sample, level) the cell (a
    # multiply, an add, a floor and a subtraction a dim) and the corner's
    # compare a dim.
    bnd = bound(B * d * 4 + B * L * 4 + min(enc.n_params * 4, B * L * F * 4) + B * width * 4, B * L * 5 * d, "fp32")
    log(f"time [{card}]: grid_fwd_sampled, the flagship encoding at B = 2^18 (fp32 positions, fp32 cgp): kernel "
        f"{k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms (in turns, CUDA events), bound {bnd[0]:.4f} ms "
        f"({bnd[1]})")
    return {"err": 0.0, "err_fixed": e_fixed,
            "times": {"kernel": statistics.median([k1, k2]), "plain": statistics.median([p1, p2]), "bound": bnd,
                      "library": None}}


def _ho_curvature_fit(card):
    """The curvature-regularised SDF fit: modules.NetworkWithInputEncoding
    on the 3D model, ``curvature_step`` (L2 + eikonal + curvature) with
    torch.optim.Adam at B_HO; one step kernel vs plain from the same state,
    then HO_FIT_STEPS steps with the counts at 0 just before and read just
    after; synced ms/step beside the eikonal-only step's at the same B."""
    import torch

    from tcnn_tpu_torch import modules
    from tcnn_tpu_torch.benchmarks.grid_second_order_times import CURVATURE_WEIGHT, curvature_step, sdf_step, sphere_sdf

    dev = torch.device("cuda")
    m = modules.NetworkWithInputEncoding(3, 1, ENC3D, NET3D, seed=SEED + 52)
    gen = torch.Generator(device=dev).manual_seed(SEED + 53)

    def batch():
        x = torch.rand((B_HO, 3), generator=gen, device=dev)
        v = torch.nn.functional.normalize(torch.randn((B_HO, 3), generator=gen, device=dev), dim=1)
        return x, sphere_sdf(x), v

    def new_opt(lr=5e-3):
        opt = torch.optim.Adam(m.parameters(), lr=lr, betas=(0.9, 0.99), eps=1e-15)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda i: min(1.0, (i + 1) / 20))

    p0 = m.params.detach().clone()
    x, target, v = batch()
    (loss_k, _), p_k = curvature_step(new_opt()[0], m, x.clone(), target, v), m.params.detach().clone()
    with torch.no_grad():
        m.params.copy_(p0)
    loss_p, _ = curvature_step(new_opt()[0], lambda xx: m.apply_plain(m.params, xx)[:, :1].float(), x.clone(),
                               target, v)
    p_p = m.params.detach().clone()
    with torch.no_grad():
        m.params.copy_(p0)
    torch.cuda.synchronize()
    rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    diff = (p_k - p_p).abs()
    moved = float((diff > 1e-6).float().mean())
    check(bool(torch.isfinite(loss_k)) and rel <= 1e-3, f"curvature fit: one-step loss {float(loss_k)} vs plain "
          f"{float(loss_p)}")
    check(float(diff.max()) <= 2 * 5e-3 / 20 * 1.0001 and moved <= 1e-2,
          f"curvature fit: one step's params max|diff| {float(diff.max()):.3e}, {moved:.2e} of them differ")
    opt, schedule = new_opt()
    _zero_counts(HO_FIT_COUNTERS)
    losses, curv, step_ms = [], [], []
    t_start = time.perf_counter()
    for i in range(HO_FIT_STEPS):
        x, target, v = batch()
        if i >= 20:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        loss, c = curvature_step(opt, m, x, target, v)
        schedule.step()
        if i >= 20:
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        curv.append(c)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = _read_counts(HO_FIT_COUNTERS)
    losses, curv = torch.stack(losses).cpu().numpy(), torch.stack(curv).cpu().numpy()
    first, last = float(losses[0]), float(losses[-10:].mean())
    log(f"higher orders: curvature fit, loss every 10 steps {', '.join(f'{v:.4g}' for v in losses[::10])}; "
        f"curvature term every 10 steps {', '.join(f'{v:.4g}' for v in curv[::10])}")
    check(np.isfinite(losses).all() and bool(m.params.isfinite().all()), "curvature fit: non-finite loss or params")
    check(last < 0.75 * first, f"curvature fit: the loss did not fall below three quarters ({first:.4e} -> "
          f"{last:.4e})")
    for k, n_launch in launches.items():
        check(n_launch > 0, f"curvature fit: kernel {k} was not launched")
    check(launches["grid_bwd3"] == HO_FIT_STEPS, f"curvature fit: G3 launched {launches['grid_bwd3']} times in "
          f"{HO_FIT_STEPS} steps, not once a step")
    eik_ms = []
    for i in range(25):
        x, target, _ = batch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sdf_step(opt, m, x, target)
        torch.cuda.synchronize()
        if i >= 5:
            eik_ms.append((time.perf_counter() - t0) * 1e3)
    med, med_eik = statistics.median(step_ms), statistics.median(eik_ms)
    log(f"higher orders: curvature fit, {HO_FIT_STEPS} steps at B = 2^16 of L2 + eikonal + {CURVATURE_WEIGHT} "
        f"mean |H v|^2 (H v: two create_graph input gradients; its parameter gradient a third derivative, G3 once a "
        f"step) on a sphere SDF, torch.optim.Adam lr 5e-3: one step kernel vs plain loss "
        f"{float(loss_k):.6f} / {float(loss_p):.6f} (rel {rel:.2e}, bound 1e-3), params max|diff| "
        f"{float(diff.max()):.3e}; loss {first:.4e} -> {last:.4e} (mean of the last 10; bound: below three "
        f"quarters); curvature term {float(curv[0]):.4e} -> "
        f"{float(curv[-10:].mean()):.4e}; kernel launches {launches}")
    log(f"time [{card}]: curvature SDF step (module API, 3D model, B = 2^16): {med:.4f} ms/step (host clock + "
        f"synchronize, median of steps 20-{HO_FIT_STEPS - 1}) beside the eikonal-only SDF step's {med_eik:.4f} "
        f"ms/step at the same B (median of 20); PR 24's, the third order autograd of the plain G2: "
        f"{HO_CURVATURE_MS_PR24[0]}-{HO_CURVATURE_MS_PR24[1]} ms/step; {HO_FIT_STEPS} steps in {wall:.2f} s")
    return {"launches": launches, "ms": med, "eikonal_ms": med_eik, "loss": (first, last)}


def _ho_penalty_path(flagship, extra, name):
    """A table-gradient penalty through the module API: the image fit's
    RelativeL2-style loss plus HO_PENALTY_WEIGHT times the mean square of
    its gradient in the grid parameters (taken with create_graph), through
    NetworkWithInputEncoding.apply with ``extra`` (stochastic interpolation
    with rng=generator, or fixed_point_pos on uint32 points), B_HO a step,
    HO_PENALTY_STEPS steps, counts at 0 just before and read just after:
    the second derivative through that table gradient on the card."""
    import torch

    import tcnn_tpu_torch as tt

    cfg = _extra_config(flagship, "Adam")
    cfg["encoding"].update(extra)
    model = tt.create_from_config(2, 3, cfg, seed=SEED, device="cuda").model
    gen = torch.Generator(device="cuda").manual_seed(SEED + 54)
    rng = torch.Generator(device="cuda").manual_seed(SEED + 55)
    stochastic = bool(extra.get("stochastic_interpolation"))
    n_net = model.network.n_params
    counters = {"grid_fwd": ("grid_encode", "LAUNCHES"), "grid_bwd": ("grid_encode", "BWD_LAUNCHES")}
    if stochastic:
        counters["grid_fwd_sampled"] = ("grid_encode", "SAMPLED_LAUNCHES")
    opt = torch.optim.Adam([model.params], lr=1e-2, betas=(0.9, 0.99), eps=1e-15)
    _zero_counts(counters)
    losses = []
    for _ in range(HO_PENALTY_STEPS):
        x = torch.rand((B_HO, 2), generator=gen, device="cuda")
        y = torch.stack([torch.sin(9 * x[:, 0]), torch.cos(7 * x[:, 1]), x[:, 0] * x[:, 1]], 1) * 0.5 + 0.5
        pos = _as_fixed(x) if extra.get("fixed_point_pos") else x
        out = model.apply(model.params, pos, **({"rng": rng} if stochastic else {}))[:, :3].float()
        data = torch.mean((out - y) ** 2 / (out.detach() ** 2 + 0.01))
        (gp,) = torch.autograd.grad(data, model.params, create_graph=True)
        loss = data + HO_PENALTY_WEIGHT * (gp[n_net:] ** 2).sum()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    launches = _read_counts(counters)
    losses = torch.stack(losses).cpu().numpy()
    check(np.isfinite(losses).all() and float(losses[-3:].mean()) < float(losses[:3].mean()),
          f"higher orders {name}: loss {losses[:3].mean():.4e} -> {losses[-3:].mean():.4e}")
    for k, v in launches.items():
        check(v > 0, f"higher orders {name}: kernel {k} was not launched")
    log(f"higher orders: table-gradient penalty ({name}, FLAGSHIP_CONFIG's model, NetworkWithInputEncoding.apply, "
        f"torch.optim.Adam, {HO_PENALTY_STEPS} steps at B = 2^16, weight {HO_PENALTY_WEIGHT}): loss "
        f"{losses[:3].mean():.4e} -> {losses[-3:].mean():.4e} (means of 3); kernel launches {launches}")
    return {"launches": launches}


def _ho_tp_step(cfg, reference=False):
    """One curvature SDF step's loss and gradients on the 3D TP model at
    B_HO (L2 + eikonal + CURVATURE_WEIGHT mean |H v|^2: the windowed G1,
    G2 and G3): through TableParallelGrid over the mesh's model axis on a
    spawned rank, or (``reference``) through the single process's unsharded
    lookup. Returns the loss, the network's gradient, the encoding's
    gradient (this rank's rows, or the whole table) and the launches."""
    import torch

    import tcnn_tpu_torch as tt
    from tcnn_tpu_torch.benchmarks.grid_second_order_times import CURVATURE_WEIGHT, EIKONAL_WEIGHT, sphere_sdf

    m = tt.create_from_config(3, 1, cfg, seed=SEED, device="cpu")
    model = m.model
    flat = m.trainer.params.numpy()
    n_net = model.network.n_params
    net = torch.from_numpy(flat[:n_net].copy()).cuda().requires_grad_(True)
    if reference:
        enc = torch.from_numpy(flat[n_net:].copy()).cuda().requires_grad_(True)
        encode, shard = model.encoding.apply, None
    else:
        from torch.distributed.device_mesh import init_device_mesh

        from tcnn_tpu_torch.parallel import TableParallelGrid

        tpg = TableParallelGrid(model.encoding, init_device_mesh("cuda", (1, 2), mesh_dim_names=("data", "model")))
        enc = torch.from_numpy(tpg.local_params(flat[n_net:])).cuda().requires_grad_(True)
        encode, shard = tpg.padded_apply, tpg.shard
    gen = torch.Generator(device="cuda").manual_seed(SEED + 56)
    x = torch.rand((B_HO, 3), generator=gen, device="cuda")
    v = torch.nn.functional.normalize(torch.randn((B_HO, 3), generator=gen, device="cuda"), dim=1)
    target = sphere_sdf(x)
    _zero_counts(HO_TP_COUNTERS)
    x.requires_grad_(True)
    f = model.network.apply(net, encode(enc, x))[:, :1].float()
    (g,) = torch.autograd.grad(f, x, torch.ones_like(f), create_graph=True)
    (hv,) = torch.autograd.grad((g * v).sum(), x, create_graph=True)
    loss = (((f - target) ** 2).mean() + EIKONAL_WEIGHT * ((g.norm(dim=1) - 1) ** 2).mean()
            + CURVATURE_WEIGHT * (hv * hv).sum(dim=1).mean())
    g_net, g_enc = torch.autograd.grad(loss, (net, enc))
    torch.cuda.synchronize()
    return {"loss": float(loss.detach()), "net": g_net.cpu().numpy(), "enc": g_enc.cpu().numpy(), "shard": shard,
            "launches": _read_counts(HO_TP_COUNTERS)}


def _ho_rank_tp(rank, world, cfg):
    _par_assert_port_only("higher orders TP")
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    out = _ho_tp_step(cfg)
    _par_assert_port_only("higher orders TP")
    return out


def phase_higher_orders(card, flagship):
    """The derivatives beyond the SDF path's: the new kernels against their
    plain versions and timed; the curvature fit; the table-gradient penalty
    paths; one table-parallel eikonal step over 2 gloo ranks against the
    single process."""
    from tcnn_tpu_torch.encodings import create_encoding
    from tcnn_tpu_torch.parallel.launch import run_ranks

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 57)
    win = _ho_windowed_kernels(card, rng)
    third = _ho_third_order_kernels(card, rng)
    samp = _ho_flagship_cotangent_kernels(card, flagship, rng)
    fit = _ho_curvature_fit(card)
    penalties = {name: _ho_penalty_path(flagship, extra, name)
                 for name, extra in (("stochastic_interpolation, rng=generator", {"stochastic_interpolation": True}),
                                     ("fixed_point_pos", {"fixed_point_pos": True}))}
    cfg = {**_par_config(flagship, 3), "network": dict(NET3D)}
    single = _ho_tp_step(cfg, reference=True)
    t0 = time.perf_counter()
    ranks = run_ranks(_ho_rank_tp, 2, cfg)
    dt = time.perf_counter() - t0
    check(sorted(r["shard"] for r in ranks) == [0, 1], "higher orders TP: the ranks' shards")
    tpg = _shard_grid(create_encoding(3, cfg["encoding"], alignment=16), 2, 0)
    enc_grad = tpg.unshard_params(np.concatenate([r["enc"] for r in sorted(ranks, key=lambda r: r["shard"])]))
    rel = {"loss": abs(ranks[0]["loss"] - single["loss"]) / abs(single["loss"])}
    for what, got in (("network", ranks[0]["net"]), ("table", enc_grad)):
        want = single["net"] if what == "network" else single["enc"]
        rel[what] = float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))
    check(ranks[0]["loss"] == ranks[1]["loss"] and np.array_equal(ranks[0]["net"], ranks[1]["net"]),
          "higher orders TP: the ranks' losses or network gradients differ")
    check(rel["loss"] <= PAR_LOSS_RTOL and rel["network"] <= 1e-2 and rel["table"] <= 1e-2,
          f"higher orders TP: loss / network / table gradient relative differences {rel} ({HO_TOL_NOTE})")
    for k in ("grid_fwd_windowed", "grid_bwd_windowed", "grid_bwd_input_windowed", "grid_bwdbwd_windowed",
              "grid_bwd3_windowed"):
        check(all(r["launches"][k] > 0 for r in ranks), f"higher orders TP: kernel {k} was not launched")
    check(all(r["launches"][k] == 0 for r in ranks for k in ("grid_fwd", "grid_bwd_input", "grid_bwdbwd",
                                                            "grid_bwd3")),
          "higher orders TP: an unsharded grid kernel ran on the TP path")
    log(f"higher orders [{card}]: one curvature SDF step of the 3D TP model (per_level, fp32 sums) at B = 2^16 "
        f"through TableParallelGrid on a (data 1, model 2) mesh of 2 gloo ranks on cuda:0 against the single "
        f"process: loss {ranks[0]['loss']:.6f} / {single['loss']:.6f}, relative differences {rel} ({HO_TOL_NOTE}); "
        f"launches (rank 0) {ranks[0]['launches']} ({dt:.1f} s with the ranks' start)")
    launches = {
        name: {"TP curvature step (1, 2), 2^16": sum(r["launches"][name] for r in ranks)}
        for name in ("grid_bwd_input_windowed", "grid_bwdbwd_windowed", "grid_bwd3_windowed")
    }
    launches["grid_bwd3"] = {"curvature fit, 2^16": fit["launches"]["grid_bwd3"]}
    launches["grid_fwd_sampled"] = {
        "table-gradient penalty, stochastic": penalties["stochastic_interpolation, rng=generator"]["launches"][
            "grid_fwd_sampled"]}
    log(f"higher orders: phase in {time.perf_counter() - t_phase:.1f} s")
    return {"windowed": win, "third": third, "sampled": samp, "fit": fit, "launches": launches}


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

    t_main = time.perf_counter()
    card = gpu_name_and_limit()
    log(card)
    log(f"device: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    phase_build()
    log(f"build: all {len(KERNELS)} kernel libraries in {time.perf_counter() - t0:.1f} s")
    k1 = phase_kernel1()
    ksh = phase_sh_kernel(card)
    k2 = phase_kernel2(FLAGSHIP_CONFIG)
    own_err = phase_own_table_dtype(FLAGSHIP_CONFIG)
    m, launches, x_flag = phase_slice(FLAGSHIP_CONFIG)
    kb = phase_mlp_backward()
    ka = phase_adam()
    ks = phase_scatter(FLAGSHIP_CONFIG)
    kp = phase_packed(card)
    kg = phase_grid_second_order()
    sdf = phase_sdf(card)

    from tcnn_tpu_torch import load_config

    image = _load_synthetic_image()
    configs = {
        "FLAGSHIP_CONFIG": FLAGSHIP_CONFIG,
        "config_hash_strat_sr_ema.json": load_config(os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "benchmarks", "configs", "config_hash_strat_sr_ema.json")),
    }
    trained = {name: phase_train(name, cfg, card, image) for name, cfg in configs.items()}
    phase_graph(card, configs, image)
    nerf = phase_nerf(card)
    phase_nerf_graph(card)
    samples = {
        "sdf sample": phase_sdf_sample(card),
        "realtime render": phase_realtime_render(card),
        "ray marcher (warm-up + capture)": phase_ray_marcher(card),
        "host sampler training": phase_host_sampler(card, FLAGSHIP_CONFIG),
    }
    par = phase_parallel(card, FLAGSHIP_CONFIG)
    ho = phase_higher_orders(card, FLAGSHIP_CONFIG)
    extras = phase_extras(card, FLAGSHIP_CONFIG, image)
    t = phase_times(card, k1, k2, m, x_flag, kb, ks)
    probes = phase_probes(card)
    phase_floors(card, probes["records"], t, trained["FLAGSHIP_CONFIG"]["profile"], sdf["profile"])
    phase_benches(card)
    check("jax" not in sys.modules and "tcnn_tpu" not in sys.modules, "the port must not import jax")

    # launches: each path's own counts, read right after it ran with the
    # counts at 0: the serving path for the two forward kernels, the first
    # training run for the training kernels, the packed protocol for K7/K8
    # and the SDF fit for the grid's input gradient and double backward
    # (every count was checked > 0 on its path above); the probe run for
    # the three probe kernels and the generic row scatter (the
    # classes of the JAX one-hot and serial scatters: P3's K6 check and P19).
    train = trained["FLAGSHIP_CONFIG"]["launches"]

    def entry(name, source, replaces, launches_, err, which, path, times=None):
        times = times or {"kernel": t[f"{which}_kernel_ms"], "plain": t[f"{which}_plain_ms"],
                          "bound": t["bounds"][which], "library": t.get(f"{which}_library_ms")}
        out = {"name": name, "route": "cuda", "source": f"tcnn_tpu_torch/csrc/{source}", "replaces": replaces,
               "launches": launches_, "max_abs_err": err, "ms": times["kernel"], "plain_ms": times["plain"],
               "bound_ms": times["bound"][0], "bound_by": times["bound"][1], "library_ms": times["library"],
               "path": path}
        if f"{which}_device_ms" in t:
            out["device_ms"] = t[f"{which}_device_ms"]
        return out

    from tcnn_tpu_torch.ops import grid_encode as ge

    kernels = [
        entry("ffmlp_fwd", "ffmlp_fwd.cu", "tcnn_tpu/ops/ffmlp.py:271", launches["ffmlp_fwd"], k1["err"], "k1",
              "serving"),
        entry("grid_fwd", "grid_fwd.cu", "tcnn_tpu/encodings/grid.py:1354", launches["grid_fwd"],
              max(k2["flagship"][3], own_err), "k2", "serving"),
        entry("ffmlp_bwd", "ffmlp_bwd.cu", "tcnn_tpu/ops/ffmlp.py:838", train["ffmlp_bwd"], kb["err"],
              "ffmlp_bwd", "training"),
        entry("ffmlp_bwd_walk", "ffmlp_bwd.cu", "tcnn_tpu/ops/ffmlp.py:838", train["ffmlp_bwd_walk"], kb["err_dx"],
              "ffmlp_bwd_walk", "training"),
        entry("ffmlp_bwd_dw", "ffmlp_bwd.cu", "tcnn_tpu/ops/ffmlp.py:838", train["ffmlp_bwd_dw"], kb["err_dw"],
              "ffmlp_bwd_dw", "training"),
        entry("adam_step", "adam_step.cu", "tcnn_tpu/ops/fused_adam.py:122", train["adam_step"], ka["err"],
              "adam_step", "training"),
        entry("grid_bwd", "grid_bwd.cu", "tcnn_tpu/ops/scatter_rows.py:259", train["grid_bwd"], ks["grid_err"],
              "grid_bwd", "training"),
        entry("grid_fwd_v1", "grid_fwd.cu", "tcnn_tpu/encodings/grid.py:1354", ge.V1_LAUNCHES, k2["v1_err"], None,
              "A/B only (phase 4 bitwise check, phase 13 times; launches: those)", {
                  "kernel": t["lookup_ab"][LOOKUP_SHAPES[1]]["grid_encode_v1"], "plain": t["k2_plain_ms"],
                  "bound": t["bounds"]["k2"], "library": None}),
        entry("scatter_rows", "grid_bwd.cu", "tcnn_tpu/ops/scatter_rows.py:68", probes["launches"]["scatter_rows"],
              max(ks["scatter_err"], probes["errs"]["scatter_rows"]), "scatter_rows", "probes (P3, P19)"),
        entry("ffmlp_fwd_packed", "ffmlp_fwd.cu", "tcnn_tpu/ops/ffmlp.py:422", kp["launches"]["ffmlp_fwd_packed"],
              kp["err_fwd"], None, "packed MLP protocol", dict(kp["fwd"], library=None)),
        entry("ffmlp_bwd_packed", "ffmlp_bwd.cu", "tcnn_tpu/ops/ffmlp.py:557", kp["launches"]["ffmlp_bwd_packed"],
              kp["err_bwd"], None, "packed MLP protocol", dict(kp["bwd"], library=None)),
        entry("grid_bwd_input", "grid_input_grad.cu", "tcnn_tpu/encodings/grid.py:1354", sdf["launches"]["grid_bwd_input"],
              kg["g1"], "grid_bwd_input", "module API (SDF)"),
        entry("grid_bwdbwd", "grid_input_grad.cu", "tcnn_tpu/encodings/grid.py:1354", sdf["launches"]["grid_bwdbwd"],
              kg["g2"], "grid_bwdbwd", "module API (SDF)"),
    ]
    # The SH rows: ms is the cold device time (call_ms beside it); routes:
    # the NeRF run's launches by route for the forward, the check's for the
    # input gradient; the input gradient's and the double backward's
    # launches from the direction-penalty steps.
    sh_rows = [
        entry("sh_encode", "sh_encode.cu", "tcnn_tpu/encodings/spherical_harmonics.py:106",
              nerf["launches"]["sh_encode"], ksh["err_fwd"], None, "NeRF sample", ksh["times"]["fwd"]),
        entry("sh_encode_backward_input", "sh_encode.cu", "tcnn_tpu/encodings/spherical_harmonics.py:106",
              ksh["penalty"]["launches"]["sh_encode_backward_input"], ksh["err_bwd"], None, SH_PENALTY_PATH,
              ksh["times"]["bwd"]),
    ]
    sh_rows.append(entry(
        "sh_encode_backward_backward", "sh_encode.cu", "tcnn_tpu/encodings/spherical_harmonics.py:106",
        ksh["penalty"]["launches"]["sh_encode_backward_backward"], ksh["err_bwdbwd"], None, SH_PENALTY_PATH,
        ksh["times"]["bwdbwd nerf"]))
    sh_rows[0]["routes"] = {"vector": nerf["launches"]["sh_encode vector"],
                            "staged": nerf["launches"]["sh_encode"] - nerf["launches"]["sh_encode vector"]}
    sh_rows[1]["routes"] = {w: ksh["routes"].get(f"backward {w}", 0) for w in ("vector", "staged")}
    for row, what in zip(sh_rows, ("fwd", "bwd", "bwdbwd nerf")):
        row.update(device_ms=ksh["times"][what]["kernel"], call_ms=ksh["times"][what]["call_ms"],
                   warm_device_ms=ksh["times"][what]["warm_ms"])
    sh_rows[2].update(autograd_device_ms=ksh["times"]["bwdbwd nerf"]["autograd_ms"],
                      degree_8_fp32=ksh["times"]["bwdbwd degree 8 fp32"],
                      library_note="none: no PyTorch call differentiates the SH basis twice")
    kernels += sh_rows
    # The grid extras' modes of the lookup and the table gradient; launches
    # from each extra's own path (training_steps with the Rng hash, with
    # fixed_point_pos; the stochastic table gradient from the module-API
    # fit through GridEncoding.apply(rng=generator)), the table gradients'
    # those of their own instantiation (EXTRA_ROUTES).
    ek, ep = extras["kernels"], extras["paths"]
    for name, source, replaces, key, err_key, path, launches_ in (
        ("grid_fwd_rng", "grid_fwd.cu", "tcnn_tpu/encodings/grid.py:89", ("Rng", "fwd"), "Rng fwd",
         "training_steps, hash Rng", ep["Rng"]["launches"]["grid_fwd"]),
        ("grid_bwd_rng", "grid_bwd_rng.cu", "tcnn_tpu/encodings/grid.py:89", ("Rng", "bwd"), "Rng bwd own classes",
         "training_steps, hash Rng", ep["Rng"]["launches"]["grid_bwd_rng"]),
        ("grid_fwd_fixed_point", "grid_fwd.cu", "tcnn_tpu/encodings/grid.py:1580", ("fixed_point_pos", "fwd"),
         "fixed_point_pos fwd", "training_steps, fixed_point_pos", ep["fixed_point_pos"]["launches"]["grid_fwd"]),
        ("grid_bwd_fixed_point", "grid_bwd_modes.cu", "tcnn_tpu/encodings/grid.py:1580", ("fixed_point_pos", "bwd"),
         "fixed_point_pos bwd own classes", "training_steps, fixed_point_pos",
         ep["fixed_point_pos"]["launches"]["grid_bwd_modes"]),
        ("grid_bwd_stochastic", "grid_bwd_modes.cu", "tcnn_tpu/encodings/grid.py:130",
         ("stochastic_interpolation", "bwd"), None, "module API, GridEncoding.apply(rng=generator)",
         ep["stochastic apply"]["launches"]["grid_bwd_modes"]),
    ):
        err = (ek["err"][err_key] if err_key else
               max(v for k, v in ek["err"].items() if k.startswith("stochastic_interpolation bwd")))
        kernels.append(entry(name, source, replaces, launches_, err, None, path, ek["times"][key]))
    # The windowed kernels of table parallelism (csrc/grid_sharded.cu):
    # launches by path, the ranks' counts summed; times at the 3D model's
    # shard 0 of 2.
    for name, which, err in (("grid_fwd_windowed", "fwd", par["err_fwd"]), ("grid_bwd_windowed", "bwd", par["err_bwd"])):
        row = entry(name, "grid_sharded.cu", "tcnn_tpu/parallel/table_parallel.py:137",
                    sum(par["launches"][name].values()), err, None, "table parallel (TableParallelTrainer)",
                    par["times"][which])
        row["launches_by_path"] = par["launches"][name]
        row["library_note"] = "none: a masked gather summed over corners is no single call"
        kernels.append(row)
    # The higher orders' kernels (phase 12g): launches from their own paths
    # (the TP eikonal step's ranks summed; the stochastic table-gradient
    # penalty), times at the 3D model's shard 0 of 2 and the flagship.
    for name, source, replaces, path, err, times in (
        ("grid_bwd_input_windowed", "grid_sharded.cu", "tcnn_tpu/parallel/table_parallel.py:137",
         "higher orders: TP eikonal step", ho["windowed"]["err"]["grid_bwd_input_windowed"],
         ho["windowed"]["times"]["grid_bwd_input_windowed"]),
        ("grid_bwdbwd_windowed", "grid_sharded.cu", "tcnn_tpu/parallel/table_parallel.py:137",
         "higher orders: TP eikonal step", ho["windowed"]["err"]["grid_bwdbwd_windowed"],
         ho["windowed"]["times"]["grid_bwdbwd_windowed"]),
        ("grid_fwd_sampled", "grid_bwd_modes.cu", "tcnn_tpu/encodings/grid.py:145",
         "higher orders: stochastic table-gradient penalty", ho["sampled"]["err"], ho["sampled"]["times"]),
        ("grid_bwd3", "grid_third_order.cu", "tcnn_tpu/encodings/grid.py:1354",
         "higher orders: curvature fit (module API)", ho["third"]["err"]["grid_bwd3"], ho["third"]["times"]["grid_bwd3"]),
        ("grid_bwd3_windowed", "grid_third_order.cu", "tcnn_tpu/parallel/table_parallel.py:137",
         "higher orders: TP curvature step", ho["third"]["err"]["grid_bwd3_windowed"],
         ho["third"]["times"]["grid_bwd3_windowed"]),
    ):
        row = entry(name, source, replaces, sum(ho["launches"][name].values()), err, None, path, times)
        row["launches_by_path"] = ho["launches"][name]
        row["library_note"] = ("none: no PyTorch call differentiates the hash-grid interpolation three times"
                               if name.startswith("grid_bwd3") else
                               "none: no PyTorch call takes a windowed or a one-corner gather")
        kernels.append(row)
    for name, replaces in (("probe_gather", "benchmarks/probe_mosaic_gather.py:63"),
                           ("probe_scatter", "benchmarks/probe_mosaic_gather.py:121"),
                           ("probe_gather_dot", "benchmarks/probe_r5_pallas_gather2.py:348")):
        row = entry(name, "probe_rows.cu", replaces, probes["launches"][name], probes["errs"][name], None, "probes",
                    probes["times"][name])
        for extra in ("device_ms", "tile_sum", "planes", "store_last", "shared_async", "window_copy", "routes"):
            if extra in probes["times"][name]:
                row[extra] = probes["times"][name][extra]
        kernels.append(row)
    # The sample paths' launches join each kernel's own path's.
    for row in kernels:
        if row["name"] in SAMPLE_COUNTERS:
            by_path = {row["path"]: row["launches"]}
            by_path.update({p: r["launches"][row["name"]] for p, r in samples.items() if r["launches"][row["name"]]})
            row["launches_by_path"] = by_path
            row["launches"] = sum(by_path.values())
    log(f"chip_smoke: every phase passed in {time.perf_counter() - t_main:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
