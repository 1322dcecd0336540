"""The port's CUDA kernels against their plain torch versions, on the card.

These tests need an NVIDIA GPU with nvcc; elsewhere they skip. They import
no jax, so on a machine without it run them as

    TCNN_TPU_TEST_BACKEND=gpu python -m pytest tests/test_torch_port_cuda.py -q -m cuda

(the variable keeps tests/conftest.py from importing jax).

Tolerances: the MLP forward as in test_torch_port_ffmlp.py (bf16 outputs;
fp32 sums in another order flip bf16 roundings); the grid lookup in fp32 at
rtol 1e-5, atol 1e-6 (features of magnitude <= 1; only the order of the
corner sum may differ from torch's reduction). The MLP backward: relative
difference (norm) <= 1e-2 and at most 0.1% of the entries beyond 4 bf16
ulps of max |ref| (dW entries are long fp32 sums that cancel, so entrywise
relative errors of small entries mean nothing; a derivative that jumps,
ReLU's at 0 or a bf16 rounding of the recomputed forward, turns an fp32
sum-order difference into an O(1) change of a few entries). Adam: param_steps equal, the rest to rtol 1e-6, atol 1e-7. The
scatter and grid backward, per entry in units of S = sum of |contribution|:
1e-5 S for fp32 accumulation (atomics add in any order); for bf16
accumulation the kernel's error against the fp32 sum of the same rounded
contributions is at most twice the plain sequential sum's, in norm. The
packed MLP kernels (K7/K8) as the MLP forward and backward. The grid's
input gradient and double backward (G1/G2) in fp32: max |diff| <= 1e-5 of
max |plain| and 1e-5 in norm (the same products, sums in another order).
The eikonal gradients through the module API: 1e-2 of the norm (bf16
network). The row gather and scatter probes (ops.probe_rows): gathers, tile
sums, copies and STORE_LAST bit-exact; ADD within 1e-6 of the sum of
|contributions| per entry (fp32 atomics add in any order); the gather-dot
within 1e-5 of max |plain| (the matmul sums in another order).
"""

import numpy as np
import pytest
import torch

import tcnn_tpu_torch as tt
from tcnn_tpu_torch.common import Activation
from tcnn_tpu_torch.encodings import create_encoding
from tcnn_tpu_torch.ops import ffmlp, fused_adam, grid_encode, probe_rows, scatter_rows
from tcnn_tpu_torch.optimizers import AdamOptimizer

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close_bf16(got, want):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    scale = float(want.abs().max())
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7) if scale > 0 else 0.0
    assert float((got - want).abs().max()) <= 4 * ulp


@pytest.mark.parametrize("act", [a for a in Activation])
@pytest.mark.parametrize("n_hidden", [0, 1, 3])
@pytest.mark.parametrize("width", [16, 32, 64, 128])
def test_ffmlp_kernel_matches_plain(dev, width, n_hidden, act):
    gen = torch.Generator(device=dev).manual_seed(width * 10 + n_hidden)
    shapes = [(16, 32)] if n_hidden == 0 else [(width, 32)] + [(width, width)] * (n_hidden - 1) + [(16, width)]
    gain = 0.5 if act == Activation.Exponential else 2.0
    ws = [((torch.rand(s, generator=gen, device=dev) * 2 - 1) * gain / s[1] ** 0.5).bfloat16() for s in shapes]
    for batch in (1, 17, 1000):
        x = (torch.rand((batch, 32), generator=gen, device=dev) * 2 - 1).bfloat16()
        before = ffmlp.LAUNCHES
        got = ffmlp.ffmlp_forward(x, ws, act, Activation.Tanh)
        assert ffmlp.LAUNCHES == before + 1
        _close_bf16(got, ffmlp.ffmlp_forward_plain(x, ws, act, Activation.Tanh))


def _close_bf16_backward(got, want):
    got, want = got.float(), want.float()
    assert got.shape == want.shape and torch.isfinite(got).all()
    diff = (got - want).abs()
    assert float(diff.norm()) <= 1e-2 * float(want.norm())
    scale = float(want.abs().max())
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7) if scale > 0 else 0.0
    assert float((diff > 4 * ulp).float().mean()) <= 1e-3


def test_ffmlp_kernel_refuses_grad(dev):
    """The fused forward takes tensors that need a gradient: through
    ``FfmlpFunction`` the backward kernel runs and matches the plain
    backward."""
    gen = torch.Generator(device=dev).manual_seed(3)
    ws = [((torch.rand(s, generator=gen, device=dev) * 2 - 1) * 0.3).bfloat16().requires_grad_(True)
          for s in ((64, 32), (64, 64), (16, 64))]
    x = (torch.rand((777, 32), generator=gen, device=dev) * 2 - 1).bfloat16().requires_grad_(True)
    before = (ffmlp.LAUNCHES, ffmlp.BWD_LAUNCHES)
    y = ffmlp.FfmlpFunction.apply(x, Activation.ReLU, Activation.NONE, False, *ws)
    g = (torch.rand(y.shape, generator=gen, device=dev) * 2 - 1).bfloat16()
    grads = torch.autograd.grad(y, (x, *ws), g)
    assert (ffmlp.LAUNCHES, ffmlp.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    dx, dws = ffmlp.ffmlp_backward_plain(x.detach(), g, [w.detach() for w in ws], Activation.ReLU, Activation.NONE)
    for a, b in zip(grads, (dx, *dws)):
        _close_bf16_backward(a, b)


@pytest.mark.parametrize("act", [Activation.ReLU, Activation.Sigmoid, Activation.Sine, Activation.Tanh])
@pytest.mark.parametrize("n_hidden", [0, 1, 3])
@pytest.mark.parametrize("width", [16, 32, 64, 128])
def test_ffmlp_backward_kernel_matches_plain(dev, width, n_hidden, act):
    gen = torch.Generator(device=dev).manual_seed(width * 10 + n_hidden)
    shapes = [(16, 32)] if n_hidden == 0 else [(width, 32)] + [(width, width)] * (n_hidden - 1) + [(16, width)]
    ws = [((torch.rand(s, generator=gen, device=dev) * 2 - 1) * 2 / s[1] ** 0.5).bfloat16() for s in shapes]
    for batch in (1, 17, 1000):
        x = (torch.rand((batch, 32), generator=gen, device=dev) * 2 - 1).bfloat16()
        g = (torch.rand((batch, 16), generator=gen, device=dev) * 2 - 1).bfloat16()
        before = ffmlp.BWD_LAUNCHES
        dx, dws = ffmlp.ffmlp_backward(x, g, ws, act, Activation.Tanh)
        assert ffmlp.BWD_LAUNCHES == before + 1
        want_dx, want_dws = ffmlp.ffmlp_backward_plain(x, g, ws, act, Activation.Tanh)
        _close_bf16_backward(dx, want_dx)
        for a, b in zip(dws, want_dws):
            _close_bf16_backward(a, b)


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


@pytest.mark.parametrize("hp", ADAM_KNOBS, ids=[str(sorted(k)) for k in ADAM_KNOBS])
def test_adam_kernel_matches_plain(dev, hp):
    n, n_matrix = 100_003, 7168
    opt = AdamOptimizer(hp)
    opt.allocate(n, [(1, n_matrix)])
    rng = np.random.default_rng(len(hp))
    p0 = torch.from_numpy(rng.normal(0, 0.3, n).astype(np.float32)).to(dev)
    sk, sp, pk, pp = opt.init_state(dev), opt.init_state(dev), p0.clone(), p0.clone()
    for _ in range(3):
        g = rng.normal(0, 1, n).astype(np.float32) * 128
        g[n_matrix:][rng.random(n - n_matrix) < 0.1] = 0.0
        g = torch.from_numpy(g).to(dev)
        sp, pp = opt.step(sp, pp, g, 128.0, plain=True)
        before = fused_adam.LAUNCHES
        sk, pk2 = opt.step(sk, pk, g, 128.0)
        assert pk2 is pk and fused_adam.LAUNCHES == before + 1
    assert int(sk["step"]) == int(sp["step"]) == 3
    assert torch.equal(sk["param_steps"], sp["param_steps"])
    for a, b in ((pk, pp), (sk["first_moments"], sp["first_moments"]), (sk["second_moments"], sp["second_moments"])):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


SCATTER_CLASSES = [
    (scatter_rows.CONTRIB_NONE, torch.float32), (scatter_rows.CONTRIB_SR, torch.float32),
    (scatter_rows.CONTRIB_RN, torch.bfloat16), (scatter_rows.CONTRIB_SR, torch.bfloat16),
]


def _check_class(got, plain, exact, S, acc_dtype):
    assert got.shape == plain.shape and torch.isfinite(got).all()
    if acc_dtype == torch.float32:
        assert bool(((got - plain).abs() <= 1e-5 * S + 1e-30).all())
    else:
        assert float((got - exact).norm()) <= 2 * float((plain - exact).norm()) + 1e-6 * float(S.norm())


@pytest.mark.parametrize("cls", SCATTER_CLASSES, ids=str)
def test_scatter_kernel_matches_plain(dev, cls):
    contrib, acc = cls
    rng = np.random.default_rng(5)
    idx = torch.from_numpy(rng.integers(0, 64, 100_000).astype(np.int32)).to(dev)
    rows = torch.from_numpy(rng.normal(0, 1, (100_000, 4)).astype(np.float32)).to(dev)
    before = scatter_rows.LAUNCHES
    got = scatter_rows.scatter_rows(idx, rows, 64, contrib, acc)
    assert scatter_rows.LAUNCHES == before + 1
    plain = scatter_rows.scatter_rows_plain(idx, rows, 64, contrib, acc)
    exact = scatter_rows.scatter_rows_plain(idx, rows, 64, contrib, torch.float32)
    _check_class(got, plain, exact, scatter_rows.scatter_rows_plain(idx, rows.abs(), 64), acc)
    # Small integers are exact in bf16 in any order: bitwise equal.
    ints = torch.from_numpy(rng.integers(-2, 3, (100_000, 4)).astype(np.float32)).to(dev)
    idx2 = torch.from_numpy(rng.integers(0, 2**14, 100_000).astype(np.int32)).to(dev)
    assert torch.equal(scatter_rows.scatter_rows(idx2, ints, 2**14, contrib, acc),
                       scatter_rows.scatter_rows_plain(idx2, ints, 2**14, contrib, acc))


@pytest.mark.parametrize("cls", SCATTER_CLASSES, ids=str)
def test_grid_backward_kernel_matches_plain(dev, cls):
    contrib, acc = cls
    enc = create_encoding(2, GRID, alignment=16)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.uniform(-0.2, 1.2, (50_000, 2)).astype(np.float32)).to(dev)
    dy = torch.from_numpy(rng.normal(0, 1, (50_000, 16)).astype(np.float32)).to(dev).bfloat16()
    levels = enc._levels_on(x.device)
    acc_code = scatter_rows.ACC_BF16 if acc == torch.bfloat16 else scatter_rows.ACC_F32
    classes = torch.tensor([[contrib, acc_code]] * enc.n_levels, dtype=torch.int32, device=dev)
    before = grid_encode.BWD_LAUNCHES
    got = grid_encode.grid_backward(x, dy, levels, 2, grid_encode.INTERP_LINEAR, classes)
    assert grid_encode.BWD_LAUNCHES == before + 1
    plain = grid_encode.grid_backward_plain(x, dy, levels, 2, grid_encode.INTERP_LINEAR, classes)
    f32 = classes.clone()
    f32[:, 1] = scatter_rows.ACC_F32
    exact = grid_encode.grid_backward_plain(x, dy, levels, 2, grid_encode.INTERP_LINEAR, f32)
    S = grid_encode.grid_backward_plain(x, dy.float().abs(), levels, 2, grid_encode.INTERP_LINEAR, f32 * 0)
    _check_class(got, plain, exact, S, acc)
    assert not got[S == 0].any()


def test_training_step_kernel_matches_plain(dev):
    cfg = {"encoding": dict(GRID, scatter_strategy="factored_sr"),
           "network": {"otype": "FullyFusedMLP", "n_neurons": 64, "n_hidden_layers": 2},
           "optimizer": {"otype": "EMA", "decay": 0.99, "nested": {"otype": "Adam", "learning_rate": 1e-2}}}
    a, b = tt.create_from_config(2, 3, cfg, device=dev), tt.create_from_config(2, 3, cfg, device=dev)
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 1, (4096, 2)).astype(np.float32)
    y = rng.uniform(0, 1, (4096, 3)).astype(np.float32)
    counts = (ffmlp.LAUNCHES, ffmlp.BWD_LAUNCHES, grid_encode.LAUNCHES, grid_encode.BWD_LAUNCHES, fused_adam.LAUNCHES)
    la = a.training_step(x, y)
    after = (ffmlp.LAUNCHES, ffmlp.BWD_LAUNCHES, grid_encode.LAUNCHES, grid_encode.BWD_LAUNCHES, fused_adam.LAUNCHES)
    assert all(n == c + 1 for n, c in zip(after, counts))
    lb = b.trainer.training_step_plain(x, y)
    assert la.is_cuda and la.dim() == 0
    torch.testing.assert_close(la, lb, rtol=1e-4, atol=0)
    d = (a.params - b.params).abs()
    assert float(d.max()) <= 2.0001e-2 and float((d > 1e-6).float().mean()) <= 1e-2


GRID = {
    "otype": "HashGrid", "n_levels": 8, "n_features_per_level": 2,
    "log2_hashmap_size": 8, "base_resolution": 4, "per_level_scale": 1.5,
    "hash": "CoherentAdditive", "gather_strategy": "stratified", "strata": 16,
}


@pytest.mark.parametrize("n_dims", [1, 2, 3, 4])
@pytest.mark.parametrize("over", [
    {}, {"hash": "Prime"}, {"hash": "CoherentPrime"}, {"hash": "ReversedPrime"},
    {"hash": "BaseConvert"}, {"gather_strategy": "per_level"}, {"interpolation": "Smoothstep"},
    {"interpolation": "Nearest"}, {"table_dtype": "float16"}, {"table_dtype": "bfloat16"},
    {"n_features_per_level": 4, "n_levels": 4}, {"n_features_per_level": 1},
], ids=str)
def test_grid_kernel_matches_plain(dev, n_dims, over):
    enc = create_encoding(n_dims, dict(GRID, **over), alignment=16)
    enc.output_dtype = torch.float32
    rng = np.random.default_rng(n_dims)
    x = torch.from_numpy(rng.uniform(-0.5, 1.5, (3001, n_dims)).astype(np.float32)).to(dev)
    params = torch.from_numpy(rng.uniform(-1, 1, enc.n_params).astype(np.float32)).to(dev)
    before = grid_encode.LAUNCHES
    got = enc.apply(params, x)
    assert grid_encode.LAUNCHES == before + 1
    want = enc.apply_plain(params, x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_model_inference_goes_through_both_kernels(dev):
    m = tt.create_from_config(2, 3, {"encoding": GRID, "network": {"otype": "FullyFusedMLP", "n_neurons": 64,
                                                                   "n_hidden_layers": 2}}, device=dev)
    before = (ffmlp.LAUNCHES, grid_encode.LAUNCHES)
    y = m.inference(np.random.default_rng(0).uniform(0, 1, (513, 2)).astype(np.float32))
    assert y.shape == (513, 3) and y.dtype == torch.float32 and y.is_cuda
    assert (ffmlp.LAUNCHES, grid_encode.LAUNCHES) == (before[0] + 1, before[1] + 1)
    # With gradients enabled the same forward is differentiable.
    out = m.model(torch.rand((4, 2), device=dev))
    assert out.requires_grad and out.shape == (4, 16)


@pytest.mark.parametrize("n_hidden", [0, 3])
@pytest.mark.parametrize("width", [16, 32, 64])
def test_packed_kernels_match_plain(dev, width, n_hidden):
    """K7/K8 (the fused kernels on the compact view of the packed rows)
    against the block-diagonal plain versions; 1000 samples is no multiple
    of a tile."""
    G = 128 // width
    gen = torch.Generator(device=dev).manual_seed(width + n_hidden)
    shapes = [(width, width)] * (n_hidden + 1)
    ws = [((torch.rand(s, generator=gen, device=dev) * 2 - 1) / s[1] ** 0.5).bfloat16() for s in shapes]
    xp = torch.randn((1000 // G, 128), generator=gen, device=dev).bfloat16()
    gp = (torch.rand(xp.shape, generator=gen, device=dev) * 2 - 1).bfloat16()
    relu, none = Activation.ReLU, Activation.NONE
    before = (ffmlp.PACKED_LAUNCHES, ffmlp.PACKED_BWD_LAUNCHES)
    y = ffmlp.ffmlp_forward_packed(xp, ws, relu, none)
    dx, dws = ffmlp.ffmlp_backward_packed(xp, gp, ws, relu, none)
    assert (ffmlp.PACKED_LAUNCHES, ffmlp.PACKED_BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    _close_bf16(y, ffmlp.ffmlp_forward_packed_plain(xp, ws, relu, none))
    dx_p, dws_p = ffmlp.ffmlp_backward_packed_plain(xp, gp, ws, relu, none)
    for a, b in zip((dx, *dws), (dx_p, *dws_p)):
        _close_bf16_backward(a, b)


GRID3D = {
    "otype": "HashGrid", "n_levels": 8, "n_features_per_level": 2, "log2_hashmap_size": 14,
    "base_resolution": 8, "per_level_scale": 1.5, "hash": "CoherentAdditive",
}


def _close_f32(got, want):
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max()) + 1e-30
    assert float((got - want).norm()) <= 1e-5 * float(want.norm())


@pytest.mark.parametrize("over", [
    {}, {"interpolation": "Smoothstep"}, {"table_dtype": "bfloat16"}, {"scatter_strategy": "factored_sr"},
    {"hash": "CoherentPrime"}, {"interpolation": "Nearest"},
], ids=str)
@pytest.mark.parametrize("n_dims", [2, 3])
def test_grid_input_gradient_and_double_backward_match_plain(dev, n_dims, over):
    """G1 and G2 against their plain versions (fp32: the same products,
    sums in another order; the table-gradient scatter of an fp32 class
    within 1e-5 of max |plain|), with and without a table-gradient
    cotangent."""
    from tcnn_tpu_torch.encodings.grid import _INTERP_CODES

    enc = create_encoding(n_dims, dict(GRID3D, **over), alignment=16)
    rng = np.random.default_rng(n_dims)
    n = 20_000
    x = torch.from_numpy(rng.uniform(-0.2, 1.2, (n, n_dims)).astype(np.float32)).to(dev)
    params = torch.from_numpy(rng.uniform(-1, 1, enc.n_params).astype(np.float32)).to(dev)
    dy = torch.from_numpy(rng.normal(0, 1, (n, 16)).astype(np.float32)).to(dev).bfloat16()
    cgx = torch.from_numpy(rng.normal(0, 1, (n, n_dims)).astype(np.float32)).to(dev)
    cgp = torch.from_numpy(rng.normal(0, 1, enc.n_params).astype(np.float32)).to(dev)
    classes = torch.from_numpy(enc.gradient_classes(n)).to(dev)
    assert not (classes[:, 1] == scatter_rows.ACC_BF16).any()
    args = (enc._levels_on(dev), 2, _INTERP_CODES[enc.interpolation_type])
    before = (grid_encode.INPUT_LAUNCHES, grid_encode.BWDBWD_LAUNCHES)
    dx = grid_encode.grid_backward_input(x, dy, params, *args)
    _close_f32(dx, grid_encode.grid_backward_input_plain(x, dy, params, *args))
    for cp in (cgp, None):
        got = grid_encode.grid_backward_backward(x, dy, params, *args, classes, cp, cgx)
        want = grid_encode.grid_backward_backward_plain(x, dy, params, *args, classes, cp, cgx)
        for a, b in zip(got, want):
            _close_f32(a, b)
    assert (grid_encode.INPUT_LAUNCHES, grid_encode.BWDBWD_LAUNCHES) == (before[0] + 1, before[1] + 2)


def test_module_second_order_matches_plain(dev):
    """The eikonal term through modules.NetworkWithInputEncoding on the
    card: G1, G2, K1 and K2 run, and the gradients match the plain path
    (bf16 network: 1e-2 of the norm)."""
    from tcnn_tpu_torch import modules

    m = modules.NetworkWithInputEncoding(3, 1, GRID3D, {"otype": "FullyFusedMLP", "n_neurons": 64,
                                                        "n_hidden_layers": 2})
    assert m.params.is_cuda
    x0 = torch.rand((5000, 3), device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    grads = []
    counts = (grid_encode.INPUT_LAUNCHES, grid_encode.BWDBWD_LAUNCHES, ffmlp.LAUNCHES, ffmlp.BWD_LAUNCHES)
    for f_of in (m, lambda xx: m.apply_plain(m.params, xx)[:, :1].float()):
        m.params.grad = None
        x = x0.clone().requires_grad_(True)
        f = f_of(x)
        (g,) = torch.autograd.grad(f, x, torch.ones_like(f), create_graph=True)
        (f.square().mean() + ((g.norm(dim=1) - 1) ** 2).mean()).backward()
        grads.append((m.params.grad.clone(), x.grad.clone()))
    after = (grid_encode.INPUT_LAUNCHES, grid_encode.BWDBWD_LAUNCHES, ffmlp.LAUNCHES, ffmlp.BWD_LAUNCHES)
    assert all(a > b for a, b in zip(after, counts))
    for a, b in zip(*grads):
        assert torch.isfinite(a).all()
        assert float((a - b).norm()) <= 1e-2 * float(b.norm())


def test_ffmlp_width128_depth5_matches_plain(dev):
    """bench_image's network: 128-wide input, FullyFusedMLP 128 x 5 hidden
    layers (K1 runs with fewer warps a block, K2's walk reads the weights
    through L2), forward and backward against the plain versions."""
    gen = torch.Generator(device=dev).manual_seed(128)
    shapes = [(128, 128)] * 5 + [(16, 128)]
    ws = [((torch.rand(s, generator=gen, device=dev) * 2 - 1) * 2 / s[1] ** 0.5).bfloat16() for s in shapes]
    for batch in (1, 1000, 2**17):
        x = (torch.rand((batch, 128), generator=gen, device=dev) * 2 - 1).bfloat16()
        g = (torch.rand((batch, 16), generator=gen, device=dev) * 2 - 1).bfloat16()
        before = (ffmlp.LAUNCHES, ffmlp.BWD_LAUNCHES)
        y = ffmlp.ffmlp_forward(x, ws, Activation.ReLU, Activation.NONE)
        dx, dws = ffmlp.ffmlp_backward(x, g, ws, Activation.ReLU, Activation.NONE)
        assert (ffmlp.LAUNCHES, ffmlp.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
        _close_bf16(y, ffmlp.ffmlp_forward_plain(x, ws, Activation.ReLU, Activation.NONE))
        want_dx, want_dws = ffmlp.ffmlp_backward_plain(x, g, ws, Activation.ReLU, Activation.NONE)
        _close_bf16_backward(dx, want_dx)
        for a, b in zip(dws, want_dws):
            _close_bf16_backward(a, b)


PROBE_SOURCES = {
    "l2": (probe_rows.SOURCE_L2, {}), "l2x8": (probe_rows.SOURCE_L2, {"unroll": 8}),
    "shared": (probe_rows.SOURCE_SHARED, {}), "async16": (probe_rows.SOURCE_ASYNC, {"in_flight": 16}),
    "async64": (probe_rows.SOURCE_ASYNC, {"in_flight": 64}),
}


def _probe_inputs(dev, S, F, B, seed, lo=0, hi=None):
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.standard_normal((S, F)).astype(np.float32)).to(dev)
    idx = torch.from_numpy(rng.integers(lo, S if hi is None else hi, B).astype(np.int32)).to(dev)
    return table, idx


@pytest.mark.parametrize("F", [1, 2, 3, 4, 8, 128])
@pytest.mark.parametrize("source", list(PROBE_SOURCES))
def test_probe_gather_sources_match_plain(dev, source, F):
    """MODE_ROW from every source, rows outside the table reading zeros,
    rounded and feature-major variants: bit-exact. SHARED takes a table
    that fits a block (256 rows at F = 128)."""
    code, kw = PROBE_SOURCES[source]
    S = 4096 if probe_rows.fits_shared(4096 * F) else 256
    table, idx = _probe_inputs(dev, S, F, 2**16 + 2048, F, lo=-50, hi=S + 50)
    for flags in (0, probe_rows.FLAG_ROUND_BF16, probe_rows.FLAG_FEATURE_MAJOR):
        before = probe_rows.GATHER_LAUNCHES
        got = probe_rows.probe_gather(table, idx, source=code, flags=flags, **kw)
        assert probe_rows.GATHER_LAUNCHES == before + 1
        assert torch.equal(got, probe_rows.probe_gather_plain(table, idx, flags=flags))


def _offset_by_one(t):
    """A copy of ``t`` whose data pointer lies 4 bytes past 16-byte
    alignment (a view one element into a larger buffer)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("F", [2, 4, 8])
@pytest.mark.parametrize("source", list(PROBE_SOURCES))
def test_probe_gather_unaligned_table_takes_the_scalar_form(dev, source, F):
    """A table (and indices) 4 bytes off 16-byte alignment: the plan takes
    scalar loads (vec 1), and the rows still match, with rows outside the
    table reading zeros."""
    code, kw = PROBE_SOURCES[source]
    table, idx = _probe_inputs(dev, 1024, F, 2**15 + 4, F + 40, lo=-7, hi=1024 + 7)
    table, idx = _offset_by_one(table), _offset_by_one(idx)
    assert probe_rows.alignment(table) == 4 and probe_rows.alignment(idx) == 4
    plan = probe_rows.gather_plan(idx.shape[0], 1024, F, probe_rows.MODE_ROW, code, 0, 4, 4,
                                  unroll=kw.get("unroll"), in_flight=kw.get("in_flight", 64))
    assert plan.vec == 1
    got = probe_rows.probe_gather(table, idx, source=code, **kw)
    assert torch.equal(got, probe_rows.probe_gather_plain(table, idx))


@pytest.mark.parametrize("unroll", [None, 1, 8])
@pytest.mark.parametrize("B", [1, 3, 7, 2**16 + 3])
def test_probe_gather_rows_not_a_multiple_of_the_rows_a_thread(dev, B, unroll):
    """B rows that leave the last warp's group of 32 x unroll rows short;
    F = 2 and 8 (the fixed-F paths) and 3 (the chunk loop); two tables (odd
    rows from the second)."""
    for F in (2, 3, 8):
        table, idx = _probe_inputs(dev, 4096, F, B, B + F, lo=-20, hi=4096 + 20)
        got = probe_rows.probe_gather(table, idx, unroll=unroll)
        assert torch.equal(got, probe_rows.probe_gather_plain(table, idx))
        t2 = table + 1.0
        assert torch.equal(probe_rows.probe_gather(table, idx, unroll=unroll, table2=t2),
                           probe_rows.probe_gather_plain(table, idx, table2=t2))


@pytest.mark.parametrize("F", [1, 3, 5, 8, 128])
def test_probe_gather_lanes_match_plain(dev, F):
    """LANE (4 lanes a thread): F = 128 and 8 take the int4 / float4 form,
    odd F and F = 1 the scalar one; indices outside the table read zeros;
    rounded, transposed and feature-major variants too."""
    pr = probe_rows
    rng = np.random.default_rng(F)
    S, B = 300, 2 * pr.TILE
    table = torch.from_numpy(rng.standard_normal((S, F)).astype(np.float32)).to(dev)
    idx = torch.from_numpy(rng.integers(-5, S + 5, (B, F)).astype(np.int32)).to(dev)
    assert pr.gather_plan(B, S, F, pr.MODE_LANE).vec == (4 if F % 4 == 0 else 1)
    for flags in (0, pr.FLAG_ROUND_BF16, pr.FLAG_FEATURE_MAJOR):
        got = pr.probe_gather(table, idx, mode=pr.MODE_LANE, flags=flags)
        assert torch.equal(got, pr.probe_gather_plain(table, idx, pr.MODE_LANE, flags=flags))
    t_t = table.t().contiguous()
    got = pr.probe_gather(t_t, idx, mode=pr.MODE_LANE, flags=pr.FLAG_TRANSPOSED)
    assert torch.equal(got, pr.probe_gather_plain(t_t, idx, pr.MODE_LANE, flags=pr.FLAG_TRANSPOSED))
    odd = _offset_by_one(idx)
    assert torch.equal(pr.probe_gather(table, odd, mode=pr.MODE_LANE), pr.probe_gather_plain(table, odd, pr.MODE_LANE))


@pytest.mark.parametrize("mode", ["lane", "window", "window_aligned", "tile_sum", "copy", "two_tables",
                                  "transposed"])
def test_probe_gather_modes_match_plain(dev, mode):
    pr = probe_rows
    table, idx = _probe_inputs(dev, 4096, 8, 2**15, 11)
    kw = {
        "lane": {"mode": pr.MODE_LANE}, "window": {"mode": pr.MODE_WINDOW},
        "window_aligned": {"mode": pr.MODE_WINDOW, "flags": pr.FLAG_ALIGNED}, "tile_sum": {"mode": pr.MODE_TILE_SUM},
        "copy": {"mode": pr.MODE_COPY}, "two_tables": {"table2": table + 1.0},
        "transposed": {"flags": pr.FLAG_TRANSPOSED | pr.FLAG_FEATURE_MAJOR},
    }[mode]
    if mode == "lane":
        idx = torch.randint(0, 4096, (2**12, 8), device=dev, dtype=torch.int32)
    if mode == "transposed":
        table = table.t().contiguous()
    got = pr.probe_gather(table, idx, **kw)
    assert torch.equal(got, pr.probe_gather_plain(table, idx, **kw))


@pytest.mark.parametrize("acc", [probe_rows.ACC_GLOBAL, probe_rows.ACC_SHARED])
@pytest.mark.parametrize("S", [64, 4096])
def test_probe_scatter_add_matches_plain(dev, S, acc):
    """ADD, rows outside the table skipped; with ACC_SHARED the plan
    privatises at S = 64 (2,048 rows a slot) and not at S = 4096 (32)."""
    rng = np.random.default_rng(S)
    idx = torch.from_numpy(rng.integers(-3, S + 3, 2**17).astype(np.int32)).to(dev)
    rows = torch.from_numpy(rng.normal(0, 1, (2**17, 8)).astype(np.float32)).to(dev)
    plan = probe_rows.scatter_plan(2**17, S, 8, acc, torch.cuda.get_device_properties(dev).multi_processor_count)
    assert (plan.private > 0) == (acc == probe_rows.ACC_SHARED and S == 64)
    before = probe_rows.SCATTER_LAUNCHES
    got = probe_rows.probe_scatter(idx, rows, S, probe_rows.OP_ADD, acc)
    assert probe_rows.SCATTER_LAUNCHES == before + 1
    want = probe_rows.probe_scatter_plain(idx, rows, S)
    S_abs = probe_rows.probe_scatter_plain(idx, rows.abs(), S)
    assert bool(((got - want).abs() <= 1e-6 * S_abs).all())


@pytest.mark.parametrize("acc", [probe_rows.ACC_GLOBAL, probe_rows.ACC_SHARED])
@pytest.mark.parametrize("R", [1, 2, 3, 4, 8, 128])
def test_probe_scatter_add_row_widths(dev, R, acc):
    """ADD at every vector width (R = 1, 3: scalar; 2: float2; 4, 8, 128:
    float4, 1-32 threads a row), N = 0, 7 and 2^16 + 3 rows with indices
    outside the table, and rows 4 bytes off 16-byte alignment (scalar)."""
    S = 64
    rng = np.random.default_rng(R)
    for N in (0, 7, 2**16 + 3):
        idx = torch.from_numpy(rng.integers(-3, S + 3, N).astype(np.int32)).to(dev)
        rows = torch.from_numpy(rng.normal(0, 1, (N, R)).astype(np.float32)).to(dev)
        for r in (rows, _offset_by_one(rows)):
            got = probe_rows.probe_scatter(idx, r, S, probe_rows.OP_ADD, acc)
            want = probe_rows.probe_scatter_plain(idx, r, S)
            S_abs = probe_rows.probe_scatter_plain(idx, r.abs(), S)
            assert got.shape == (S, R) and bool(((got - want).abs() <= 1e-6 * S_abs).all())


@pytest.mark.parametrize("R", [2, 3, 8])
def test_probe_scatter_store_last_is_the_last_write(dev, R):
    rng = np.random.default_rng(3)
    idx = torch.from_numpy(rng.integers(-2, 5000, 2**16).astype(np.int32)).to(dev)
    rows = torch.from_numpy(rng.normal(0, 1, (2**16, R)).astype(np.float32)).to(dev)
    got = probe_rows.probe_scatter(idx, rows, 4096, probe_rows.OP_STORE_LAST)
    assert torch.equal(got, probe_rows.probe_scatter_plain(idx, rows, 4096, probe_rows.OP_STORE_LAST))


def test_probe_gather_dot_matches_plain(dev):
    torch.backends.cuda.matmul.allow_tf32 = False
    table, idx = _probe_inputs(dev, 2**15, 8, 2**15, 4, lo=-5)
    w = torch.randn((8, probe_rows.DOT_COLS), device=dev)
    before = probe_rows.DOT_LAUNCHES
    got = probe_rows.probe_gather_dot(table, idx, w)
    assert probe_rows.DOT_LAUNCHES == before + 1
    want = probe_rows.probe_gather_dot_plain(table, idx, w)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_probe_wrappers_refuse_what_the_kernels_do_not_take(dev):
    """SHARED raises for a table beyond a block's shared memory (no quiet
    L2 fallback), and so does a shared scatter accumulator."""
    table, idx = _probe_inputs(dev, 2**15, 8, 1024, 0)
    with pytest.raises(ValueError, match="shared memory"):
        probe_rows.probe_gather(table, idx, source=probe_rows.SOURCE_SHARED)
    with pytest.raises(ValueError, match="shared accumulator"):
        probe_rows.probe_scatter(idx, table[:1024].contiguous(), 2**15, probe_rows.OP_ADD, probe_rows.ACC_SHARED)
    with pytest.raises(ValueError, match="MODE_ROW"):
        probe_rows.probe_gather(table, idx, mode=probe_rows.MODE_WINDOW, source=probe_rows.SOURCE_ASYNC)


def _backward_case(dev, shapes, batch, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    ws = [((torch.rand(s, generator=gen, device=dev) * 2 - 1) * 2 / s[1] ** 0.5).bfloat16() for s in shapes]
    x = (torch.rand((batch, shapes[0][1]), generator=gen, device=dev) * 2 - 1).bfloat16()
    g = (torch.rand((batch, shapes[-1][0]), generator=gen, device=dev) * 2 - 1).bfloat16()
    return x, g, ws


K2_SHAPES = {
    "flagship": [(64, 32), (64, 64), (16, 64)],
    "w128x5_in128": [(128, 128)] * 5 + [(16, 128)],
    "bench_mlp_w128": [(128, 128)] * 4,
    "no_hidden": [(16, 32)],
}


@pytest.mark.parametrize("batch", [0, 1, 17, 1000])
@pytest.mark.parametrize("shape", sorted(K2_SHAPES))
def test_ffmlp_backward_walk_and_weight_grad_match_plain(dev, shape, batch):
    """The new K2: the walk (skipped for an empty batch) and the split-K
    weight gradient with its reduce launch, and the result matches the plain
    backward; an empty batch gives zero dW."""
    x, g, ws = _backward_case(dev, K2_SHAPES[shape], batch, batch + len(shape))
    before = (ffmlp.BWD_LAUNCHES, ffmlp.WALK_LAUNCHES, ffmlp.DW_LAUNCHES)
    dx, dws = ffmlp.ffmlp_backward(x, g, ws, Activation.Sigmoid, Activation.NONE)
    torch.cuda.synchronize()
    assert (ffmlp.BWD_LAUNCHES, ffmlp.WALK_LAUNCHES, ffmlp.DW_LAUNCHES) == (
        before[0] + 1, before[1] + (batch > 0), before[2] + 1)
    want_dx, want_dws = ffmlp.ffmlp_backward_plain(x, g, ws, Activation.Sigmoid, Activation.NONE)
    assert dx.shape == x.shape
    if batch == 0:
        assert all(d.shape == w.shape and not d.any() for d, w in zip(dws, ws))
        return
    _close_bf16_backward(dx, want_dx)
    for a, b in zip(dws, want_dws):
        _close_bf16_backward(a, b)


@pytest.mark.parametrize("shape", ["flagship", "w128x5_in128", "packed_w64"])
def test_ffmlp_backward_is_deterministic(dev, shape):
    """Two calls on the same inputs give the same bits (no atomics; the
    partials are summed in split order), also for K8 at w64."""
    if shape == "packed_w64":
        x, g, ws = _backward_case(dev, [(64, 64)] * 4, 100_003 * 2, 3)
        xp, gp = x.view(-1, 128), g.view(-1, 128)
        runs = [ffmlp.ffmlp_backward_packed(xp, gp, ws, Activation.ReLU, Activation.NONE) for _ in range(2)]
    else:
        x, g, ws = _backward_case(dev, K2_SHAPES[shape], 100_003, 4)
        runs = [ffmlp.ffmlp_backward(x, g, ws, Activation.Sine, Activation.NONE) for _ in range(2)]
    (dx1, dw1), (dx2, dw2) = runs
    assert torch.equal(dx1, dx2) and all(torch.equal(a, b) for a, b in zip(dw1, dw2))


@pytest.mark.parametrize("shape", sorted(K2_SHAPES))
def test_atomic_backward_kernel_matches_the_new_one(dev, shape):
    """The earlier atomic kernel, kept for chip_smoke.py's A/B timing, against the new
    K2 and the plain backward (tolerance of the MLP backward)."""
    x, g, ws = _backward_case(dev, K2_SHAPES[shape], 2**17 + 5, 5)
    before = ffmlp.ATOMIC_LAUNCHES
    old = ffmlp._ffmlp_backward_atomic(x, g, ws, Activation.ReLU, Activation.NONE)
    assert ffmlp.ATOMIC_LAUNCHES == before + 1
    new = ffmlp.ffmlp_backward(x, g, ws, Activation.ReLU, Activation.NONE)
    plain = ffmlp.ffmlp_backward_plain(x, g, ws, Activation.ReLU, Activation.NONE)
    for a, b, c in zip((old[0], *old[1]), (new[0], *new[1]), (plain[0], *plain[1])):
        _close_bf16_backward(a, c)
        _close_bf16_backward(b, c)
        _close_bf16_backward(a, b)


# The table gradient (tcnn_grid_backward: level-major tiles, privatised
# coarse levels, merged runs, vector atomics) against its plain version,
# level by level in the level's class (``_check_levels``).
FLAGSHIP_GRID = {
    "otype": "HashGrid", "n_levels": 16, "n_features_per_level": 2, "log2_hashmap_size": 15,
    "base_resolution": 16, "per_level_scale": 1.5, "hash": "CoherentAdditive", "gather_strategy": "stratified",
}
ENC3D_GRID = {"otype": "HashGrid", "n_levels": 16, "n_features_per_level": 2, "log2_hashmap_size": 19,
              "base_resolution": 16, "per_level_scale": 1.5, "hash": "CoherentAdditive"}


def _check_levels(enc, got, x, dy, classes):
    """Per level: fp32 sums within 1e-5 of the sum of |contributions| per
    entry; bf16 sums at most twice the plain sequential sum's error against
    the fp32 sum of the same rounded contributions, in norm. Entries no
    sample touched are exactly 0."""
    levels, F, interp = enc._levels_on(x.device), enc.n_features_per_level, _interp_code(enc)
    plain = grid_encode.grid_backward_plain(x, dy, levels, F, interp, classes)
    f32 = classes.clone()
    f32[:, 1] = torch.where(f32[:, 1] == scatter_rows.ACC_BF16, scatter_rows.ACC_F32, f32[:, 1])
    exact = grid_encode.grid_backward_plain(x, dy, levels, F, interp, f32)
    S = grid_encode.grid_backward_plain(x, dy.float().abs(), levels, F, interp, torch.zeros_like(classes))
    assert got.shape == plain.shape and torch.isfinite(got).all()
    for lvl in range(enc.n_levels):
        lo, hi = int(enc.offset_table[lvl]) * F, int(enc.offset_table[lvl + 1]) * F
        g, p, e, s = got[lo:hi], plain[lo:hi], exact[lo:hi], S[lo:hi]
        if int(classes[lvl, 1]) == scatter_rows.ACC_BF16:
            assert float((g - e).norm()) <= 2 * float((p - e).norm()) + 1e-6 * float(s.norm()), lvl
        else:
            assert bool(((g - p).abs() <= 1e-5 * s + 1e-30).all()), lvl
    assert not got[S == 0].any()


def _interp_code(enc):
    from tcnn_tpu_torch.encodings.grid import _INTERP_CODES

    return _INTERP_CODES[enc.interpolation_type]


def _table_grad(enc, x, dy, classes):
    before = grid_encode.BWD_LAUNCHES
    got = grid_encode.grid_backward(x, dy, enc._levels_on(x.device), enc.n_features_per_level, _interp_code(enc),
                                    classes)
    torch.cuda.synchronize()
    assert grid_encode.BWD_LAUNCHES == before + 1
    return got


@pytest.mark.parametrize("scatter", ["auto", "factored_sr"])
def test_table_gradient_stratified_flagship_batch(dev, scatter):
    """A stratified 2^18 batch of the flagship encoding in its own classes
    (all (none, fp32) at 2^18) and under factored_sr; levels 0-2 are
    privatised."""
    from tcnn_tpu_torch.utils.sampling import stratified_uniform

    enc = create_encoding(2, dict(FLAGSHIP_GRID, scatter_strategy=scatter), alignment=16)
    gen = torch.Generator(device=dev).manual_seed(1)
    x = stratified_uniform(2**18, 2, gen, device=dev)
    dy = torch.randn((2**18, 32), generator=gen, device=dev).bfloat16()
    classes = torch.from_numpy(enc.gradient_classes(2**18)).to(dev)
    assert grid_encode.backward_plan(enc.level_table(), 2, 2**18, classes).privatised[:4] == [True] * 3 + [False]
    _check_levels(enc, _table_grad(enc, x, dy, classes), x, dy, classes)


@pytest.mark.parametrize("acc", [scatter_rows.ACC_F32, scatter_rows.ACC_BF16], ids=["fp32", "bf16"])
def test_table_gradient_every_sample_at_one_point(dev, acc):
    """The worst collision: 2^17 samples at one point, every lane of every
    warp on the same rows."""
    enc = create_encoding(2, FLAGSHIP_GRID, alignment=16)
    x = torch.full((2**17, 2), 0.3137, device=dev)
    dy = torch.randn((2**17, 32), generator=torch.Generator(device=dev).manual_seed(2), device=dev).bfloat16()
    classes = torch.tensor([[scatter_rows.CONTRIB_RN, acc]] * enc.n_levels, dtype=torch.int32, device=dev)
    _check_levels(enc, _table_grad(enc, x, dy, classes), x, dy, classes)


@pytest.mark.parametrize("batch", [0, 1, 100_003])
def test_table_gradient_batch_sizes_and_points_outside(dev, batch):
    """Batches of 0, 1 and 100,003 samples (no multiple of a tile), points
    in [-0.5, 1.5]^2, fp32 dy."""
    enc = create_encoding(2, FLAGSHIP_GRID, alignment=16)
    rng = np.random.default_rng(batch)
    x = torch.from_numpy(rng.uniform(-0.5, 1.5, (batch, 2)).astype(np.float32)).to(dev)
    dy = torch.from_numpy(rng.normal(0, 1, (batch, 32)).astype(np.float32)).to(dev)
    classes = torch.from_numpy(enc.gradient_classes(max(batch, 1))).to(dev)
    got = _table_grad(enc, x, dy, classes)
    if batch == 0:
        assert got.shape == (enc.n_params,) and not got.any()
    else:
        _check_levels(enc, got, x, dy, classes)


@pytest.mark.parametrize("interp", ["Linear", "Nearest", "Smoothstep"])
@pytest.mark.parametrize("F", [1, 2, 4, 8])
def test_table_gradient_3d_features_and_interpolations(dev, F, interp):
    """d = 3, F in {1, 2, 4, 8} (scalar, float2 and float4 adds), Nearest
    and Smoothstep, in the classes of a 40,000 batch with every other level
    in class (SR, bf16), level 0 (privatised) among them."""
    enc = create_encoding(3, dict(GRID3D, n_features_per_level=F, interpolation=interp), alignment=16)
    rng = np.random.default_rng(F)
    n = 40_000
    x = torch.from_numpy(rng.uniform(-0.2, 1.2, (n, 3)).astype(np.float32)).to(dev)
    dy = torch.from_numpy(rng.normal(0, 1, (n, enc.padded_output_width)).astype(np.float32)).to(dev).bfloat16()
    classes = torch.from_numpy(enc.gradient_classes(n)).to(dev)
    classes[::2] = torch.tensor([scatter_rows.CONTRIB_SR, scatter_rows.ACC_BF16], dtype=torch.int32)
    assert grid_encode.backward_plan(enc.level_table(), F, n, classes).privatised[0]
    _check_levels(enc, _table_grad(enc, x, dy, classes), x, dy, classes)


def test_table_gradient_unprivatised_level_and_drop(dev, monkeypatch):
    """A plan whose shared-memory budget holds level 0 but not level 2 (which
    the rows rule would privatise), and level 1 of class drop (it adds
    nothing and is not privatised)."""
    enc = create_encoding(2, FLAGSHIP_GRID, alignment=16)
    rng = np.random.default_rng(9)
    n = 2**18
    x = torch.from_numpy(rng.uniform(0, 1, (n, 2)).astype(np.float32)).to(dev)
    dy = torch.from_numpy(rng.normal(0, 1, (n, 32)).astype(np.float32)).to(dev).bfloat16()
    classes = torch.from_numpy(enc.gradient_classes(n)).to(dev)
    classes[1] = torch.tensor([scatter_rows.CONTRIB_NONE, scatter_rows.ACC_DROP], dtype=torch.int32)
    assert grid_encode.backward_plan(enc.level_table(), 2, n, classes).privatised[:3] == [True, False, True]
    meta = enc.n_levels * (4 * grid_encode._LEVEL_COLS + 8)
    monkeypatch.setattr(grid_encode, "BWD_SMEM_LIMIT", meta + 256 * 8 + 1000)
    plan = grid_encode.backward_plan(enc.level_table(), 2, n, classes)
    assert plan.privatised[:3] == [True, False, False]
    before = grid_encode.BWD_LAUNCHES
    got = grid_encode.grid_backward(x, dy, enc._levels_on(dev), 2, grid_encode.INTERP_LINEAR, classes, plan=plan)
    torch.cuda.synchronize()
    assert grid_encode.BWD_LAUNCHES == before + 1
    lo, hi = int(enc.offset_table[1]) * 2, int(enc.offset_table[2]) * 2
    assert not got[lo:hi].any()
    _check_levels(enc, got, x, dy, classes)


def test_table_gradient_3d_model_classes(dev):
    """The 3D model at B = 2^18 in its training classes: 13 levels add in
    bf16 (2^19-row tables), 3 in fp32; no level is privatised."""
    enc = create_encoding(3, ENC3D_GRID, alignment=16)
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.rand((2**18, 3), generator=gen, device=dev)
    dy = torch.randn((2**18, 32), generator=gen, device=dev).bfloat16()
    classes = torch.from_numpy(enc.gradient_classes(2**18)).to(dev)
    assert int((classes[:, 1] == scatter_rows.ACC_BF16).sum()) == 13
    _check_levels(enc, _table_grad(enc, x, dy, classes), x, dy, classes)


def test_atomic_table_gradient_kernel_matches_the_new_one(dev):
    """The earlier kernel, kept for chip_smoke.py's A/B timing, against the
    plain version on a stratified flagship batch (the same tolerances)."""
    from tcnn_tpu_torch.utils.sampling import stratified_uniform

    enc = create_encoding(2, FLAGSHIP_GRID, alignment=16)
    gen = torch.Generator(device=dev).manual_seed(4)
    x = stratified_uniform(2**16, 2, gen, device=dev)
    dy = torch.randn((2**16, 32), generator=gen, device=dev).bfloat16()
    classes = torch.from_numpy(enc.gradient_classes(2**16)).to(dev)
    before = (grid_encode.ATOMIC_BWD_LAUNCHES, grid_encode.BWD_LAUNCHES)
    old = grid_encode._grid_backward_atomic(x, dy, enc._levels_on(dev), 2, grid_encode.INTERP_LINEAR, classes)
    torch.cuda.synchronize()
    assert (grid_encode.ATOMIC_BWD_LAUNCHES, grid_encode.BWD_LAUNCHES) == (before[0] + 1, before[1])
    _check_levels(enc, old, x, dy, classes)
    _check_levels(enc, _table_grad(enc, x, dy, classes), x, dy, classes)


def test_training_step_goes_through_the_table_gradient_kernel(dev):
    """GridEncoding's own autograd path (its cached plan) launches the
    kernel once a backward and matches the plain path's gradient."""
    from tcnn_tpu_torch.utils.sampling import stratified_uniform

    enc = create_encoding(2, FLAGSHIP_GRID, alignment=16)
    gen = torch.Generator(device=dev).manual_seed(5)
    x = stratified_uniform(2**16, 2, gen, device=dev)
    params = (torch.rand(enc.n_params, generator=gen, device=dev) * 2 - 1).requires_grad_(True)
    w = torch.randn((2**16, enc.padded_output_width), generator=gen, device=dev)
    before = grid_encode.BWD_LAUNCHES
    (g,) = torch.autograd.grad((enc.apply(params, x).float() * w).sum(), params)
    torch.cuda.synchronize()
    assert grid_encode.BWD_LAUNCHES == before + 1
    dy = w.bfloat16()
    classes = torch.from_numpy(enc.gradient_classes(2**16)).to(dev)
    _check_levels(enc, g, x, dy, classes)
