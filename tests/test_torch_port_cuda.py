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
within 1e-5 of max |plain| (the matmul sums in another order). The SH
kernels (ops.sh_encode), on both routes: the fp32 forward and dL/dx within
1e-5 of max |plain| (the same operations, but torch divides by a scalar on the card as
a multiply by its reciprocal; the backward sums the terms in another
order), bf16 within one bf16 ulp more; the NeRF composite's model outputs as the MLP forward.
"""

import numpy as np
import pytest
import torch

import tcnn_tpu_torch as tt
from tcnn_tpu_torch.common import Activation
from tcnn_tpu_torch.encodings import create_encoding
from tcnn_tpu_torch.ops import ffmlp, fused_adam, grid_encode, probe_rows, scatter_rows, sh_encode
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


RAGGED_BATCHES = (1, 15, 17, 31, 33, 2**18 + 7)


def _mlp(dev, gen, in_w, width, n_hidden, out_w, gain=2.0):
    """Weights as views of one bf16 buffer (a network's layout)."""
    shapes = [(out_w, in_w)] if n_hidden == 0 else (
        [(width, in_w)] + [(width, width)] * (n_hidden - 1) + [(out_w, width)])
    flat = torch.cat([((torch.rand(r * c, generator=gen, device=dev) * 2 - 1) * gain / c ** 0.5) for r, c in shapes])
    flat = flat.bfloat16()
    ws, off = [], 0
    for r, c in shapes:
        ws.append(flat[off:off + r * c].view(r, c))
        off += r * c
    return ws


@pytest.mark.parametrize("out_w", [16, 32, 64])
@pytest.mark.parametrize("n_hidden", [0, 1, 2, 5])
@pytest.mark.parametrize("width", [16, 32, 64, 128])
def test_ffmlp_forward_ragged_batches(dev, width, n_hidden, out_w):
    """The persistent kernel at batches with a ragged last tile, up to 2^18
    + 7 rows, every layout of the host plan."""
    gen = torch.Generator(device=dev).manual_seed(width * 100 + n_hidden * 10 + out_w)
    ws = _mlp(dev, gen, 32, width, n_hidden, out_w)
    for batch in RAGGED_BATCHES:
        x = (torch.rand((batch, 32), generator=gen, device=dev) * 2 - 1).bfloat16()
        before = ffmlp.LAUNCHES
        got = ffmlp.ffmlp_forward(x, ws, Activation.ReLU, Activation.NONE)
        assert ffmlp.LAUNCHES == before + 1 and got.shape == (batch, out_w)
        _close_bf16(got, ffmlp.ffmlp_forward_plain(x, ws, Activation.ReLU, Activation.NONE))


@pytest.mark.parametrize("out_act", [a for a in Activation])
@pytest.mark.parametrize("act", [a for a in Activation])
def test_ffmlp_forward_every_activation_pair(dev, act, out_act):
    """Every activation as the hidden one and as the output one, through the
    32-row (width 64) and 16-row (width 128) layouts."""
    gen = torch.Generator(device=dev).manual_seed(list(Activation).index(act) * 10 + list(Activation).index(out_act))
    gain = 0.5 if Activation.Exponential in (act, out_act) else 2.0
    for width in (64, 128):
        ws = _mlp(dev, gen, 32, width, 2, 16, gain)
        x = (torch.rand((1000, 32), generator=gen, device=dev) * 2 - 1).bfloat16()
        _close_bf16(ffmlp.ffmlp_forward(x, ws, act, out_act), ffmlp.ffmlp_forward_plain(x, ws, act, out_act))


@pytest.mark.parametrize("shape", [(32, 64, 2, 16), (128, 128, 5, 16), (32, 16, 0, 16), (64, 128, 7, 16)],
                         ids=str)
def test_ffmlp_forward_is_bitwise_repeatable(dev, shape):
    """No atomics: two calls on the same inputs give the same bits (the last
    shape takes the plan's single x buffer)."""
    gen = torch.Generator(device=dev).manual_seed(7)
    ws = _mlp(dev, gen, *shape)
    x = (torch.rand((2**18 + 7, shape[0]), generator=gen, device=dev) * 2 - 1).bfloat16()
    a = ffmlp.ffmlp_forward(x, ws, Activation.ReLU, Activation.NONE)
    b = ffmlp.ffmlp_forward(x, ws, Activation.ReLU, Activation.NONE)
    assert torch.equal(a, b)
    _close_bf16(a, ffmlp.ffmlp_forward_plain(x, ws, Activation.ReLU, Activation.NONE))


@pytest.mark.parametrize("shape", [(16, 64, 26, 16), (256, 32, 33, 64), (1024, 16, 0, 64)], ids=str)
def test_ffmlp_forward_sixteen_row_layouts(dev, shape):
    """Shapes whose host plan gives 16 rows a warp below width 128 (weights
    or x tiles too large for 32), so that the instantiations a network
    reaches only at such shapes run too."""
    assert ffmlp.forward_layout(*shape)[0] == 16
    gen = torch.Generator(device=dev).manual_seed(sum(shape))
    ws = _mlp(dev, gen, *shape, gain=6 ** 0.5)  # ReLU keeps the scale through 33 layers
    x = (torch.rand((4099, shape[0]), generator=gen, device=dev) * 2 - 1).bfloat16()
    _close_bf16(ffmlp.ffmlp_forward(x, ws, Activation.ReLU, Activation.NONE),
                ffmlp.ffmlp_forward_plain(x, ws, Activation.ReLU, Activation.NONE))


def test_ffmlp_forward_separate_weights_and_too_large(dev):
    """Weights that are not views of one buffer are concatenated first; a
    network whose weights do not fit shared memory raises."""
    gen = torch.Generator(device=dev).manual_seed(11)
    ws = [w.clone() for w in _mlp(dev, gen, 32, 64, 2, 16)]
    x = (torch.rand((777, 32), generator=gen, device=dev) * 2 - 1).bfloat16()
    _close_bf16(ffmlp.ffmlp_forward(x, ws, Activation.ReLU, Activation.NONE),
                ffmlp.ffmlp_forward_plain(x, ws, Activation.ReLU, Activation.NONE))
    big = _mlp(dev, gen, 128, 128, 8, 16)
    with pytest.raises(ValueError, match="do not fit"):
        ffmlp.ffmlp_forward(torch.zeros((16, 128), dtype=torch.bfloat16, device=dev), big, Activation.ReLU,
                            Activation.NONE)


@pytest.mark.parametrize("n_hidden", [0, 3])
@pytest.mark.parametrize("w", [16, 32, 64])
def test_packed_forward_at_packed_widths(dev, w, n_hidden):
    """K7 (the forward on the (B, w) view) at the packed protocol's widths,
    a ragged row count."""
    G = 128 // w
    gen = torch.Generator(device=dev).manual_seed(w + n_hidden)
    ws = _mlp(dev, gen, w, w, n_hidden, w, 1.0)
    xp = torch.randn((4099, 128), generator=gen, device=dev).bfloat16()
    before = ffmlp.PACKED_LAUNCHES
    got = ffmlp.ffmlp_forward_packed(xp, ws, Activation.ReLU, Activation.NONE)
    assert ffmlp.PACKED_LAUNCHES == before + 1 and got.shape == (4099, G * w)
    _close_bf16(got, ffmlp.ffmlp_forward_packed_plain(xp, ws, Activation.ReLU, Activation.NONE))


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


@pytest.mark.parametrize("hp", ADAM_KNOBS, ids=[str(sorted(k)) for k in ADAM_KNOBS])
def test_adam_kernel_ragged_size_and_odd_matrix_boundary(dev, hp):
    """n no multiple of 4 and an odd n_matrix (the matrix boundary inside a
    16-byte vector), and the scalar path of a misaligned view; param_steps
    equal, the rest to rtol 1e-6, atol 1e-7."""
    n, n_matrix = 50_003, 7_167
    opt = AdamOptimizer(hp)
    opt.allocate(n, [(1, n_matrix)])
    rng = np.random.default_rng(len(hp) + 100)
    p0 = torch.from_numpy(rng.normal(0, 0.3, n).astype(np.float32)).to(dev)
    sk, sp, pk, pp = opt.init_state(dev), opt.init_state(dev), p0.clone(), p0.clone()
    for i in range(3):
        g = rng.normal(0, 1, n).astype(np.float32) * 128
        g[n_matrix:][rng.random(n - n_matrix) < 0.1] = 0.0
        g = torch.from_numpy(g).to(dev)
        sp, pp = opt.step(sp, pp, g, 128.0, plain=True)
        if i == 1:
            # One step on views one float past 16-byte alignment.
            pad = torch.zeros(n + 1, device=dev)
            pad[1:] = g
            g = pad[1:]
        sk, pk = opt.step(sk, pk, g, 128.0)
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
@pytest.mark.parametrize("n_dims", [2, 3, 4])
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


SECOND_ORDER_GRID = {
    "otype": "HashGrid", "n_levels": 10, "log2_hashmap_size": 12, "base_resolution": 4, "per_level_scale": 1.5,
    "hash": "CoherentAdditive",
}


def _second_order_inputs(dev, n_dims, F, n, dy_dtype, seed):
    enc = create_encoding(n_dims, dict(SECOND_ORDER_GRID, n_features_per_level=F), alignment=16)
    rng = np.random.default_rng(seed)
    t = {
        "x": rng.uniform(-0.2, 1.2, (n, n_dims)), "params": rng.uniform(-1, 1, enc.n_params),
        "dy": rng.normal(0, 1, (n, enc.padded_output_width)), "cgx": rng.normal(0, 1, (n, n_dims)),
        "cgp": rng.normal(0, 1, enc.n_params),
    }
    t = {k: torch.from_numpy(v.astype(np.float32)).to(dev) for k, v in t.items()}
    t["dy"] = t["dy"].to(dy_dtype)
    # Every level (none, fp32) but level 1 (RN, bf16), level 2 (SR, fp32)
    # and level 3 (drop). At d = 1 the bf16 class goes to the finest level
    # instead: level 1 has 6 rows there, about 1,000 bf16 adds each, whose error
    # depends on the order too much for a norm over 6 entries to compare
    # two orders (``_check_second_order_table``).
    classes = torch.zeros((enc.n_levels, 2), dtype=torch.int32)
    t["bf16_level"] = 1 if n_dims > 1 else enc.n_levels - 1
    classes[t["bf16_level"]] = torch.tensor([scatter_rows.CONTRIB_RN, scatter_rows.ACC_BF16])
    classes[2] = torch.tensor([scatter_rows.CONTRIB_SR, scatter_rows.ACC_F32])
    classes[3] = torch.tensor([scatter_rows.CONTRIB_NONE, scatter_rows.ACC_DROP])
    t["classes"] = classes.to(dev)
    return enc, t


def _check_second_order_table(enc, got, plain, exact, classes):
    """G2's table gradient level by level: an fp32 level within 1e-5 of its
    max |plain| (atomics add in any order); a bf16 level at most twice the
    plain sequential sum's error against the fp32 sum of the same rounded
    contributions, in norm."""
    F = enc.n_features_per_level
    assert got.shape == plain.shape and torch.isfinite(got).all()
    for lvl in range(enc.n_levels):
        lo, hi = int(enc.offset_table[lvl]) * F, int(enc.offset_table[lvl + 1]) * F
        g, p, e = got[lo:hi], plain[lo:hi], exact[lo:hi]
        if int(classes[lvl, 1]) == scatter_rows.ACC_BF16:
            assert float((g - e).norm()) <= 2 * float((p - e).norm()) + 1e-6 * float(e.norm()), lvl
        else:
            assert float((g - p).abs().max()) <= 1e-5 * float(p.abs().max()) + 1e-30, lvl


@pytest.mark.parametrize("dy_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("n_dims", [2, 3, 4, 1, 5])
@pytest.mark.parametrize("F", [1, 2, 3, 4, 5, 6, 7, 8])
def test_grid_second_order_every_instantiation(dev, F, n_dims, dy_dtype):
    """G1 and G2 at every compiled (F, d) pair and at run-time d (1, 4, 5), in
    both dy types: 10 levels (some warps take two, some one) into a padded
    width, 3,037 points (a ragged last tile), points outside [0, 1]. G2 with
    and without cgp, without cgx, and without a class table (no table
    gradient); the class table holds an (RN, bf16), an (SR, fp32) and a
    dropped level. fp32 results as ``_close_f32``."""
    enc, t = _second_order_inputs(dev, n_dims, F, 3037, dy_dtype, 100 * F + n_dims)
    x, dy, params, cgx, cgp, classes = (t[k] for k in ("x", "dy", "params", "cgx", "cgp", "classes"))
    args = (enc._levels_on(dev), F, _interp_code(enc))
    exact_cls = classes.clone()
    exact_cls[t["bf16_level"], 1] = scatter_rows.ACC_F32
    before = (grid_encode.INPUT_LAUNCHES, grid_encode.BWDBWD_LAUNCHES)
    _close_f32(grid_encode.grid_backward_input(x, dy, params, *args),
               grid_encode.grid_backward_input_plain(x, dy, params, *args))
    cases = ((classes, cgp, cgx), (classes, None, cgx), (None, cgp, cgx), (classes, cgp, None))
    for cls, cp, cx in cases:
        got = grid_encode.grid_backward_backward(x, dy, params, *args, cls, cp, cx)
        want = grid_encode.grid_backward_backward_plain(x, dy, params, *args, cls, cp, cx)
        _close_f32(got[1], want[1])
        _close_f32(got[2], want[2])
        if cls is None or cx is None:
            assert got[0] is None and want[0] is None
        else:
            exact = grid_encode.grid_backward_backward_plain(x, dy, params, *args, exact_cls, cp, cx)[0]
            _check_second_order_table(enc, got[0], want[0], exact, cls)
            lo, hi = int(enc.offset_table[3]) * F, int(enc.offset_table[4]) * F
            assert not got[0][lo:hi].any()  # the dropped level
    assert (grid_encode.INPUT_LAUNCHES, grid_encode.BWDBWD_LAUNCHES) == (before[0] + 1, before[1] + len(cases))


@pytest.mark.parametrize("batch", [0, 1, 33])
def test_grid_second_order_batch_sizes(dev, batch):
    """Batches of 0, 1 and 33 samples (one full tile and one lane of the
    next): the outputs' shapes, and the plain versions' values."""
    enc, t = _second_order_inputs(dev, 3, 2, batch, torch.bfloat16, batch)
    x, dy, params, cgx, cgp, classes = (t[k] for k in ("x", "dy", "params", "cgx", "cgp", "classes"))
    args = (enc._levels_on(dev), 2, _interp_code(enc))
    dx = grid_encode.grid_backward_input(x, dy, params, *args)
    d_params, d_x, d_dy = grid_encode.grid_backward_backward(x, dy, params, *args, classes, cgp, cgx)
    torch.cuda.synchronize()
    assert dx.shape == d_x.shape == (batch, 3) and d_dy.shape == dy.shape and d_params.shape == params.shape
    if batch == 0:
        assert not d_params.any()
        return
    _close_f32(dx, grid_encode.grid_backward_input_plain(x, dy, params, *args))
    want = grid_encode.grid_backward_backward_plain(x, dy, params, *args, classes, cgp, cgx)
    _close_f32(d_x, want[1])
    _close_f32(d_dy, want[2])


def test_grid_second_order_is_deterministic(dev):
    """d/dx (G1 and G2) and d/d(dL_dy) take no atomics: two calls on the
    same inputs give the same bits (the 3D model at 2^16 points, in its
    training classes, both cotangents)."""
    enc = create_encoding(3, ENC3D_GRID, alignment=16)
    gen = torch.Generator(device=dev).manual_seed(4)
    n = 2**16
    x = torch.rand((n, 3), generator=gen, device=dev)
    params = torch.rand((enc.n_params,), generator=gen, device=dev) * 2 - 1
    dy = torch.randn((n, 32), generator=gen, device=dev).bfloat16()
    cgx = torch.randn((n, 3), generator=gen, device=dev)
    cgp = torch.randn((enc.n_params,), generator=gen, device=dev)
    classes = torch.from_numpy(enc.gradient_classes(n)).to(dev)
    args = (enc._levels_on(dev), 2, grid_encode.INTERP_LINEAR)
    runs = [(grid_encode.grid_backward_input(x, dy, params, *args),
             *grid_encode.grid_backward_backward(x, dy, params, *args, classes, cgp, cgx)[1:]) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


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


def _window_starts(dev, S, B, seed):
    """B int32 indices whose windows (the entries at multiples of 8) start
    inside the table, straddle its end, start below 0 or wrap the int32 sum
    of start and row."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(-12, S + 4, B).astype(np.int64)
    edges = np.array([2**31 - 1, 2**31 - 3, -(2**31), -1, -5, -8, S - 1, S - 5, S - 8, S, 0, 7, 8, 3, S - 9, S + 100])
    starts = idx[::8]
    starts[:edges.size] = edges[:starts.size]
    return torch.from_numpy(idx.astype(np.int32)).to(dev)


@pytest.mark.parametrize("aligned", [False, True])
@pytest.mark.parametrize("F", [1, 2, 3, 8])
def test_probe_gather_windows_match_plain(dev, F, aligned):
    """WINDOW through its own kernel (route "window"), plain and aligned,
    bitwise the plain version: B = 8, 2^17 and 2^21 + 8; windows that
    straddle S, start below 0 or wrap the int32 sum; a table 4 bytes off
    16-byte alignment (scalar vectors); bf16 rounding."""
    pr = probe_rows
    S = 1000
    for B in (8, 2**17, 2**21 + 8):
        idx = _window_starts(dev, S, B, B + F)
        table = torch.from_numpy(np.random.default_rng(F).standard_normal((S, F)).astype(np.float32)).to(dev)
        for t in (table, _offset_by_one(table)):
            for flags in (0, pr.FLAG_ROUND_BF16):
                flags |= pr.FLAG_ALIGNED if aligned else 0
                got = _routed(t, idx, "window", mode=pr.MODE_WINDOW, flags=flags)
                assert torch.equal(got, pr.probe_gather_plain(t, idx, pr.MODE_WINDOW, flags=flags)), (B, flags)
        assert pr.gather_plan(B, S, F, pr.MODE_WINDOW, table_align=4).vec == 1


@pytest.mark.parametrize("F", [1, 3, 8, 256])
def test_probe_gather_copy_tiles_match_plain(dev, F):
    """COPY through its own kernel (route "copy"), bitwise the plain
    version: B = TILE and 64 TILE (the probe's), bf16 rounding, a table 4
    bytes off 16-byte alignment (scalar vectors); at F = 256 off alignment
    a tile has more vectors than the card holds threads."""
    pr = probe_rows
    S = pr.TILE + 5
    table = torch.from_numpy(np.random.default_rng(F).standard_normal((S, F)).astype(np.float32)).to(dev)
    idx_all = torch.zeros(64 * pr.TILE, dtype=torch.int32, device=dev)
    for B in (pr.TILE, 2 * pr.TILE) if F == 256 else (pr.TILE, 64 * pr.TILE):
        for t in (table, _offset_by_one(table)):
            for flags in (0, pr.FLAG_ROUND_BF16):
                got = _routed(t, idx_all[:B], "copy", mode=pr.MODE_COPY, flags=flags)
                assert torch.equal(got, pr.probe_gather_plain(t, idx_all[:B], pr.MODE_COPY, flags=flags)), (B, flags)
    wide = pr.gather_plan(2 * pr.TILE, S, 256, pr.MODE_COPY, table_align=4)
    assert wide.per_row > wide.grid * wide.threads == pr.sm_count(dev.index or 0) * 2048


@pytest.mark.parametrize("mode", [probe_rows.MODE_WINDOW, probe_rows.MODE_COPY])
def test_probe_gather_transposed_or_feature_major_windows_and_copies_stay_on_l2(dev, mode):
    """WINDOW and COPY of a transposed table or into feature-major tiles,
    and with ``unroll``, take the L2 gather (route "l2") and still match
    the plain version bit for bit."""
    pr = probe_rows
    S, F, B = 4096, 8, 2 * pr.TILE
    table, _ = _probe_inputs(dev, S, F, 1, 5)
    idx = _window_starts(dev, S, B, 5)
    for t, flags, kw in ((table.t().contiguous(), pr.FLAG_TRANSPOSED, {}), (table, pr.FLAG_FEATURE_MAJOR, {}),
                         (table.t().contiguous(), pr.FLAG_TRANSPOSED | pr.FLAG_FEATURE_MAJOR, {}),
                         (table, 0, {"unroll": 8})):
        if mode == pr.MODE_WINDOW:
            flags |= pr.FLAG_ALIGNED
        got = _routed(t, idx, "l2", mode=mode, flags=flags, **kw)
        assert torch.equal(got, pr.probe_gather_plain(t, idx, mode, flags=flags)), flags


def test_probe_gather_windows_and_copies_in_a_graph_and_on_a_second_stream(dev):
    """WINDOW (plain and aligned, rounded) and COPY captured into a CUDA
    graph and launched on a second stream: replays and side-stream calls
    give the plain version's bits."""
    pr = probe_rows
    table, _ = _probe_inputs(dev, 4096, 8, 1, 23)
    idx = _window_starts(dev, 4096, 2**17, 23)
    calls = [{"mode": pr.MODE_WINDOW}, {"mode": pr.MODE_WINDOW, "flags": pr.FLAG_ALIGNED | pr.FLAG_ROUND_BF16},
             {"mode": pr.MODE_COPY}, {"mode": pr.MODE_COPY, "flags": pr.FLAG_ROUND_BF16}]
    wants = [pr.probe_gather_plain(table, idx, kw["mode"], flags=kw.get("flags", 0)) for kw in calls]
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for kw, want in zip(calls, wants):
            assert torch.equal(pr.probe_gather(table, idx, **kw), want)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        outs = [pr.probe_gather(table, idx, **kw) for kw in calls]
    for _ in range(3):
        for o in outs:
            o.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        for o, want in zip(outs, wants):
            assert torch.equal(o, want)


def test_probe_gather_rejects_a_route_its_kernel_does_not_take(dev):
    """The dispatcher launches the kernel the plan's ``route`` names and
    nothing else: a ROW plan from L2 given any other route (or none) returns
    cudaErrorInvalidValue and leaves the output untouched, and with its own
    route it gathers."""
    pr = probe_rows
    table, _ = _probe_inputs(dev, 4096, 8, 1, 29)
    idx = _window_starts(dev, 4096, 2 * pr.TILE, 29)
    plan = pr.gather_plan(2 * pr.TILE, 4096, 8, pr.MODE_ROW, pr.SOURCE_L2, 0, 16, 16,
                          pr.sm_count(table.device.index))
    fields = {n: getattr(plan, n) for n in plan.FIELDS}
    launch = pr.kernel("probe_rows", "tcnn_probe_gather", pr._GATHER_ARGS)
    for route in range(len(pr.GATHER_ROUTES) + 1):
        out = torch.full((2 * pr.TILE, 8), float("nan"), device=dev)
        wrong = pr.GatherPlan(**{**fields, "route": route})
        err = launch(table.data_ptr(), None, idx.data_ptr(), out.data_ptr(), wrong.args_ptr,
                     pr.stream(table.device.index))
        torch.cuda.synchronize()
        if route == pr.ROUTE_L2:
            assert err == 0 and torch.equal(out, pr.probe_gather_plain(table, idx))
        else:
            assert err == 1 and torch.isnan(out).all(), pr.GATHER_ROUTES[route:route + 1]


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


@pytest.mark.parametrize("case", ["random", "one_slot", "sparse", "empty"])
@pytest.mark.parametrize("R", [2, 3, 8])
def test_probe_scatter_store_last_writes_every_row(dev, R, case):
    """STORE_LAST's claim and slot pass bitwise the plain version: random
    indices with some outside [0, size); every row on one slot; a few rows
    into 2^17 slots (no row on most slots); N = 0 (all zeros). The output
    comes from a cache block filled with NaN first, so every row must be
    the kernel's own (the winner's or zeros), after a call that hit every
    slot (its winners, of an earlier epoch, read as none); rows 4 bytes off
    alignment take the scalar form; a second call, on another stream too,
    and the calls around the last epoch (a fresh winner array after it)
    give the same bits; each call counts one launch."""
    pr = probe_rows
    rng = np.random.default_rng(R + len(case))
    size, N = {"random": (4096, 2**16), "one_slot": (4096, 5000), "sparse": (2**17, 100), "empty": (1000, 0)}[case]
    idx = rng.integers(-50, size + 50, N).astype(np.int32)
    if case == "one_slot":
        idx[:] = 17
    idx = torch.from_numpy(idx).to(dev)
    rows = torch.from_numpy(rng.normal(0, 1, (N, R)).astype(np.float32)).to(dev)
    want = pr.probe_scatter_plain(idx, rows, size, pr.OP_STORE_LAST)
    every = torch.arange(size, dtype=torch.int32, device=dev)
    pr.probe_scatter(every, torch.ones((size, R), device=dev), size, pr.OP_STORE_LAST)
    for r in (rows, _offset_by_one(rows)):
        junk = torch.full((size, R), float("nan"), device=dev)
        del junk
        before = pr.SCATTER_LAUNCHES
        got = pr.probe_scatter(idx, r, size, pr.OP_STORE_LAST)
        assert pr.SCATTER_LAUNCHES == before + 1
        assert torch.equal(got, want), case
        assert torch.equal(pr.probe_scatter(idx, r, size, pr.OP_STORE_LAST), want)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        other = pr.probe_scatter(idx, rows, size, pr.OP_STORE_LAST)
    torch.cuda.current_stream(dev).wait_stream(side)
    assert torch.equal(other, want)
    key = (rows.device.index, pr.stream(rows.device.index))
    pr._WINNERS[key][1] = pr._LAST_EPOCH - 1
    for _ in range(2):  # the last epoch, then epoch 1 of a fresh array
        assert torch.equal(pr.probe_scatter(idx, rows, size, pr.OP_STORE_LAST), want)
    assert pr._WINNERS[key][1] == 1


def test_probe_scatter_store_last_in_a_captured_graph(dev):
    """A STORE_LAST call captured into a CUDA graph gets winners of its own,
    zeroed in the graph: replays give the plain version's bits, with eager
    calls on the capturing stream between them."""
    pr = probe_rows
    rng = np.random.default_rng(5)
    idx = torch.from_numpy(rng.integers(-5, 2048 + 5, 2**14).astype(np.int32)).to(dev)
    rows = torch.from_numpy(rng.normal(0, 1, (2**14, 8)).astype(np.float32)).to(dev)
    want = pr.probe_scatter_plain(idx, rows, 2048, pr.OP_STORE_LAST)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        pr.probe_scatter(idx, rows, 2048, pr.OP_STORE_LAST)  # warm-up on the capturing stream
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = pr.probe_scatter(idx, rows, 2048, pr.OP_STORE_LAST)
    for _ in range(3):
        graph.replay()
        with torch.cuda.stream(side):
            eager = pr.probe_scatter(idx, rows, 2048, pr.OP_STORE_LAST)
        torch.cuda.synchronize()
        assert torch.equal(out, want) and torch.equal(eager, want)


def _gather_with_plan(table, idx, plan, flags):
    """``probe_gather``'s launch with a given plan (a layout of the
    plane-staged route that the plan's rule need not pick)."""
    pr = probe_rows
    out = torch.empty((plan.B // pr.TILE, plan.F, pr.TILE), dtype=torch.float32, device=table.device)
    err = pr.kernel("probe_rows", "tcnn_probe_gather", pr._GATHER_ARGS)(
        table.data_ptr(), None, idx.data_ptr(), out.data_ptr(), plan.args_ptr, pr.stream(table.device.index))
    assert err == 0
    return out


@pytest.mark.parametrize("S2", [2**10, 2**15, 58112, 58113])
@pytest.mark.parametrize("F", [1, 2, 3, 4, 8])
def test_probe_gather_transposed_feature_major_planes(dev, F, S2):
    """P17's route, ROW of a transposed (F, S2) table into feature-major
    tiles, bitwise the plain version, indices outside [0, S2) reading
    zeros, with and without FLAG_ROUND_BF16: planes staged in shared memory
    where one fits (S2 = 58,112 floats: 227 KB), the row-by-row L2 gather
    beyond (58,113). Feature-major output needs B a multiple of TILE (the
    wrapper raises otherwise), so B is 3 tiles; every number of planes
    that divides F and fits (1, 2, 4, 8 at compile time, 3 at run time)
    and runs of 1, 3 and the card's SMs give the same bits; a table 4
    bytes off alignment stages with scalar loads. Other flag combinations
    keep their routes: transposed row-major output (any B), two tables,
    ``unroll``."""
    pr = probe_rows
    B, flags = 3 * pr.TILE, pr.FLAG_TRANSPOSED | pr.FLAG_FEATURE_MAJOR
    rng = np.random.default_rng(F * 7 + S2)
    table = torch.from_numpy(rng.standard_normal((F, S2)).astype(np.float32)).to(dev)
    idx = torch.from_numpy(rng.integers(-40, S2 + 40, B).astype(np.int32)).to(dev)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    fits = pr.fits_shared(S2)
    for fl in (flags, flags | pr.FLAG_ROUND_BF16):
        want = pr.probe_gather_plain(table, idx, flags=fl)
        plan = pr.gather_plan(B, S2, F, pr.MODE_ROW, pr.SOURCE_L2, fl, 16, 16, n_sms)
        assert (plan.planes > 0) == fits
        junk = torch.full((B // pr.TILE, F, pr.TILE), float("nan"), device=dev)
        del junk
        before = pr.GATHER_LAUNCHES
        assert torch.equal(pr.probe_gather(table, idx, flags=fl), want)
        assert pr.GATHER_LAUNCHES == before + 1
        if fits:
            for planes in [p for p in range(1, F + 1) if F % p == 0 and pr.fits_shared(p * S2)]:
                for runs in (1, 3, n_sms):
                    forced = pr.gather_plan(B, S2, F, pr.MODE_ROW, pr.SOURCE_L2, fl, 16, 16, n_sms,
                                            planes=planes, runs=runs)
                    assert torch.equal(_gather_with_plan(table, idx, forced, fl), want), (planes, runs)
    odd = _offset_by_one(table)
    assert pr.alignment(odd) == 4
    assert torch.equal(pr.probe_gather(odd, idx, flags=flags), pr.probe_gather_plain(table, idx, flags=flags))
    t_idx = idx[: B - 5].contiguous()
    assert pr.gather_plan(B - 5, S2, F, pr.MODE_ROW, pr.SOURCE_L2, pr.FLAG_TRANSPOSED).planes == 0
    assert torch.equal(pr.probe_gather(table, t_idx, flags=pr.FLAG_TRANSPOSED),
                       pr.probe_gather_plain(table, t_idx, flags=pr.FLAG_TRANSPOSED))
    t2 = table + 1.0
    assert pr.gather_plan(B, S2, F, pr.MODE_ROW, pr.SOURCE_L2, flags, two_tables=True).planes == 0
    assert torch.equal(pr.probe_gather(table, idx, table2=t2, flags=flags),
                       pr.probe_gather_plain(table, idx, table2=t2, flags=flags))
    assert torch.equal(pr.probe_gather(table, idx, unroll=8, flags=flags), pr.probe_gather_plain(table, idx, flags=flags))
    with pytest.raises(ValueError, match="multiple of the tile"):
        pr.probe_gather(table, t_idx, flags=flags)


@pytest.mark.parametrize("B", [1, 33, 2**15])
@pytest.mark.parametrize("F", [1, 2, 3, 4, 8])
def test_probe_gather_dot_matches_plain(dev, F, B):
    """P11 within DOT_TOL (1e-5 of max |plain|: fp32 products summed in
    another order than the matmul's) at F = 1, 2, 4, 8 (compile-time F)
    and 3 (run-time F), for part of a warp's group, a group and a part and
    many groups; rows outside the table give zero rows; two calls at the
    same B and F bitwise equal, and a table 4 bytes off alignment (scalar
    row loads) gives the aligned table's bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    S = 2**15
    table, idx = _probe_inputs(dev, S, F, B, 4 + F + B, lo=-5, hi=S + 5)
    w = torch.from_numpy(np.random.default_rng(F).standard_normal((F, probe_rows.DOT_COLS)).astype(np.float32)).to(dev)
    before = probe_rows.DOT_LAUNCHES
    got = probe_rows.probe_gather_dot(table, idx, w)
    assert probe_rows.DOT_LAUNCHES == before + 1
    want = probe_rows.probe_gather_dot_plain(table, idx, w)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert torch.equal(got, probe_rows.probe_gather_dot(table, idx, w))
    assert torch.equal(got, probe_rows.probe_gather_dot(_offset_by_one(table), idx, w))
    outside = (idx < 0) | (idx >= S)
    assert bool((got[outside] == 0).all())


@pytest.mark.parametrize("F", [1, 2, 3, 8])
def test_probe_gather_tile_sum_is_the_plain_sum(dev, F):
    """P13 TILE_SUM bitwise the plain in-order sum at F = 1, 2, 8
    (compile-time F) and 3 (run-time F), rows outside the table adding
    zeros: from a row-major table, with bf16 rounding of the sums, from a
    transposed (F, S) table (with and without rounding) and from a table 4
    bytes off alignment (scalar loads). The output comes from a cache block
    filled with NaN first, so rows 1-7 must be the kernel's own zeros; two
    calls bitwise equal."""
    pr = probe_rows
    S, B = 4096, 4 * pr.TILE
    table, idx = _probe_inputs(dev, S, F, B, 70 + F, lo=-30, hi=S + 30)
    t_t = table.t().contiguous()
    cases = [(table, 0), (table, pr.FLAG_ROUND_BF16), (t_t, pr.FLAG_TRANSPOSED),
             (t_t, pr.FLAG_TRANSPOSED | pr.FLAG_ROUND_BF16), (_offset_by_one(table), 0)]
    for t, flags in cases:
        junk = torch.full((B // pr.TILE * 8, F), float("nan"), device=dev)
        del junk
        before = pr.GATHER_LAUNCHES
        got = pr.probe_gather(t, idx, mode=pr.MODE_TILE_SUM, flags=flags)
        assert pr.GATHER_LAUNCHES == before + 1
        assert torch.equal(got, pr.probe_gather_plain(t, idx, pr.MODE_TILE_SUM, flags=flags)), flags
        assert torch.equal(got, pr.probe_gather(t, idx, mode=pr.MODE_TILE_SUM, flags=flags))


def _routed(table, idx, route, **kw):
    """``probe_gather``'s call, checked to count one launch of ``route``."""
    pr = probe_rows
    before = dict(pr.GATHER_ROUTE_LAUNCHES)
    got = pr.probe_gather(table, idx, **kw)
    moved = {k: v - before.get(k, 0) for k, v in pr.GATHER_ROUTE_LAUNCHES.items() if v != before.get(k, 0)}
    assert moved == {route: 1}
    return got


@pytest.mark.parametrize("F", [1, 3, 8])
def test_probe_gather_shared_matches_plain(dev, F):
    """SHARED, bitwise the plain version: rows outside the table read
    zeros; grids of one block (B = 1, 3), of part of a wave (2^16 + 3) and
    of whole rounds of the wave (2^21 + 5 rows, 8 rows a thread); with
    FLAG_ROUND_BF16 and feature-major output (B of whole tiles)."""
    pr = probe_rows
    S = 4096 if F < 8 else 2048
    for B in (1, 3, 2**16 + 3, 2**21 + 5, 3 * pr.TILE):
        table, idx = _probe_inputs(dev, S, F, B, 11 * F + B, lo=-9, hi=S + 9)
        for flags in (0, pr.FLAG_ROUND_BF16, pr.FLAG_FEATURE_MAJOR):
            if flags & pr.FLAG_FEATURE_MAJOR and B % pr.TILE:
                continue
            got = _routed(table, idx, "shared", source=pr.SOURCE_SHARED, flags=flags)
            assert torch.equal(got, pr.probe_gather_plain(table, idx, flags=flags)), (B, flags)


@pytest.mark.parametrize("case", ["limit", "below_limit", "odd_bytes", "unaligned"])
def test_probe_gather_shared_table_sizes_and_alignment(dev, case):
    """SHARED's staging at the edges of size and alignment, bitwise the
    plain version with and without rounding: the table at the shared-memory
    limit (F = 8, S = 7,264: 227 KB) and just below it (S = 7,263), one
    whose 4 S F bytes are no multiple of 16 (F = 3, S = 4,097) and a table
    4 bytes off alignment (scalar copies)."""
    pr = probe_rows
    S, F = {"limit": (7264, 8), "below_limit": (7263, 8), "odd_bytes": (4097, 3), "unaligned": (4096, 2)}[case]
    for B in (1, 2**16 + 3):
        table, idx = _probe_inputs(dev, S, F, B, S + B, lo=-11, hi=S + 11)
        if case == "unaligned":
            table = _offset_by_one(table)
        for flags in (0, pr.FLAG_ROUND_BF16):
            got = _routed(table, idx, "shared", source=pr.SOURCE_SHARED, flags=flags)
            assert torch.equal(got, pr.probe_gather_plain(table, idx, flags=flags))


@pytest.mark.parametrize("in_flight", [1, 16, 17, 64, 200, 1024])
def test_probe_gather_async_groups_match_plain(dev, in_flight):
    """ASYNC in copy groups of in_flight rows, bitwise the plain version:
    groups of 1, 16, 17, 64, 200 and 1,024 rows (part of a warp, whole
    warps, no multiple of 32 rows or of the lanes a row, more vectors than
    a lane's indices loaded ahead); B = 1, in_flight - 1, in_flight + 1
    and many groups a warp; rows outside the table read zeros (the
    zero-byte copies); rounded and feature-major output; F = 8 and 3 (F =
    2 and 1 at 1,024 rows)."""
    pr = probe_rows
    feats = (2, 1) if in_flight == 1024 else (8, 3)
    for F in feats:
        for B in sorted({1, max(1, in_flight - 1), in_flight + 1, 2**20 + 7, 3 * pr.TILE}):
            table, idx = _probe_inputs(dev, 4096, F, B, in_flight + B + F, lo=-9, hi=4096 + 9)
            for flags in (0, pr.FLAG_ROUND_BF16, pr.FLAG_FEATURE_MAJOR):
                if flags & pr.FLAG_FEATURE_MAJOR and B % pr.TILE:
                    continue
                got = _routed(table, idx, "async", source=pr.SOURCE_ASYNC, in_flight=in_flight, flags=flags)
                assert torch.equal(got, pr.probe_gather_plain(table, idx, flags=flags)), (F, B, flags)


def test_probe_gather_shared_and_async_in_a_graph_and_on_a_second_stream(dev):
    """SHARED (an aligned and an unaligned table) and ASYNC (groups of 16
    and of 64, rounded) captured into a CUDA graph and launched on a second
    stream: replays and side-stream calls give the plain version's bits."""
    pr = probe_rows
    table, idx = _probe_inputs(dev, 2048, 8, 2**17 + 3, 21, lo=-5, hi=2048 + 5)
    odd = _offset_by_one(table)
    calls = [(table, {"source": pr.SOURCE_SHARED}), (odd, {"source": pr.SOURCE_SHARED}),
             (table, {"source": pr.SOURCE_ASYNC, "in_flight": 16}),
             (table, {"source": pr.SOURCE_ASYNC, "in_flight": 64, "flags": pr.FLAG_ROUND_BF16})]
    wants = [pr.probe_gather_plain(t, idx, flags=kw.get("flags", 0)) for t, kw in calls]
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for (t, kw), want in zip(calls, wants):
            assert torch.equal(pr.probe_gather(t, idx, **kw), want)  # warm-up on the capturing stream
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        outs = [pr.probe_gather(t, idx, **kw) for t, kw in calls]
    for _ in range(3):
        for o in outs:
            o.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        for o, want in zip(outs, wants):
            assert torch.equal(o, want)


def test_probe_wrappers_refuse_what_the_kernels_do_not_take(dev):
    """SHARED raises for a table beyond a block's shared memory (no quiet
    L2 fallback), and so does a shared scatter accumulator; TILE_SUM, whose
    output is (B / TILE * 8, F) rows, raises for feature-major output."""
    table, idx = _probe_inputs(dev, 2**15, 8, 1024, 0)
    with pytest.raises(ValueError, match="shared memory"):
        probe_rows.probe_gather(table, idx, source=probe_rows.SOURCE_SHARED)
    with pytest.raises(ValueError, match="shared accumulator"):
        probe_rows.probe_scatter(idx, table[:1024].contiguous(), 2**15, probe_rows.OP_ADD, probe_rows.ACC_SHARED)
    with pytest.raises(ValueError, match="MODE_ROW"):
        probe_rows.probe_gather(table, idx, mode=probe_rows.MODE_WINDOW, source=probe_rows.SOURCE_ASYNC)
    with pytest.raises(ValueError, match="feature-major"):
        probe_rows.probe_gather(table, torch.zeros(probe_rows.TILE, dtype=torch.int32, device=dev),
                                mode=probe_rows.MODE_TILE_SUM, flags=probe_rows.FLAG_FEATURE_MAJOR)


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


# The table gradient (tcnn_grid_backward: level-major tiles, privatised
# coarse levels, merged runs, vector atomics) against its plain version,
# level by level in the level's class (``_check_levels``).
FLAGSHIP_GRID = {
    "otype": "HashGrid", "n_levels": 16, "n_features_per_level": 2, "log2_hashmap_size": 15,
    "base_resolution": 16, "per_level_scale": 1.5, "hash": "CoherentAdditive", "gather_strategy": "stratified",
}
ENC3D_GRID = {"otype": "HashGrid", "n_levels": 16, "n_features_per_level": 2, "log2_hashmap_size": 19,
              "base_resolution": 16, "per_level_scale": 1.5, "hash": "CoherentAdditive"}


def _check_levels(enc, got, x, dy, classes, u=None):
    """Per level: fp32 sums within 1e-5 of the sum of |contributions| per
    entry; bf16 sums at most twice the plain sequential sum's error against
    the fp32 sum of the same rounded contributions, in norm. Entries no
    sample touched are exactly 0. ``u``: stochastic interpolation's
    uniforms, for kernel and plain version alike."""
    levels, F, interp = enc._levels_on(x.device), enc.n_features_per_level, _interp_code(enc)
    plain = grid_encode.grid_backward_plain(x, dy, levels, F, interp, classes, u)
    f32 = classes.clone()
    f32[:, 1] = torch.where(f32[:, 1] == scatter_rows.ACC_BF16, scatter_rows.ACC_F32, f32[:, 1])
    exact = grid_encode.grid_backward_plain(x, dy, levels, F, interp, f32, u)
    S = grid_encode.contribution_magnitudes(x, dy, levels, F, interp, u)
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


def _route_launches(route):
    return grid_encode.BWD_LAUNCHES, grid_encode.BWD_ROUTE_LAUNCHES.get(route, 0)


def _table_grad(enc, x, dy, classes, u=None, route=None):
    """One table-gradient launch; ``route``: the (library, C entry point)
    that must have launched it."""
    before = _route_launches(route)
    got = grid_encode.grid_backward(x, dy, enc._levels_on(x.device), enc.n_features_per_level, _interp_code(enc),
                                    classes, u=u)
    torch.cuda.synchronize()
    after = _route_launches(route)
    assert after[0] == before[0] + 1
    if route is not None:
        assert after[1] == before[1] + 1, f"the table gradient did not launch {route}"
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


# The lookup (tcnn_grid_forward: level-major warps, 32-bit index arithmetic
# without division, vector row loads, staged output rows) against the
# earlier kernel (grid_encode_v1): the same float operations in the same
# order, so the outputs are bitwise equal, on uniform points, points outside
# [0, 1] and points on the cells' boundaries.
SMALL_GRID = dict(GRID, log2_hashmap_size=12)
LOOKUP_CASES = {
    "flagship": (2, FLAGSHIP_GRID, None),
    "3D model": (3, ENC3D_GRID, None),
    "CoherentPrime": (2, dict(FLAGSHIP_GRID, hash="CoherentPrime"), None),
    "Prime 3D": (3, dict(SMALL_GRID, hash="Prime", gather_strategy="per_level"), None),
    "BaseConvert 2D": (2, dict(SMALL_GRID, hash="BaseConvert"), None),
    "Smoothstep": (2, dict(FLAGSHIP_GRID, interpolation="Smoothstep"), None),
    "Nearest": (3, dict(SMALL_GRID, interpolation="Nearest"), None),
    "F=1": (2, dict(SMALL_GRID, n_features_per_level=1), None),
    "F=4": (3, dict(SMALL_GRID, n_features_per_level=4, n_levels=6), None),
    "F=8": (2, dict(SMALL_GRID, n_features_per_level=8, n_levels=4), None),
    "F=3 4D": (4, dict(SMALL_GRID, n_features_per_level=3, n_levels=5), None),
    "1D": (1, SMALL_GRID, None),
    "table_dtype bfloat16": (2, dict(FLAGSHIP_GRID, table_dtype="bfloat16"), None),
    "table_dtype float16": (3, dict(SMALL_GRID, table_dtype="float16", gather_strategy="per_level"), None),
    "serve-time bfloat16": (2, FLAGSHIP_GRID, "bfloat16"),
    "serve-time float16 over own bfloat16": (2, dict(FLAGSHIP_GRID, table_dtype="bfloat16"), "float16"),
}


def _lookup_points(enc, rng, n=2**16):
    d = enc.n_dims_to_encode
    pts = [rng.uniform(0, 1, (n, d)), rng.uniform(-0.5, 1.5, (4096, d))]
    for s in enc.scales:
        k = rng.integers(0, int(np.ceil(s)) + 2, size=(64, d)).astype(np.float32)
        on = (k - np.float32(0.5)) / np.float32(s)
        pts += [on, np.nextafter(on, np.float32(np.inf)), np.nextafter(on, np.float32(-np.inf))]
    return np.concatenate(pts).astype(np.float32)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(LOOKUP_CASES))
def test_lookup_is_bitwise_equal_to_the_earlier_kernel(dev, case, out_dtype):
    d, cfg, serve = LOOKUP_CASES[case]
    enc = create_encoding(d, cfg, alignment=16)
    rng = np.random.default_rng(11)
    x = torch.from_numpy(_lookup_points(enc, rng)).to(dev)
    params = torch.from_numpy(rng.uniform(-1, 1, enc.n_params).astype(np.float32)).to(dev)
    levels = enc._levels_on(dev, table_dtype=serve)
    args = (x, params, levels, enc.n_features_per_level, enc.padded_output_width, _interp_code(enc), out_dtype)
    before = (grid_encode.LAUNCHES, grid_encode.V1_LAUNCHES)
    new, old = grid_encode.grid_encode(*args), grid_encode.grid_encode_v1(*args)
    assert (grid_encode.LAUNCHES, grid_encode.V1_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert torch.equal(_bits(new), _bits(old))
    plain = grid_encode.grid_encode_plain(*args[:6], torch.float32)
    torch.testing.assert_close(new.float(), plain.to(out_dtype).float(), rtol=1e-2 if out_dtype == torch.bfloat16
                               else 1e-5, atol=1e-6)


@pytest.mark.parametrize("batch", [1, 31, 33, 1000])
@pytest.mark.parametrize("alignment", [1, 16])
def test_lookup_batch_edges_and_unpadded_rows(dev, batch, alignment):
    """Batches that end inside a block's 32-sample tile, and rows whose
    bytes are no multiple of 4 (3 levels of 1 bf16 feature, no padding:
    the element-wise copy), against the earlier kernel and unaligned
    parameters (a table that starts 4 bytes into a buffer: scalar reads)."""
    enc = create_encoding(2, dict(SMALL_GRID, n_features_per_level=1, n_levels=3), alignment=alignment)
    rng = np.random.default_rng(batch)
    x = torch.from_numpy(rng.uniform(-0.2, 1.2, (batch, 2)).astype(np.float32)).to(dev)
    buf = torch.from_numpy(rng.uniform(-1, 1, enc.n_params + 1).astype(np.float32)).to(dev)
    for params in (buf[:-1], buf[1:]):
        for out_dtype in (torch.bfloat16, torch.float32):
            args = (x, params, enc._levels_on(dev), 1, enc.padded_output_width, _interp_code(enc), out_dtype)
            assert torch.equal(_bits(grid_encode.grid_encode(*args)), _bits(grid_encode.grid_encode_v1(*args)))


# The row scatter's two paths (scatter_rows_plan): fp32 sums into 64 slots
# with many rows a slot go through per-block shared-memory copies; 2^14
# slots, and every bf16 sum, through vector atomics into the result.
@pytest.mark.parametrize("R", [1, 3, 4, 8])
@pytest.mark.parametrize("S", [64, 2**14])
@pytest.mark.parametrize("cls", SCATTER_CLASSES, ids=str)
def test_scatter_rows_private_and_global_paths(dev, cls, S, R):
    contrib, acc = cls
    rng = np.random.default_rng(S + R)
    n = 2**18
    idx = torch.from_numpy(rng.integers(-3, S + 3, n).astype(np.int32)).to(dev)
    rows = torch.from_numpy(rng.normal(0, 1, (n, R)).astype(np.float32)).to(dev)
    acc_code = scatter_rows.ACC_BF16 if acc == torch.bfloat16 else scatter_rows.ACC_F32
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = scatter_rows.scatter_rows_plan(n, S, R, acc_code, n_sms)
    assert (plan.private > 0) == (S == 64 and acc == torch.float32)
    before = scatter_rows.LAUNCHES
    got = scatter_rows.scatter_rows(idx, rows, S, contrib, acc)
    assert scatter_rows.LAUNCHES == before + 1
    keep = (idx >= 0) & (idx < S)  # the kernel skips rows outside the table
    vi, vr = idx[keep], rows[keep].contiguous()
    plain = scatter_rows.scatter_rows_plain(vi, vr, S, contrib, acc)
    exact = scatter_rows.scatter_rows_plain(vi, vr, S, contrib, torch.float32)
    _check_class(got, plain, exact, scatter_rows.scatter_rows_plain(vi, vr.abs(), S), acc)
    # Sums of small integers are exact in any order: bitwise equal (bf16
    # sums on 16 rows a slot, so that no partial sum leaves bf16's 8 bits).
    m = n if acc == torch.float32 else 16 * S
    ints = torch.from_numpy(rng.integers(-2, 3, (m, R)).astype(np.float32)).to(dev)
    keep = keep[:m]
    assert torch.equal(scatter_rows.scatter_rows(idx[:m].contiguous(), ints, S, contrib, acc),
                       scatter_rows.scatter_rows_plain(idx[:m][keep], ints[keep].contiguous(), S, contrib, acc))


# -- Trainer.training_steps: one step captured as a CUDA graph, replayed --

GRAPH_CONFIG = {
    "loss": {"otype": "RelativeL2"},
    "encoding": {"otype": "HashGrid", "n_levels": 8, "n_features_per_level": 2, "log2_hashmap_size": 14,
                 "base_resolution": 8, "per_level_scale": 1.5},
    "network": {"otype": "FullyFusedMLP", "n_neurons": 64, "n_hidden_layers": 2},
}
GRAPH_OPTIMIZERS = {
    "adam_ema": {"otype": "EMA", "decay": 0.9, "nested": {"otype": "Adam", "learning_rate": 1e-2}},
    "sgd": {"otype": "SGD", "learning_rate": 1e-1},
    "batched": {"otype": "Batched", "batch_size_multiplier": 2, "nested": {"otype": "Adam", "learning_rate": 1e-2}},
    "exponential_decay": {"otype": "ExponentialDecay", "decay_base": 0.5, "decay_start": 2, "decay_interval": 2,
                          "nested": {"otype": "Adam", "learning_rate": 1e-2}},
}


def _graph_data(dev, n, batch=2**14, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    xs = torch.rand((n, batch, 2), generator=gen, device=dev)
    ts = torch.stack([torch.sin(5 * xs[..., 0]), torch.cos(3 * xs[..., 1]), xs[..., 0] * xs[..., 1]], -1)
    return {"x": xs, "t": 0.5 + 0.5 * ts}


def _pick_step(d, i):
    idx = i.reshape(1).to(torch.int64)
    return torch.index_select(d["x"], 0, idx)[0], torch.index_select(d["t"], 0, idx)[0]


def _params_close(a, b, lr):
    """As chip_smoke's graph phase: the table gradient's fp32 atomics add in
    another order, so an Adam step (about lr x sign(grad)) may flip for a
    gradient near 0: max |diff| <= 2 lr; and within 1e-2 relative in norm
    (after a few steps the atomics' differences reach many entries, as
    between two runs of the loop)."""
    d = (a - b).abs()
    assert float(d.max()) <= 2 * lr * 1.0001
    assert float((a - b).norm()) <= 1e-2 * float(b.norm())


@pytest.mark.parametrize("opt", sorted(GRAPH_OPTIMIZERS))
def test_training_steps_graph_matches_the_loop(dev, opt):
    """Six replays of the captured step against six training_step calls
    from the same seed on the same batches: the first loss bitwise (the
    forward is deterministic), the rest to 1e-4 relative; params and the
    inference params as _params_close; the kernels ran at the capture."""
    cfg = dict(GRAPH_CONFIG, optimizer=GRAPH_OPTIMIZERS[opt])
    n = 6
    data = _graph_data(dev, n)
    graph, loop = (tt.create_from_config(2, 3, cfg, seed=3) for _ in range(2))
    before = (ffmlp.LAUNCHES, ffmlp.BWD_LAUNCHES, grid_encode.LAUNCHES, grid_encode.BWD_LAUNCHES)
    losses = graph.trainer.training_steps(_pick_step, n, data)
    after = (ffmlp.LAUNCHES, ffmlp.BWD_LAUNCHES, grid_encode.LAUNCHES, grid_encode.BWD_LAUNCHES)
    assert all(a > b for a, b in zip(after, before))
    want = torch.stack([loop.training_step(*_pick_step(data, torch.tensor(k, device=dev))) for k in range(n)])
    torch.cuda.synchronize()
    assert losses.shape == (n,) and losses.is_cuda and torch.isfinite(losses).all()
    assert torch.equal(losses[0], want[0])
    assert float(((losses - want).abs() / want.abs()).max()) <= 1e-4
    lr = max(1e-2, float(loop.trainer.learning_rate))
    _params_close(graph.params, loop.params, lr)
    _params_close(graph.trainer.inference_params(), loop.trainer.inference_params(), lr)
    # Replaying again continues from there (the step counter restarts, the
    # state does not).
    more = graph.trainer.training_steps(_pick_step, n, data)
    want = torch.stack([loop.training_step(*_pick_step(data, torch.tensor(k, device=dev))) for k in range(n)])
    assert float(((more - want).abs() / want.abs()).max()) <= 1e-3


def test_training_steps_draws_anew_each_replay(dev):
    """A generator in ``data`` is registered with the graph: each replay
    draws another batch, the same batches an uncaptured loop draws from the
    same seed, and the warm-up before the capture draws nothing that
    counts."""
    cfg = dict(GRAPH_CONFIG, optimizer={"otype": "Adam", "learning_rate": 1e-2})
    m = tt.create_from_config(2, 3, cfg)
    n, batch = 3, 4096
    seen = torch.zeros((2 * n, batch, 2), device=dev)
    from tcnn_tpu_torch.utils.sampling import stratified_uniform

    def batch_fn(d, i):
        x = stratified_uniform(batch, 2, d["gen"])
        seen.index_copy_(0, (i + d["base"]).reshape(1).to(torch.int64), x.reshape(1, batch, 2))
        return x, x[:, :1].expand(batch, 3) * 0.5

    data = {"gen": torch.Generator(device=dev).manual_seed(11), "base": torch.zeros((), dtype=torch.int32,
                                                                                  device=dev)}
    m.trainer.training_steps(batch_fn, n, data)
    data["base"].fill_(n)
    m.trainer.training_steps(batch_fn, n, data)
    torch.cuda.synchronize()
    ref = torch.Generator(device=dev).manual_seed(11)
    want = torch.stack([stratified_uniform(batch, 2, ref) for _ in range(2 * n)])
    assert torch.equal(seen, want)
    assert not torch.equal(seen[0], seen[1])


def test_training_steps_learning_rate_after_capture(dev):
    """A learning rate set after a capture takes effect: at 0 the captured
    Adam leaves the params as they are while its step count runs on."""
    cfg = dict(GRAPH_CONFIG, optimizer={"otype": "Adam", "learning_rate": 1e-2, "l2_reg": 0.0})
    m = tt.create_from_config(2, 3, cfg)
    data = _graph_data(dev, 2)
    m.trainer.training_steps(_pick_step, 2, data)
    p = m.params.clone()
    m.trainer.learning_rate = 0.0
    m.trainer.training_steps(_pick_step, 2, data)
    torch.cuda.synchronize()
    assert torch.equal(m.params, p) and int(m.trainer.opt_state["step"]) == 4
    m.trainer.update_hyperparams({"optimizer": {"learning_rate": 1e-2}})
    m.trainer.training_steps(_pick_step, 2, data)
    assert not torch.equal(m.params, p)


def test_training_steps_new_data_captures_again(dev):
    """The same batch_fn with new tensors in ``data`` captures again: the
    graph would otherwise read the first call's tensors."""
    cfg = dict(GRAPH_CONFIG, optimizer={"otype": "Adam", "learning_rate": 1e-2})
    graph, loop = (tt.create_from_config(2, 3, cfg, seed=5) for _ in range(2))
    for seed in (1, 2):
        data = _graph_data(dev, 2, seed=seed)
        got = graph.trainer.training_steps(_pick_step, 2, data)
        want = torch.stack([loop.training_step(*_pick_step(data, torch.tensor(k, device=dev))) for k in range(2)])
        assert float(((got - want).abs() / want.abs()).max()) <= 1e-4
    assert len(graph.trainer._graphs) == 1


def test_training_steps_raises_where_capture_fails(dev):
    """A batch_fn that reads the step on the host cannot be captured: the
    call raises, and does not fall back to a loop. The default generator
    and the one in ``data``, which the capture registered, then draw again
    from where they were."""
    cfg = dict(GRAPH_CONFIG, optimizer={"otype": "Adam"})
    m = tt.create_from_config(2, 3, cfg)
    gen = torch.Generator(device=dev).manual_seed(7)
    data = dict(_graph_data(dev, 2), gen=gen)
    before = torch.cuda.get_rng_state(dev), gen.get_state()
    with pytest.raises(RuntimeError):
        m.trainer.training_steps(lambda d, i: _pick_step(d, torch.tensor(int(i), device=dev)), 2, data)
    torch.cuda.synchronize()
    assert torch.equal(torch.cuda.get_rng_state(dev), before[0]) and torch.equal(gen.get_state(), before[1])
    assert torch.rand(4, device=dev).shape == torch.rand(4, generator=gen, device=dev).shape == (4,)


def _sh_route_counts():
    return dict(sh_encode.ROUTE_LAUNCHES)


def _sh_moved(before, kernel, which):
    """The route counts moved by exactly one launch of ``kernel`` on ``which``."""
    after = _sh_route_counts()
    want = dict(before)
    want[(kernel, which)] = want.get((kernel, which), 0) + 1
    return {k: v for k, v in after.items() if v} == {k: v for k, v in want.items() if v}


@pytest.mark.parametrize("which", ["vector", "staged"])
@pytest.mark.parametrize("strided", [True, False])
@pytest.mark.parametrize("degree", range(1, 9))
@pytest.mark.parametrize("batch", [1, 31, 129, 4099, 2**18 + 7])
def test_sh_encode_kernel_matches_plain(dev, degree, batch, strided, which):
    """tcnn_sh_forward (prepended padding, fp32 and bf16) and
    tcnn_sh_backward_input (bf16 and fp32 dL/dy) against their plain
    versions on each route: the padding that fills the last 16-byte vector
    of a row in both types takes the vector route, one column more the
    staged one; the positions a strided (B, 6)[:, 3:] view or contiguous.
    Each launch moves its route's count; two calls give the same bits."""
    gen = torch.Generator(device=dev).manual_seed(degree * 1000 + batch)
    wide = torch.rand((batch, 6), generator=gen, device=dev)
    x = wide[:, 3:] if strided else wide[:, :3].contiguous()
    pad = (-degree * degree) % 8 + (which == "staged")
    want = sh_encode.sh_encode_plain(x, degree, pad, 1.0, torch.float32)
    before, counts = sh_encode.LAUNCHES, _sh_route_counts()
    got = sh_encode.sh_encode(x, degree, pad, 1.0, torch.float32)
    assert sh_encode.LAUNCHES == before + 1 and _sh_moved(counts, "forward", which)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale
    assert torch.equal(got, sh_encode.sh_encode(x, degree, pad, 1.0, torch.float32))
    counts = _sh_route_counts()
    got16 = sh_encode.sh_encode(x, degree, pad, 1.0, torch.bfloat16).float()
    assert _sh_moved(counts, "forward", which)
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
    assert bool(((got16 - want).abs() <= ulp + 1e-5 * scale).all())
    assert bool((got16[:, :pad] == 1.0).all())
    for dy_dtype in (torch.float32, torch.bfloat16):
        dy = torch.randn((batch, pad + degree * degree), generator=gen, device=dev).to(dy_dtype)
        counts = _sh_route_counts()
        got_dx = sh_encode.sh_backward_input(x, dy, degree, pad)
        assert _sh_moved(counts, "backward", which)
        want_dx = sh_encode.sh_backward_input_plain(x, dy, degree, pad)
        assert float((got_dx - want_dx).abs().max()) <= 1e-5 * max(float(want_dx.abs().max()), 1e-30)
        assert torch.equal(got_dx, sh_encode.sh_backward_input(x, dy, degree, pad))


@pytest.mark.parametrize("dy_dtype", [torch.float32, torch.bfloat16])
def test_sh_backward_misaligned_dy_takes_the_staged_route(dev, dy_dtype):
    """A dL/dy whose rows are whole vectors but which starts 4 or 2 bytes
    past a 16-byte boundary goes to the staged kernel, and agrees with the
    plain version."""
    gen = torch.Generator(device=dev).manual_seed(3)
    batch, degree, pad = 4099, 3, 7
    x = torch.rand((batch, 6), generator=gen, device=dev)[:, 3:]
    dy = torch.randn((batch * 16 + 1,), generator=gen, device=dev).to(dy_dtype)[1:].view(batch, 16)
    assert dy.data_ptr() % 16 != 0
    counts = _sh_route_counts()
    got = sh_encode.sh_backward_input(x, dy, degree, pad)
    assert _sh_moved(counts, "backward", "staged")
    want = sh_encode.sh_backward_input_plain(x, dy, degree, pad)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("degree", range(1, 9))
def test_sh_forward_routes_give_the_same_bits(dev, degree, out_dtype):
    """At a width both routes take, tcnn_sh_forward_vector and the staged
    tcnn_sh_forward (called through their C entry points) write the same
    bits: the same _rn arithmetic in the same order."""
    from tcnn_tpu_torch.ops._build import kernel, stream

    gen = torch.Generator(device=dev).manual_seed(degree)
    batch, pad = 2**16 + 3, (-degree * degree) % 8 + 8
    x = torch.rand((batch, 6), generator=gen, device=dev)[:, 3:]
    outs = []
    for which in ("vector", "staged"):
        out = torch.empty((batch, pad + degree * degree), dtype=out_dtype, device=dev)
        err = kernel("sh_encode", sh_encode.SYMBOLS[("forward", which)], sh_encode._FWD_ARGS)(
            x.data_ptr(), x.stride(0), out.data_ptr(), batch, degree, pad, out.shape[1], 0.25,
            int(out_dtype == torch.bfloat16), stream(dev.index or 0))
        assert err == 0
        outs.append(out)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])


def test_sh_second_order_takes_the_first_order_from_the_kernel(dev):
    """With create_graph the first-order dL/dx still comes from
    tcnn_sh_backward_input (one launch, within 1e-5 of max |plain|); its
    own gradient is the plain chain's, as through apply_plain (within 1e-4
    of max |plain|: it is taken at the kernel's dL/dy and dL/dx)."""
    from tcnn_tpu_torch.encodings import create_encoding

    enc = create_encoding(3, {"otype": "SphericalHarmonics", "degree": 4}, alignment=16)
    enc.output_dtype = torch.float32  # both paths then differentiate the same fp32 values
    x = torch.rand((4099, 3), generator=torch.Generator(device=dev).manual_seed(11), device=dev)
    grads = {}
    for name, fn in (("kernel", enc.apply), ("plain", enc.apply_plain)):
        xx = x.clone().requires_grad_(True)
        before = sh_encode.BWD_LAUNCHES
        (dx,) = torch.autograd.grad((fn(torch.zeros(0), xx).float() ** 2).sum(), xx, create_graph=True)
        assert sh_encode.BWD_LAUNCHES == before + (name == "kernel")
        (ddx,) = torch.autograd.grad((dx**2).sum(), xx)
        grads[name] = dx.detach(), ddx
    for (got, want), rtol in zip(zip(grads["kernel"], grads["plain"]), (1e-5, 1e-4)):
        assert float((got - want).abs().max()) <= rtol * float(want.abs().max())


def test_nerf_composite_model_kernel_matches_plain(dev):
    """The NeRF sample's model on the card: apply (grid lookup, SH kernel,
    fused MLP) against apply_plain, and the parameter gradient."""
    from tcnn_tpu_torch.samples import nerf_synthetic as ns

    m = tt.create_from_config(6, 4, ns.CONFIG, device="cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.rand((4096, 6), generator=gen, device=dev)
    counts = sh_encode.LAUNCHES, grid_encode.LAUNCHES, ffmlp.LAUNCHES
    got = m.model.apply(m.params, x)
    assert (sh_encode.LAUNCHES, grid_encode.LAUNCHES, ffmlp.LAUNCHES) == tuple(c + 1 for c in counts)
    _close_bf16(got, m.model.apply_plain(m.params, x))
    out = ns.render(ns.model_field(m.model.apply, m.params), *ns.make_rays(torch.rand((64, 2), device=dev)))
    assert out.shape == (64, 3) and torch.isfinite(out).all()


# The grid extras: the Rng hash (kRng in csrc/grid_common.cuh's corner(),
# so the lookup, the table gradient, G1 and G2 alike), fixed_point_pos
# (uint32 positions: the lookup and the table gradient) and stochastic
# interpolation's table gradient (one corner per (sample, level) for the
# uniforms u), each against its plain version on the same inputs.
EXTRAS_GRID = {"otype": "HashGrid", "n_levels": 8, "n_features_per_level": 2, "log2_hashmap_size": 12,
               "base_resolution": 8, "per_level_scale": 1.5}


def _fixed_positions(rng, n, d, dev):
    x = rng.integers(0, 2**32, (n, d), dtype=np.uint64)
    x[:64] = 0
    x[64:128] = 2**32 - 1
    return torch.from_numpy(x.astype(np.int64)).to(torch.uint32).to(dev)


def _rng_edge_points(enc, rng, n_dims):
    """Points that put an Rng level's cell outside the field-decomposed
    jump's condition (csrc/grid_common.cuh:rng_corners): grid position
    0xFFFFFFFF (x = -1 / scale) in one dim and in all, on every Rng level;
    coordinates of 2^22 and more (large x). Asserts that both occur."""
    lt = enc.level_table()
    rows = lt[lt[:, 2] == grid_encode.MODE_RNG]
    scales = rows[:, 3].view(np.float32).astype(np.float64)
    base = rng.uniform(0, 1, (len(scales) * (n_dims + 1), n_dims))
    for j, s in enumerate(scales):
        for k in range(n_dims + 1):
            if k < n_dims:
                base[j * (n_dims + 1) + k, k] = -1 / s
            else:
                base[j * (n_dims + 1) + k] = -1 / s
    big = rng.uniform(0, 1, (512, n_dims))
    big[:, 0] = 2.0**22 / scales.min() * rng.uniform(1, 2, 512)
    pts = np.concatenate([base, big]).astype(np.float32)
    cells = [grid_encode._level_cell(torch.from_numpy(pts), row.view(np.uint32).astype(np.int64),
                                     grid_encode.INTERP_LINEAR)[0] & 0xFFFFFFFF for row in rows]
    assert all(bool((c == 0xFFFFFFFF).any()) for c in cells)
    assert any(bool((c >= 2**22).any()) for c in cells)
    return pts


@pytest.mark.parametrize("interp", ["Linear", "Smoothstep"])
@pytest.mark.parametrize("n_dims", [1, 2, 3, 4])
def test_rng_hash_kernels_match_plain(dev, n_dims, interp):
    """The Rng hash in the lookup (fp32: bitwise at d = 1, 2; at d = 3, 4
    rtol 1e-5, atol 1e-6, where torch's reduction adds the corners or
    multiplies the weights in another order, 1-2 ulps apart), the table
    gradient (level by level in its classes) and G1 / G2 (``_close_f32``):
    d = 2, 3 take the whole-cell keys (rng_corners), d = 1, 4 the run-time
    dims' per-corner jump; among the points those whose Rng cells take the
    per-corner path (grid position 0xFFFFFFFF, large x). Then the same hash
    with fixed_point_pos (uint32 positions: the lookup as above, the table
    gradient in its classes)."""
    cfg = dict(EXTRAS_GRID, hash="Rng", interpolation=interp, **({"log2_hashmap_size": 6} if n_dims == 1 else {}))
    enc = create_encoding(n_dims, cfg, alignment=16)
    enc.output_dtype = torch.float32
    levels = enc._levels_on(dev)
    assert int((levels[:, 2] == grid_encode.MODE_RNG).sum()) >= 2
    rng = np.random.default_rng(n_dims)
    x_np = rng.uniform(-0.2, 1.2, (30_001, n_dims)).astype(np.float32)
    x = torch.from_numpy(np.concatenate([x_np, _rng_edge_points(enc, rng, n_dims)])).to(dev)
    n = len(x)
    params = torch.from_numpy(rng.uniform(-1, 1, enc.n_params).astype(np.float32)).to(dev)
    tol = {"rtol": 0, "atol": 0} if n_dims <= 2 else {"rtol": 1e-5, "atol": 1e-6}
    torch.testing.assert_close(enc.apply(params, x), enc.apply_plain(params, x), **tol)
    dy = torch.from_numpy(rng.normal(0, 1, (n, enc.padded_output_width)).astype(np.float32)).to(dev).bfloat16()
    classes = torch.from_numpy(enc.gradient_classes(n)).to(dev)
    classes[1::2] = torch.tensor([scatter_rows.CONTRIB_SR, scatter_rows.ACC_BF16], dtype=torch.int32)
    rng_route = ("grid_bwd_rng", "tcnn_grid_backward_rng") if n_dims in (2, 3) else ("grid_bwd", "tcnn_grid_backward")
    _check_levels(enc, _table_grad(enc, x, dy, classes, route=rng_route), x, dy, classes)
    args = (levels, 2, _interp_code(enc))
    f32 = torch.from_numpy(enc.gradient_classes(n)).to(dev)
    cgx = torch.from_numpy(rng.normal(0, 1, (n, n_dims)).astype(np.float32)).to(dev)
    cgp = torch.from_numpy(rng.normal(0, 1, enc.n_params).astype(np.float32)).to(dev)
    _close_f32(grid_encode.grid_backward_input(x, dy, params, *args),
               grid_encode.grid_backward_input_plain(x, dy, params, *args))
    got = grid_encode.grid_backward_backward(x, dy, params, *args, f32, cgp, cgx)
    want = grid_encode.grid_backward_backward_plain(x, dy, params, *args, f32, cgp, cgx)
    for a, b in zip(got, want):
        _close_f32(a, b)
    # fixed_point_pos: the lookup's kExtras instantiation (whole-cell keys
    # at d = 2, 3), the table gradient's (per corner; uint32 positions with
    # an Rng level stay there at every d).
    encf = create_encoding(n_dims, dict(cfg, fixed_point_pos=True), alignment=16)
    encf.output_dtype = torch.float32
    xf = _fixed_positions(rng, 8192, n_dims, dev)
    torch.testing.assert_close(encf.apply(params, xf), encf.apply_plain(params, xf), **tol)
    dyf = dy[: len(xf)].contiguous()
    classes_f = torch.from_numpy(encf.gradient_classes(len(xf))).to(dev)
    _check_levels(encf, _table_grad(encf, xf, dyf, classes_f, route=("grid_bwd", "tcnn_grid_backward")), xf, dyf,
                  classes_f)


@pytest.mark.parametrize("over", [{}, {"interpolation": "Smoothstep", "hash": "Rng"}, {"n_features_per_level": 4},
                                  {"gather_strategy": "quad", "table_dtype": "bfloat16"}], ids=str)
@pytest.mark.parametrize("n_dims", [2, 3, 1])
def test_fixed_point_kernels_match_plain(dev, n_dims, over):
    """uint32 positions (with 0 and 2^32 - 1 among them) through the lookup
    (fp32 rtol 1e-5, atol 1e-6; bf16 output within 4 bf16 ulps) and the
    table gradient (its classes, and every level (RN, bf16)), which takes
    grid_bwd_modes' fixed-point instantiation without Rng levels at d = 2,
    3, else grid_bwd's kExtras one."""
    enc = create_encoding(n_dims, dict(EXTRAS_GRID, fixed_point_pos=True, **over), alignment=16)
    enc.output_dtype = torch.float32
    rng = np.random.default_rng(10 + n_dims)
    n = 20_000
    x = _fixed_positions(rng, n, n_dims, dev)
    params = torch.from_numpy(rng.uniform(-1, 1, enc.n_params).astype(np.float32)).to(dev)
    before = grid_encode.LAUNCHES
    got = enc.apply(params, x)
    assert grid_encode.LAUNCHES == before + 1
    want = enc.apply_plain(params, x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    enc.output_dtype = torch.bfloat16
    _close_bf16(enc.apply(params, x), want)
    dy = torch.from_numpy(rng.normal(0, 1, (n, enc.padded_output_width)).astype(np.float32)).to(dev).bfloat16()
    own = n_dims in (2, 3) and over.get("hash") != "Rng"
    route = ("grid_bwd_modes", "tcnn_grid_backward_fixed") if own else ("grid_bwd", "tcnn_grid_backward")
    for classes in (torch.from_numpy(enc.gradient_classes(n)).to(dev),
                    torch.tensor([[scatter_rows.CONTRIB_RN, scatter_rows.ACC_BF16]] * enc.n_levels,
                                 dtype=torch.int32, device=dev)):
        _check_levels(enc, _table_grad(enc, x, dy, classes, route=route), x, dy, classes)
    with pytest.raises(ValueError, match="float32"):
        grid_encode.grid_backward_input(x, dy, params, enc._levels_on(dev), enc.n_features_per_level,
                                        _interp_code(enc))


@pytest.mark.parametrize("case", ["fp32", "bf16", "3d-smoothstep", "nearest"])
def test_stochastic_table_gradient_matches_plain(dev, case):
    """One corner per (sample, level) for the same uniforms u in kernel and
    plain version: the fp32 class, the (RN, bf16) class (bf16 sums), d = 3
    with Smoothstep and F = 4 (float4 adds), and Nearest (no u: the
    deterministic one-corner gradient); a stratified flagship-like batch,
    where long runs of lanes share rows and levels are privatised. With u
    the launch takes grid_bwd_modes' sampled instantiation, without it the
    common one."""
    from tcnn_tpu_torch.utils.sampling import stratified_uniform

    d = 3 if case == "3d-smoothstep" else 2
    over = {"3d-smoothstep": {"interpolation": "Smoothstep", "n_features_per_level": 4},
            "nearest": {"interpolation": "Nearest"}}.get(case, {})
    enc = create_encoding(d, dict(FLAGSHIP_GRID, stochastic_interpolation=True, **over), alignment=16)
    gen = torch.Generator(device=dev).manual_seed(31)
    n = 2**18 if d == 2 else 64**3
    x = stratified_uniform(n, d, gen, device=dev)
    dy = torch.randn((n, enc.padded_output_width), generator=gen, device=dev).bfloat16()
    u = enc._uniforms(gen, n, dev)
    assert (u is None) == (case == "nearest")
    classes = torch.from_numpy(enc.gradient_classes(n, stratified=False)).to(dev)
    if case == "bf16":
        classes[:] = torch.tensor([scatter_rows.CONTRIB_RN, scatter_rows.ACC_BF16], dtype=torch.int32)
    common, sampled = ("grid_bwd", "tcnn_grid_backward"), ("grid_bwd_modes", "tcnn_grid_backward_sampled")
    route = common if u is None else sampled
    got = _table_grad(enc, x, dy, classes, u, route=route)
    _check_levels(enc, got, x, dy, classes, u)
    if u is not None:
        det = _table_grad(enc, x, dy, classes, route=common)
        assert int((got != 0).sum()) < int((det != 0).sum())
    # Through the encoding: a generator on the card draws u; the forward is
    # the deterministic lookup.
    p = torch.zeros(enc.n_params, device=dev, requires_grad=True)
    before = (grid_encode.LAUNCHES, *_route_launches(route))
    (g,) = torch.autograd.grad(enc.apply(p, x, rng=gen).float().sum(), p)
    assert (grid_encode.LAUNCHES, *_route_launches(route)) == (before[0] + 1, before[1] + 1, before[2] + 1)
    assert torch.isfinite(g).all() and g.any()


# -- the sample paths: the captured ray march, the SDF sample's step, the
# host sampler's native build ---------------------------------------------


@pytest.mark.parametrize("tables", ["sample", "random"])
def test_marcher_replay_matches_the_march(dev, tables):
    """One ``Marcher`` replay (one CUDA graph of all the steps) against the
    eager march through the kernels (bit for bit) and through the plain
    versions (colour within 2.25 and transmittance within 1 times 4 bf16
    ulps of max |raw|: the MLP outputs agree to 4 ulps, sigmoid' <= 1/4,
    softplus' and exp' <= 1, the steps' alpha * dt sum to 1); replays
    repeat bit for bit; each kernel launches 2 x n_steps times at
    construction (warm-up and capture) and never in a replay."""
    from tcnn_tpu_torch.samples import fused_ray_marcher as fm

    model, params = fm.make_model(dev)
    origins, dirs = fm.make_rays(1024, dev)
    if tables == "random":
        rng = np.random.default_rng(3)
        n_net = model.network.n_params
        params = torch.from_numpy(np.concatenate([rng.uniform(-0.3, 0.3, n_net), rng.uniform(
            -2, 2, model.n_params - n_net)]).astype(np.float32)).to(dev)
        dirs = dirs + torch.from_numpy(rng.uniform(-0.3, 0.3, (1024, 3)).astype(np.float32)).to(dev)
    n_steps = 16
    before = (grid_encode.LAUNCHES, ffmlp.LAUNCHES)
    marcher = fm.Marcher(model, params, 1024, n_steps)
    assert (grid_encode.LAUNCHES, ffmlp.LAUNCHES) == (before[0] + 2 * n_steps, before[1] + 2 * n_steps)
    a = marcher(origins, dirs)
    b = marcher(origins, dirs)
    assert (grid_encode.LAUNCHES, ffmlp.LAUNCHES) == (before[0] + 2 * n_steps, before[1] + 2 * n_steps)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    eager = fm.render_plain(model, params, origins, dirs, n_steps)
    assert all(torch.equal(u, v) for u, v in zip(a, eager))
    plain = fm.render_plain(model, params, origins, dirs, n_steps, plain=True)
    with torch.no_grad():
        top = max(float(model.apply_plain(params, origins + dirs * ((i + 0.5) / n_steps)).float().abs().max())
                  for i in range(n_steps))
    ulp4 = 4 * 2.0 ** (np.floor(np.log2(top)) - 7)
    assert float((a[0] - plain[0]).abs().max()) <= 2.25 * ulp4
    assert float((a[1] - plain[1]).abs().max()) <= ulp4


def test_sdf_sample_step_matches_plain(dev):
    """The SDF sample's total loss and parameter gradient at 8192 points,
    kernels against plain versions: the loss terms within 1e-3 relative,
    each part of the gradient within 1e-2 of the norm (the bf16 network's
    roundings flip where its fp32 inputs differ in the last bits); then one
    step from the same state moves each param by at most 2 lr apart (Adam's
    first step is ~lr x sign(grad)), at most 1% of them apart."""
    from tcnn_tpu_torch.samples import sdf_learning as ss

    m = tt.create_from_config(3, 1, ss.CONFIG, device=dev)
    x, d = ss.draw(8192, torch.Generator(device=dev).manual_seed(5))
    params = m.model.params
    out = {}
    for plain in (False, True):
        before = (grid_encode.INPUT_LAUNCHES, grid_encode.BWDBWD_LAUNCHES)
        loss, (data, eik) = ss.total_loss(m.model, params, x, d, plain=plain)
        (g,) = torch.autograd.grad(loss, params)
        moved = (grid_encode.INPUT_LAUNCHES - before[0], grid_encode.BWDBWD_LAUNCHES - before[1])
        assert (moved == (0, 0)) if plain else min(moved) >= 1
        out[plain] = (torch.stack([loss, data, eik]).detach(), g)
    assert torch.allclose(out[False][0], out[True][0], rtol=1e-3, atol=0)
    n_net = m.model.network.n_params
    for sl in (slice(0, n_net), slice(n_net, None)):
        a, b = out[False][1][sl], out[True][1][sl]
        assert torch.isfinite(a).all() and float((a - b).norm()) <= 1e-2 * float(b.norm())
    p0 = params.detach().clone()
    s0 = {k: v.clone() for k, v in m.trainer.opt_state.items()}
    ss.train_step(m, x, d)
    p_k = params.detach().clone()
    with torch.no_grad():
        params.copy_(p0)
    m.trainer.opt_state = s0
    ss.train_step(m, x, d, plain=True)
    diff = (p_k - params.detach()).abs()
    lr = float(m.trainer.learning_rate)
    assert float(diff.max()) <= 2 * lr * 1.0001 and float((diff > 1e-6).float().mean()) <= 1e-2


def test_host_sampler_builds_natively(dev):
    """On the card's machine the host sampler's helper builds and runs: its
    batches follow the contract (rgb the pixel at xy, stratified)."""
    from tcnn_tpu_torch.runtime import native
    from tcnn_tpu_torch.utils.data import HostImageSampler
    from tcnn_tpu_torch.utils.sampling import is_stratified

    image = np.random.default_rng(0).random((64, 96, 3)).astype(np.float32)
    with HostImageSampler(image, 1024, stratified=True, seed=3) as s:
        assert s.native, native.build_error
        xy, rgb = s.next()
    px = np.minimum((xy[:, 0] * 96).astype(np.int64), 95)
    py = np.minimum((xy[:, 1] * 64).astype(np.int64), 63)
    np.testing.assert_array_equal(rgb, image[py, px])
    assert is_stratified(xy)


# -- the windowed kernels of a row-sharded table (csrc/grid_sharded.cu) ------

_WINDOWED_CASES = {
    "2d-linear": (2, {"otype": "HashGrid", "n_levels": 16, "n_features_per_level": 2, "log2_hashmap_size": 15,
                      "base_resolution": 16, "per_level_scale": 1.5, "hash": "CoherentAdditive"}),
    "3d-smoothstep-prime": (3, {"otype": "HashGrid", "n_levels": 8, "n_features_per_level": 2,
                                "log2_hashmap_size": 14, "base_resolution": 8, "per_level_scale": 1.7,
                                "interpolation": "Smoothstep", "hash": "Prime"}),
    "2d-nearest-f4": (2, {"otype": "HashGrid", "n_levels": 6, "n_features_per_level": 4, "log2_hashmap_size": 12,
                          "base_resolution": 4, "per_level_scale": 1.9, "interpolation": "Nearest"}),
    "3d-rng": (3, {"otype": "HashGrid", "n_levels": 6, "n_features_per_level": 2, "log2_hashmap_size": 12,
                   "base_resolution": 8, "per_level_scale": 1.5, "hash": "Rng"}),
    "1d": (1, {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2, "log2_hashmap_size": 10,
               "base_resolution": 8, "per_level_scale": 2.0}),
}


@pytest.mark.parametrize("n_shards", [2, 3])
@pytest.mark.parametrize("case", list(_WINDOWED_CASES))
def test_windowed_kernels_match_plain(dev, case, n_shards):
    """Every shard's windowed lookup (fp32: max |diff| <= 1e-5 of max
    |plain|, the same products in the same corner order) and windowed table
    gradient (fp32 atomics: 1e-5 of max |plain|) against their plain
    versions on the card, each launch moving its count."""
    from tcnn_tpu_torch.encodings.grid import _INTERP_CODES
    from tcnn_tpu_torch.ops.scatter_rows import ACC_F32, CONTRIB_NONE
    from tcnn_tpu_torch.parallel import TableParallelGrid

    n_dims, cfg = _WINDOWED_CASES[case]
    enc = create_encoding(n_dims, cfg, alignment=16)
    F, L = enc.n_features_per_level, enc.n_levels
    interp = _INTERP_CODES[enc.interpolation_type]
    rng = np.random.default_rng(n_shards)
    x = torch.from_numpy(rng.uniform(0, 1, (4099, n_dims)).astype(np.float32)).to(dev)
    params = rng.uniform(-1, 1, enc.n_params).astype(np.float32)
    dy = torch.from_numpy(rng.normal(0, 1, (4099, L * F)).astype(np.float32)).to(dev)
    classes = torch.tensor([[CONTRIB_NONE, ACC_F32]] * L, dtype=torch.int32, device=dev)
    for shard in range(n_shards):
        tpg = TableParallelGrid(enc, None, shard=(shard, n_shards))
        levels, windows = tpg._tables_on(dev)
        local = torch.from_numpy(tpg.local_params(params)).to(dev)
        n0 = grid_encode.WINDOWED_LAUNCHES
        r0 = grid_encode.BWD_ROUTE_LAUNCHES.get(grid_encode.WINDOWED_BWD_ROUTE, 0)
        got = grid_encode.grid_encode_windowed(x, local, levels, windows, F, interp)
        assert grid_encode.WINDOWED_LAUNCHES == n0 + 1
        want = grid_encode.grid_encode_plain(x, local, levels, F, L * F, interp, torch.float32, windows)
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
        for dy_ in (dy, dy.bfloat16()):
            g = grid_encode.grid_backward_windowed(x, dy_, levels, windows, F, interp)
            gp = grid_encode.grid_backward_plain(x, dy_, levels, F, interp, classes, window=windows)
            assert g.shape == gp.shape == (tpg.local_n_params,)
            assert float((g - gp).abs().max()) <= 1e-5 * float(gp.abs().max())
        assert grid_encode.BWD_ROUTE_LAUNCHES[grid_encode.WINDOWED_BWD_ROUTE] == r0 + 2


def test_windowed_kernels_need_the_windows_after_the_table(dev):
    from tcnn_tpu_torch.parallel import TableParallelGrid

    enc = create_encoding(2, _WINDOWED_CASES["2d-linear"][1], alignment=16)
    tpg = TableParallelGrid(enc, None, shard=(0, 2))
    levels, windows = tpg._tables_on(dev)
    x = torch.rand((64, 2), device=dev)
    local = torch.zeros(tpg.local_n_params, device=dev)
    with pytest.raises(ValueError, match="follow the level table"):
        grid_encode.grid_encode_windowed(x, local, levels, windows.clone(), 2, grid_encode.INTERP_LINEAR)


@pytest.mark.parametrize("n_shards", [2, 3])
@pytest.mark.parametrize("case", list(_WINDOWED_CASES))
def test_windowed_input_gradient_and_double_backward_match_plain(dev, case, n_shards):
    """Every shard's windowed G1 and G2 against their plain versions on the
    card (fp32 as ``_close_f32``; G2's local table gradient, fp32 atomics,
    within 1e-5 of max |plain|), at uniform points, points outside [0, 1]
    and cell boundaries +-1 ulp; G2 with both cotangents, each alone; each
    launch moving its count."""
    from tcnn_tpu_torch.parallel import TableParallelGrid

    n_dims, cfg = _WINDOWED_CASES[case]
    enc = create_encoding(n_dims, cfg, alignment=16)
    F, L = enc.n_features_per_level, enc.n_levels
    interp = _interp_code(enc)
    rng = np.random.default_rng(10 + n_shards)
    x = torch.from_numpy(_lookup_points(enc, rng, 4099)).to(dev)
    n = x.shape[0]
    params = rng.uniform(-1, 1, enc.n_params).astype(np.float32)
    dy = torch.from_numpy(rng.normal(0, 1, (n, L * F)).astype(np.float32)).to(dev)
    cgx = torch.from_numpy(rng.normal(0, 1, (n, n_dims)).astype(np.float32)).to(dev)
    for shard in range(n_shards):
        tpg = TableParallelGrid(enc, None, shard=(shard, n_shards))
        levels, windows = tpg._tables_on(dev)
        local = torch.from_numpy(tpg.local_params(params)).to(dev)
        cgp = torch.from_numpy(rng.normal(0, 1, tpg.local_n_params).astype(np.float32)).to(dev)
        n0 = (grid_encode.WINDOWED_INPUT_LAUNCHES, grid_encode.WINDOWED_BWDBWD_LAUNCHES)
        dx = grid_encode.grid_backward_input_windowed(x, dy, local, levels, windows, F, interp)
        _close_f32(dx, grid_encode.grid_backward_input_plain(x, dy, local, levels, F, interp, windows))
        cases = ((cgp, cgx), (None, cgx), (cgp, None))
        for cp, cx in cases:
            got = grid_encode.grid_backward_backward_windowed(x, dy, local, levels, windows, F, interp, cp, cx)
            want = grid_encode.grid_backward_backward_windowed(x.cpu(), dy.cpu(), local.cpu(), levels.cpu(),
                                                               windows.cpu(), F, interp,
                                                               None if cp is None else cp.cpu(),
                                                               None if cx is None else cx.cpu())
            _close_f32(got[1], want[1].to(dev))
            _close_f32(got[2], want[2].to(dev))
            if cx is None:
                assert got[0] is None and want[0] is None
            else:
                assert got[0].shape == (tpg.local_n_params,)
                e = float((got[0] - want[0].to(dev)).abs().max())
                assert e <= 1e-5 * float(want[0].abs().max()) + 1e-30
        assert (grid_encode.WINDOWED_INPUT_LAUNCHES, grid_encode.WINDOWED_BWDBWD_LAUNCHES) == (n0[0] + 1,
                                                                                            n0[1] + len(cases))


def test_windowed_second_order_takes_fp32_dy_only(dev):
    from tcnn_tpu_torch.parallel import TableParallelGrid

    enc = create_encoding(2, _WINDOWED_CASES["2d-linear"][1], alignment=16)
    tpg = TableParallelGrid(enc, None, shard=(0, 2))
    levels, windows = tpg._tables_on(dev)
    x = torch.rand((64, 2), device=dev)
    local = torch.zeros(tpg.local_n_params, device=dev)
    dy = torch.zeros((64, 32), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        grid_encode.grid_backward_input_windowed(x, dy, local, levels, windows, 2, grid_encode.INTERP_LINEAR)


@pytest.mark.parametrize("fixed", [False, True], ids=["fp32", "fixed_point_pos"])
@pytest.mark.parametrize("n_dims", [2, 3, 4])
@pytest.mark.parametrize("F", [1, 2, 4, 8])
def test_sampled_gather_is_bitwise_the_plain_gather(dev, F, n_dims, fixed):
    """tcnn_grid_forward_sampled against its plain version (the corner
    _sampled_corner picks, gathered): the same rows, so the same bits, at
    compiled (d 2, 3) and run-time (4) dims, uint32 and fp32 positions,
    cell boundaries +-1 ulp (where u < w_d decides the corner), a table
    read rounded to bf16 by its level table, the padding zeros."""
    over = {"n_features_per_level": F, "fixed_point_pos": fixed, "table_dtype": "bfloat16",
            "interpolation": "Smoothstep" if n_dims == 3 else "Linear"}
    enc = create_encoding(n_dims, dict(SECOND_ORDER_GRID, **over), alignment=16)
    rng = np.random.default_rng(F * 10 + n_dims)
    if fixed:
        x_np = rng.integers(0, 2**32, (3037, n_dims), dtype=np.uint64).astype(np.uint32)
        x = torch.from_numpy(x_np.astype(np.int64)).to(torch.uint32).to(dev)
    else:
        x = torch.from_numpy(_lookup_points(enc, rng, 3037)).to(dev)
    n = x.shape[0]
    table = torch.from_numpy(rng.normal(0, 1, enc.n_params).astype(np.float32)).to(dev)
    u = torch.from_numpy(rng.uniform(0, 1, (n, enc.n_levels)).astype(np.float32)).to(dev)
    levels = enc._levels_on(dev)
    assert (levels[:, grid_encode._OWN_COL] != grid_encode.ROUND_NONE).any()
    width = enc.padded_output_width
    n0 = grid_encode.SAMPLED_LAUNCHES
    got = grid_encode.grid_encode_sampled(x, table, levels, u, F, width, _interp_code(enc))
    assert grid_encode.SAMPLED_LAUNCHES == n0 + 1
    want = grid_encode.grid_encode_sampled_plain(x, table, levels, u, F, width, _interp_code(enc))
    assert got.shape == (n, width) and torch.equal(got, want)


def test_fixed_point_cotangent_lookup_matches_plain(dev):
    """The cgp term of uint32 positions on the card: the lookup kernel with
    the cotangent as its table (fp32 out), a dropped level's columns
    zeroed, against the plain lookup (fp32 as ``_close_f32``)."""
    enc = create_encoding(2, dict(SECOND_ORDER_GRID, fixed_point_pos=True), alignment=16)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, 2**32, (4099, 2), dtype=np.uint64).astype(np.int64)).to(torch.uint32).to(dev)
    cgp = torch.from_numpy(rng.normal(0, 1, enc.n_params).astype(np.float32)).to(dev)
    classes = torch.zeros((enc.n_levels, 2), dtype=torch.int32)
    classes[3, 1] = scatter_rows.ACC_DROP
    classes = classes.to(dev)
    args = (enc._levels_on(dev), classes, None, 2, enc.padded_output_width, _interp_code(enc))
    n0 = grid_encode.LAUNCHES
    got = grid_encode._cgp_term(x, cgp, *args, False)
    assert grid_encode.LAUNCHES == n0 + 1
    want = grid_encode._cgp_term(x, cgp, *args, True)
    _close_f32(got, want)
    assert not got[:, 6:8].any()


def test_third_order_on_the_card_launches_g3(dev, monkeypatch):
    """A curvature loss through the module API on the card launches G3
    (``tcnn_grid_backward3``, once) and no plain function of the grid's
    derivatives, and gives what the plain route gives on the CPU from the
    same weights: d/dparams and d/dx within 1e-2 of the norm (a bf16
    network, sums in another order)."""
    from tcnn_tpu_torch import modules

    def refuse(name):
        real = getattr(grid_encode, name)

        def on_cpu_only(x, *args, **kw):
            assert x.device.type == "cpu", f"{name} ran on the card"
            return real(x, *args, **kw)

        monkeypatch.setattr(grid_encode, name, on_cpu_only)

    for name in ("grid_backward_backward_plain", "grid_third_order_plain", "grid_backward_input_plain",
                 "grid_backward_plain", "grid_encode_plain"):
        refuse(name)
    cfg = dict(SECOND_ORDER_GRID, n_levels=6, interpolation="Smoothstep")
    net = {"otype": "FullyFusedMLP", "n_neurons": 32, "n_hidden_layers": 2}
    rng = np.random.default_rng(5)
    x_np = rng.uniform(0, 1, (4096, 3)).astype(np.float32)
    v_np = rng.normal(0, 1, (4096, 3)).astype(np.float32)
    out = []
    for device in (dev, torch.device("cpu")):
        m = modules.NetworkWithInputEncoding(3, 1, cfg, net, seed=3, device=device)
        x = torch.from_numpy(x_np).to(device).requires_grad_(True)
        f = m(x)
        (g,) = torch.autograd.grad(f, x, torch.ones_like(f), create_graph=True)
        (hv,) = torch.autograd.grad((g * torch.from_numpy(v_np).to(device)).sum(), x, create_graph=True)
        n0 = grid_encode.THIRD_LAUNCHES
        gp, gx = torch.autograd.grad((hv * hv).sum(), (m.params, x))
        assert grid_encode.THIRD_LAUNCHES == n0 + (device.type == "cuda")
        out.append((gp.cpu(), gx.cpu()))
    for a, b in zip(*out):
        assert torch.isfinite(a).all() and float((a - b).norm()) <= 1e-2 * float(b.norm())


def _third_operands(enc, x, n_params, rng, subset="all"):
    """G3's cotangents for ``enc`` at the points x (on their device): every
    one ("all") or the curvature loss's (cgx, g_x, g_dy)."""
    dev, n, d = x.device, x.shape[0], enc.n_dims_to_encode
    W = enc.padded_output_width

    def t(shape):
        return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(dev)

    o = {"dy": t((n, W)), "params": torch.from_numpy(rng.uniform(-1, 1, n_params).astype(np.float32)).to(dev),
         "cgp": t(n_params), "cgx": t((n, d)), "g_params": t(n_params), "g_x": t((n, d)), "g_dy": t((n, W))}
    if subset == "curvature":
        o["cgp"] = o["g_params"] = None
    return o


def _third_magnitudes(monkeypatch, call):
    """The per-entry sums of |contribution| of G3's two scatters: ``call``
    (a plain G3 call) with every class scatter replaced by an fp32 scatter
    of the contributions' magnitudes."""
    with monkeypatch.context() as m:
        m.setattr(grid_encode._ClassScatter, "apply",
                  lambda rows, contrib, size, *_: scatter_rows.scatter_rows_plain(rows, contrib.abs(), size))
        out = call()
    return out[0], out[3]


def _check_third_tables(enc, got, plain, exact, mags, classes, windowed_rows=None):
    """G3's d/dparams or d/dcgp level by level: an fp32 level per entry
    within 1e-5 of its sum of |contributions| (atomics add in any order); a
    bf16 level at most twice the plain sequential sum's error against the
    fp32 sum of the same rounded contributions, in norm; a dropped level
    zero."""
    F = enc.n_features_per_level
    assert got.shape == plain.shape and torch.isfinite(got).all()
    offsets = enc.offset_table if windowed_rows is None else windowed_rows
    for lvl in range(enc.n_levels):
        lo, hi = int(offsets[lvl]) * F, int(offsets[lvl + 1]) * F
        g, p, e, s = got[lo:hi], plain[lo:hi], exact[lo:hi], mags[lo:hi]
        acc = int(classes[lvl, 1])
        if acc == scatter_rows.ACC_DROP:
            assert not g.any(), lvl
        elif acc == scatter_rows.ACC_BF16:
            assert float((g - e).norm()) <= 2 * float((p - e).norm()) + 1e-6 * float(e.norm()), lvl
        else:
            assert bool(((g - p).abs() <= 1e-5 * s + 1e-30).all()), lvl


@pytest.mark.parametrize("subset", ["all", "curvature"])
@pytest.mark.parametrize("n_dims", [2, 3, 4])
@pytest.mark.parametrize("F", [1, 2, 4, 8])
def test_grid_third_order_matches_plain(dev, F, n_dims, subset, monkeypatch):
    """G3 (``tcnn_grid_backward3``) against its plain version at compiled
    (d 2, 3) and run-time (4) dims, F 1, 2, 4, 8, bf16 dL/dy, at uniform
    points, points outside [0, 1] and cell boundaries +-1 ulp, with every
    cotangent or the curvature loss's; the class table holds an (RN, bf16),
    an (SR, fp32) and a dropped level. d/dx, d/d(dL_dy) and d/dcgx as
    ``_close_f32``; d/dparams and d/dcgp as ``_check_third_tables``."""
    enc, t = _second_order_inputs(dev, n_dims, F, 16, torch.bfloat16, 0)
    rng = np.random.default_rng(100 * F + 10 * n_dims + len(subset))
    x = torch.from_numpy(_lookup_points(enc, rng, 2048)).to(dev)
    o = _third_operands(enc, x, enc.n_params, rng, subset)
    o["dy"] = o["dy"].bfloat16()
    classes = t["classes"]
    exact_cls = classes.clone()
    exact_cls[t["bf16_level"], 1] = scatter_rows.ACC_F32
    levels, interp = enc._levels_on(dev), _interp_code(enc)
    ops = (x, o["dy"], o["params"], levels, F, interp)
    cots = (o["cgp"], o["cgx"], o["g_params"], o["g_x"], o["g_dy"])
    n0 = grid_encode.THIRD_LAUNCHES
    got = grid_encode.grid_backward3(*ops, classes, *cots)
    assert grid_encode.THIRD_LAUNCHES == n0 + 1
    want = grid_encode.grid_third_order_plain(*ops, classes, *cots)
    exact = grid_encode.grid_third_order_plain(*ops, exact_cls, *cots)
    mags = _third_magnitudes(monkeypatch, lambda: grid_encode.grid_third_order_plain(*ops, classes, *cots))
    for i in (1, 2, 4):
        if want[i] is None:
            assert got[i] is None
        else:
            _close_f32(got[i], want[i])
    for i, s in zip((0, 3), mags):
        if want[i] is None:
            assert got[i] is None
        else:
            _check_third_tables(enc, got[i], want[i], exact[i], s, classes)


@pytest.mark.parametrize("batch", [0, 1, 33])
def test_grid_third_order_batch_sizes(dev, batch):
    """Batches of 0, 1 and 33 samples: the outputs' shapes and values."""
    enc, t = _second_order_inputs(dev, 3, 2, batch, torch.float32, batch)
    rng = np.random.default_rng(batch)
    o = _third_operands(enc, t["x"], enc.n_params, rng)
    ops = (t["x"], o["dy"], o["params"], enc._levels_on(dev), 2, _interp_code(enc), t["classes"],
           o["cgp"], o["cgx"], o["g_params"], o["g_x"], o["g_dy"])
    got = grid_encode.grid_backward3(*ops)
    torch.cuda.synchronize()
    assert got[1].shape == got[4].shape == (batch, 3) and got[2].shape == o["dy"].shape
    assert got[0].shape == got[3].shape == (enc.n_params,)
    if batch == 0:
        assert not got[0].any() and not got[3].any()
        return
    want = grid_encode.grid_third_order_plain(*ops)
    for i in (1, 2, 4):
        _close_f32(got[i], want[i])


def test_grid_third_order_is_deterministic(dev):
    """d/dx, d/d(dL_dy) and d/dcgx take no atomics: two calls on the same
    inputs give the same bits (the 3D model at 2^16 points, in its training
    classes, every cotangent)."""
    enc = create_encoding(3, ENC3D_GRID, alignment=16)
    n = 2**16
    x = torch.rand((n, 3), generator=torch.Generator(device=dev).manual_seed(6), device=dev)
    o = _third_operands(enc, x, enc.n_params, np.random.default_rng(6))
    classes = torch.from_numpy(enc.gradient_classes(n)).to(dev)
    args = (x, o["dy"].bfloat16(), o["params"], enc._levels_on(dev), 2, grid_encode.INTERP_LINEAR, classes,
            o["cgp"], o["cgx"], o["g_params"], o["g_x"], o["g_dy"])
    runs = [grid_encode.grid_backward3(*args) for _ in range(2)]
    for i in (1, 2, 4):
        assert torch.equal(runs[0][i], runs[1][i])


@pytest.mark.parametrize("n_shards", [2, 3])
@pytest.mark.parametrize("case", list(_WINDOWED_CASES))
def test_windowed_third_order_matches_plain(dev, case, n_shards, monkeypatch):
    """Every shard's windowed G3 (``tcnn_grid_backward3_windowed``)
    against its plain version at uniform points, points outside [0, 1] and
    cell boundaries +-1 ulp, with every cotangent: the partials as
    ``_close_f32``, the local d/dparams and d/dcgp (fp32 atomics) per entry
    within 1e-5 of their sums of |contributions|; each launch moving its
    count."""
    from tcnn_tpu_torch.parallel import TableParallelGrid

    n_dims, cfg = _WINDOWED_CASES[case]
    enc = create_encoding(n_dims, cfg, alignment=16)
    F, L = enc.n_features_per_level, enc.n_levels
    interp = _interp_code(enc)
    rng = np.random.default_rng(20 + n_shards)
    x = torch.from_numpy(_lookup_points(enc, rng, 2048)).to(dev)
    for shard in range(n_shards):
        tpg = TableParallelGrid(enc, None, shard=(shard, n_shards))
        levels, windows = tpg._tables_on(dev)
        o = _third_operands(enc, x, tpg.local_n_params, rng)
        o["dy"], o["g_dy"] = o["dy"][:, : L * F].contiguous(), o["g_dy"][:, : L * F].contiguous()
        args = (x, o["dy"], o["params"], levels, windows, F, interp, o["cgp"], o["cgx"], o["g_params"], o["g_x"],
                o["g_dy"])
        n0 = grid_encode.WINDOWED_THIRD_LAUNCHES
        got = grid_encode.grid_backward3_windowed(*args)
        assert grid_encode.WINDOWED_THIRD_LAUNCHES == n0 + 1
        cpu = tuple(a.cpu() if isinstance(a, torch.Tensor) else a for a in args)
        want = [w.to(dev) for w in grid_encode.grid_backward3_windowed(*cpu)]
        mags = _third_magnitudes(monkeypatch, lambda: grid_encode.grid_backward3_windowed(*cpu))
        for i in (1, 2, 4):
            _close_f32(got[i], want[i])
        for i, s in zip((0, 3), mags):
            assert got[i].shape == (tpg.local_n_params,)
            assert bool(((got[i] - want[i]).abs() <= 1e-5 * s.to(dev) + 1e-30).all()), i


def test_windowed_third_order_needs_the_windows_after_the_table(dev):
    from tcnn_tpu_torch.parallel import TableParallelGrid

    enc = create_encoding(2, _WINDOWED_CASES["2d-linear"][1], alignment=16)
    tpg = TableParallelGrid(enc, None, shard=(0, 2))
    levels, windows = tpg._tables_on(dev)
    x = torch.rand((64, 2), device=dev)
    local = torch.zeros(tpg.local_n_params, device=dev)
    dy = torch.zeros((64, 32), device=dev)
    with pytest.raises(ValueError, match="follow the level table"):
        grid_encode.grid_backward3_windowed(x, dy, local, levels, windows.clone(), 2, grid_encode.INTERP_LINEAR,
                                            None, x.clone(), None, x.clone(), None)
