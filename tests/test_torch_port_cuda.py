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
kernels (ops.sh_encode): the fp32 forward and dL/dx within 1e-5 of max
|plain| (the same operations, but torch divides by a scalar on the card as
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


def _table_grad(enc, x, dy, classes, u=None):
    before = grid_encode.BWD_LAUNCHES
    got = grid_encode.grid_backward(x, dy, enc._levels_on(x.device), enc.n_features_per_level, _interp_code(enc),
                                    classes, u=u)
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


@pytest.mark.parametrize("degree", range(1, 9))
@pytest.mark.parametrize("batch", [1, 129, 4099])
def test_sh_encode_kernel_matches_plain(dev, degree, batch):
    """tcnn_sh_forward (strided input, prepended padding, fp32 and bf16)
    and tcnn_sh_backward_input against their plain versions."""
    gen = torch.Generator(device=dev).manual_seed(degree * 1000 + batch)
    x = torch.rand((batch, 6), generator=gen, device=dev)[:, 3:]
    pad = 5
    want = sh_encode.sh_encode_plain(x, degree, pad, 1.0, torch.float32)
    before = sh_encode.LAUNCHES
    got = sh_encode.sh_encode(x, degree, pad, 1.0, torch.float32)
    assert sh_encode.LAUNCHES == before + 1
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale
    got16 = sh_encode.sh_encode(x, degree, pad, 1.0, torch.bfloat16).float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
    assert bool(((got16 - want).abs() <= ulp + 1e-5 * scale).all())
    dy = torch.randn((batch, pad + degree * degree), generator=gen, device=dev)
    got_dx = sh_encode.sh_backward_input(x, dy, degree, pad)
    want_dx = sh_encode.sh_backward_input_plain(x, dy, degree, pad)
    assert float((got_dx - want_dx).abs().max()) <= 1e-5 * max(float(want_dx.abs().max()), 1e-30)


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


@pytest.mark.parametrize("interp", ["Linear", "Smoothstep"])
@pytest.mark.parametrize("n_dims", [2, 3])
def test_rng_hash_kernels_match_plain(dev, n_dims, interp):
    """The Rng hash in the lookup (fp32 rtol 1e-5, atol 1e-6), the table
    gradient (level by level in its classes) and G1 / G2 (``_close_f32``)."""
    enc = create_encoding(n_dims, dict(EXTRAS_GRID, hash="Rng", interpolation=interp), alignment=16)
    enc.output_dtype = torch.float32
    levels = enc._levels_on(dev)
    assert int((levels[:, 2] == grid_encode.MODE_RNG).sum()) >= 2
    rng = np.random.default_rng(n_dims)
    n = 30_001
    x = torch.from_numpy(rng.uniform(-0.2, 1.2, (n, n_dims)).astype(np.float32)).to(dev)
    params = torch.from_numpy(rng.uniform(-1, 1, enc.n_params).astype(np.float32)).to(dev)
    torch.testing.assert_close(enc.apply(params, x), enc.apply_plain(params, x), rtol=1e-5, atol=1e-6)
    dy = torch.from_numpy(rng.normal(0, 1, (n, enc.padded_output_width)).astype(np.float32)).to(dev).bfloat16()
    classes = torch.from_numpy(enc.gradient_classes(n)).to(dev)
    classes[1::2] = torch.tensor([scatter_rows.CONTRIB_SR, scatter_rows.ACC_BF16], dtype=torch.int32)
    _check_levels(enc, _table_grad(enc, x, dy, classes), x, dy, classes)
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


@pytest.mark.parametrize("over", [{}, {"interpolation": "Smoothstep", "hash": "Rng"}, {"n_features_per_level": 4},
                                  {"gather_strategy": "quad", "table_dtype": "bfloat16"}], ids=str)
@pytest.mark.parametrize("n_dims", [2, 3, 1])
def test_fixed_point_kernels_match_plain(dev, n_dims, over):
    """uint32 positions (with 0 and 2^32 - 1 among them) through the lookup
    (fp32 rtol 1e-5, atol 1e-6; bf16 output within 4 bf16 ulps) and the
    table gradient (its classes, and every level (RN, bf16))."""
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
    for classes in (torch.from_numpy(enc.gradient_classes(n)).to(dev),
                    torch.tensor([[scatter_rows.CONTRIB_RN, scatter_rows.ACC_BF16]] * enc.n_levels,
                                 dtype=torch.int32, device=dev)):
        _check_levels(enc, _table_grad(enc, x, dy, classes), x, dy, classes)
    with pytest.raises(ValueError, match="float32"):
        grid_encode.grid_backward_input(x, dy, params, enc._levels_on(dev), enc.n_features_per_level,
                                        _interp_code(enc))


@pytest.mark.parametrize("case", ["fp32", "bf16", "3d-smoothstep", "nearest"])
def test_stochastic_table_gradient_matches_plain(dev, case):
    """One corner per (sample, level) for the same uniforms u in kernel and
    plain version: the fp32 class, the (RN, bf16) class (bf16 sums), d = 3
    with Smoothstep and F = 4 (float4 adds), and Nearest (no u: the
    deterministic one-corner gradient); a stratified flagship-like batch,
    where long runs of lanes share rows and levels are privatised."""
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
    got = _table_grad(enc, x, dy, classes, u)
    _check_levels(enc, got, x, dy, classes, u)
    if u is not None:
        det = _table_grad(enc, x, dy, classes)
        assert int((got != 0).sum()) < int((det != 0).sum())
    # Through the encoding: a generator on the card draws u; the forward is
    # the deterministic lookup.
    p = torch.zeros(enc.n_params, device=dev, requires_grad=True)
    before = (grid_encode.LAUNCHES, grid_encode.BWD_LAUNCHES)
    (g,) = torch.autograd.grad(enc.apply(p, x, rng=gen).float().sum(), p)
    assert (grid_encode.LAUNCHES, grid_encode.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert torch.isfinite(g).all() and g.any()
