"""Host-side pieces of the fused-MLP forward and the Adam step, on the CPU.

- The forward kernel's launch plan (``ops.ffmlp.forward_layout`` /
  ``forward_plan``): it fits the shared memory a block may use for every
  shape the network takes, takes every shape the earlier kernel took (its
  rule written out below), raises beyond, and its persistent warps cover
  every row of ragged batches exactly once.
- ``flat_weights``: a network's layers are views of one cast buffer and go
  to the kernels without a copy (``FullyFusedMLP._cast_weights``).
- ``AdamOptimizer.kernel_hyperparams``: the cached struct equals a fresh
  ``fused_adam.hyperparams_of`` after a hyperparameter or the loss scale
  changes.
"""

import ctypes
import itertools

import numpy as np
import pytest
import torch

from tcnn_tpu_torch.networks.fully_fused import FullyFusedMLP
from tcnn_tpu_torch.ops import ffmlp, fused_adam
from tcnn_tpu_torch.ops._plans import SHARED_BYTES
from tcnn_tpu_torch.optimizers import AdamOptimizer

WIDTHS = (16, 32, 64, 128)
IO_WIDTHS = (16, 32, 48, 64, 128, 256)
OUT_WIDTHS = (16, 32, 64)
BATCHES = (1, 15, 17, 31, 33, 2**18 + 7)


def _shapes(in_w, width, n_hidden, out_w):
    if n_hidden == 0:
        return [(out_w, in_w)]
    return [(width, in_w)] + [(width, width)] * (n_hidden - 1) + [(out_w, width)]


def _earlier_kernel_fits(in_w, width, n_hidden, out_w):
    """The earlier kernel's rule: unpadded weights rounded to 128 bytes, then
    per warp two 16-row activation tiles of the widest layer and a 16 x 16
    fp32 scratch tile; at least one warp."""
    n_weights = sum(a * b for a, b in _shapes(in_w, width, n_hidden, out_w))
    max_w = max(in_w, out_w, width if n_hidden else 0)
    w_bytes = -(-n_weights * 2 // 128) * 128
    return w_bytes + 2 * 16 * max_w * 2 + 16 * 16 * 4 <= SHARED_BYTES


@pytest.mark.parametrize("width", WIDTHS)
def test_forward_layout_fits_and_takes_every_shape_the_earlier_kernel_took(width):
    for in_w, out_w, n_hidden in itertools.product(IO_WIDTHS, OUT_WIDTHS, range(0, 12)):
        n_weights = sum(a * b for a, b in _shapes(in_w, width, n_hidden, out_w))
        try:
            rows, w_pad, x_bufs, warps, weight_bytes, warp_bytes = ffmlp.forward_layout(in_w, width, n_hidden, out_w)
        except ValueError:
            assert not _earlier_kernel_fits(in_w, width, n_hidden, out_w), (in_w, width, n_hidden, out_w)
            continue
        assert weight_bytes + warps * warp_bytes <= SHARED_BYTES
        assert weight_bytes >= n_weights * 2 and weight_bytes % 128 == 0 and warp_bytes % 128 == 0
        assert warps in (1, 2, 4, 8) and x_bufs in (1, 2) and w_pad in (0, ffmlp.FWD_PAD)
        # 32 rows a warp (two m16 tiles) at widths <= 64, 16 at width 128.
        assert rows in (16, 32) and (rows == 16 or n_hidden == 0 or width <= 64)
        # The staged weights, x tiles and output tile as the kernel lays them out.
        assert weight_bytes == -(-sum(fo * (fi + w_pad) for fo, fi in _shapes(in_w, width, n_hidden, out_w)) * 2
                                  // 128) * 128
        assert warp_bytes >= x_bufs * rows * (in_w + ffmlp.FWD_PAD) * 2 + rows * ffmlp.FWD_OUT_STRIDE * 2


def test_forward_layout_raises_beyond_shared_memory():
    # 128 x 8 hidden from 128 inputs: 279,552 bytes of weights alone.
    with pytest.raises(ValueError, match="do not fit"):
        ffmlp.forward_layout(128, 128, 8, 16)
    # The flagship and the image benchmark's networks take padded weights
    # and eight warps.
    assert ffmlp.forward_layout(32, 64, 2, 16)[:4] == (32, ffmlp.FWD_PAD, 2, 8)
    assert ffmlp.forward_layout(128, 128, 5, 16)[:4] == (16, ffmlp.FWD_PAD, 1, 8)


@pytest.mark.parametrize("shape", [(32, 64, 2, 16), (128, 128, 5, 16), (64, 64, 3, 64), (32, 16, 0, 16),
                                   (48, 32, 1, 32)], ids=str)
@pytest.mark.parametrize("batch", BATCHES)
def test_forward_plan_covers_every_row_once(shape, batch):
    n_sms, per_sm = 132, 2
    plan = ffmlp.forward_plan(batch, *shape, n_sms=n_sms, blocks_per_sm=per_sm)
    rows = plan.rows_per_warp
    tiles = -(-batch // rows)
    warps = plan.blocks * plan.warps
    assert 1 <= plan.blocks <= n_sms * per_sm and plan.smem_bytes <= SHARED_BYTES
    # No block without a tile; the warps take tiles_per_warp tiles or fewer.
    assert (plan.blocks - 1) * plan.warps < tiles
    assert -(-tiles // warps) == plan.tiles_per_warp
    # The kernel's walk: warp w takes tiles w, w + warps, ... below n_tiles.
    seen = np.zeros(tiles * rows, np.int64)
    for w in range(warps):
        for t in range(w, tiles, warps):
            seen[t * rows:(t + 1) * rows] += 1
    assert (seen == 1).all() and seen.size >= batch and seen.size - batch < rows


def test_forward_plan_args_are_the_kernel_struct():
    plan = ffmlp.forward_plan(2**18, 32, 64, 2, 16, n_sms=132, blocks_per_sm=2)
    arr = (ctypes.c_int32 * len(plan.FIELDS)).from_address(plan.args_ptr)
    assert list(arr) == [getattr(plan, f) for f in plan.FIELDS]
    # The flagship at 2^18 rows: 8,192 tiles of 32 rows over 264 blocks of 8
    # warps at most, 4 tiles a warp.
    assert (plan.blocks, plan.warps, plan.rows_per_warp, plan.tiles_per_warp) == (256, 8, 32, 4)


def test_network_layers_go_to_the_kernels_without_a_copy():
    net = FullyFusedMLP(32, 3, n_neurons=64, n_hidden_layers=2)
    params = torch.randn(net.n_params + 100)
    ws = net._cast_weights(params)
    flat = ffmlp.flat_weights(ws)
    assert flat.data_ptr() == ws[0].data_ptr() and flat.numel() == net.n_params
    torch.testing.assert_close(flat, params[: net.n_params].bfloat16(), rtol=0, atol=0)
    # Weights that are not consecutive views are concatenated.
    apart = [w.clone() for w in ws]
    flat2 = ffmlp.flat_weights(apart)
    assert flat2.data_ptr() not in [w.data_ptr() for w in apart]
    torch.testing.assert_close(flat2, flat, rtol=0, atol=0)
    # Reversed views of one buffer are not in flat-parameter order.
    torch.testing.assert_close(ffmlp.flat_weights(ws[::-1]), torch.cat([w.reshape(-1) for w in ws[::-1]]))


def test_fused_network_output_is_unchanged_by_the_single_cast():
    net = FullyFusedMLP(32, 3, n_neurons=32, n_hidden_layers=3)
    rng = np.random.default_rng(0)
    params = torch.from_numpy(rng.normal(0, 0.3, net.n_params).astype(np.float32)).requires_grad_(True)
    x = torch.from_numpy(rng.uniform(-1, 1, (40, 32)).astype(np.float32))
    got = net.apply(params, x)
    ws = [w.to(torch.bfloat16) for w in net._weights(params)]
    want = ffmlp.ffmlp_forward_plain(x.bfloat16(), ws, net.activation, net.output_activation)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    (g,) = torch.autograd.grad(got.float().sum(), params)
    (g_want,) = torch.autograd.grad(want.float().sum(), params)
    torch.testing.assert_close(g, g_want, rtol=0, atol=0)


def _struct_bytes(hp):
    return bytes(memoryview(hp))


def test_adam_struct_is_cached_and_rebuilt_on_change():
    opt = AdamOptimizer({"learning_rate": 1e-2, "beta2": 0.99, "epsilon": 1e-15, "l2_reg": 1e-6})
    opt.allocate(715_760, [(64, 32), (64, 64), (16, 64)])
    a = opt.kernel_hyperparams(128.0)
    assert opt.kernel_hyperparams(128.0) is a
    assert _struct_bytes(a) == _struct_bytes(fused_adam.hyperparams_of(opt, 715_760, 7_168, 128.0))
    # A learning-rate change.
    opt.learning_rate = 3e-3
    b = opt.kernel_hyperparams(128.0)
    assert b is not a and b.lr_matrix == pytest.approx(3e-3)
    assert _struct_bytes(b) == _struct_bytes(fused_adam.hyperparams_of(opt, 715_760, 7_168, 128.0))
    # A loss-scale change.
    c = opt.kernel_hyperparams(64.0)
    assert c is not b and _struct_bytes(c) == _struct_bytes(fused_adam.hyperparams_of(opt, 715_760, 7_168, 64.0))
    # Any other hyperparameter, through update_hyperparams, and a new allocation.
    opt.update_hyperparams({"beta1": 0.5, "adabound": True})
    d = opt.kernel_hyperparams(64.0)
    assert d is not c and (d.beta1, d.adabound) == (0.5, 1)
    assert _struct_bytes(d) == _struct_bytes(fused_adam.hyperparams_of(opt, 715_760, 7_168, 64.0))
    opt.allocate(1000, [(8, 16)])
    e = opt.kernel_hyperparams(64.0)
    assert (e.n, e.n_matrix) == (1000, 128)
    assert _struct_bytes(e) == _struct_bytes(fused_adam.hyperparams_of(opt, 1000, 128, 64.0))
