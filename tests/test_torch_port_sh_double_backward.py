"""SH's double backward on the CPU: the port's ``sh_backward_backward`` (on
a CPU tensor its plain version, the reference the kernel
``tcnn_sh_backward_backward`` is held to on the card) against ``jax.vjp``
of ``jax.vjp`` of the JAX package's ``SphericalHarmonicsEncoding.apply``,
and ``ShBackwardBackwardFunction``, through which every order past the
first runs.

The double backward is the vjp of dL/dx = vjp(apply)(x, dL/dy) with a
cotangent c of dL/dx: its gradients in x and in dL/dy. Tolerance: 1e-4 of
the JAX result's norm, as test_torch_port_higher_order.py's SH third order
(fp32 on both sides, the same terms summed in another order); exact zeros
where the derivative vanishes: in x at degrees 1-2 (affine in x), in the
padding columns of dL/dy, and everywhere at degree 1 (constant).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import autograd

from tcnn_tpu.encodings.spherical_harmonics import SphericalHarmonicsEncoding as JaxSH
from tcnn_tpu_torch.encodings.spherical_harmonics import SphericalHarmonicsEncoding as TorchSH
from tcnn_tpu_torch.ops import sh_encode as sh

B = 16


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / max(np.linalg.norm(np.asarray(b)), 1e-30))


def _jax_sh(degree, n_to_pad):
    je = JaxSH(degree, 3)
    je.output_dtype = jnp.float32
    je.set_padded_output_width(n_to_pad + degree * degree)
    return je


def _inputs(degree, n_to_pad, seed):
    r = np.random.default_rng(seed)
    x = r.uniform(0, 1, (B, 3)).astype(np.float32)
    dy = r.standard_normal((B, n_to_pad + degree * degree)).astype(np.float32)
    c = r.standard_normal((B, 3)).astype(np.float32)
    return x, dy, c


def _jax_first_backward(je):
    return lambda xx, yy: jax.vjp(lambda z: je.apply(None, z), xx)[1](yy)[0]


@functools.lru_cache(maxsize=None)
def _jax_double_backward(degree):
    """(x, dL/dy, c, d/dx, d/d(dL/dy)) of the JAX package at ``degree`` with 7
    padding columns; the SH columns and d/dx are those of any padding."""
    x, dy, c = _inputs(degree, 7, seed=10 * degree)
    _, vjp = jax.vjp(_jax_first_backward(_jax_sh(degree, 7)), jnp.asarray(x), jnp.asarray(dy))
    return (x, dy, c, *(np.asarray(t) for t in vjp(jnp.asarray(c))))


@pytest.mark.parametrize("n_to_pad", [0, 7])
@pytest.mark.parametrize("degree", range(1, 9))
def test_double_backward_vs_jax(degree, n_to_pad):
    """Both outputs of the double backward against jax.vjp twice."""
    x, dy, c, want_x, want_dy = _jax_double_backward(degree)
    dy, want_dy = dy[:, 7 - n_to_pad:], want_dy[:, 7 - n_to_pad:]
    got_x, got_dy = sh.sh_backward_backward(torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(dy)),
                                            torch.from_numpy(c), degree, n_to_pad)
    assert got_x.dtype == torch.float32 and got_x.shape == (B, 3)
    assert got_dy.dtype == torch.float32 and got_dy.shape == dy.shape
    got_x, got_dy = got_x.numpy(), got_dy.numpy()
    assert not got_dy[:, :n_to_pad].any() and not want_dy[:, :n_to_pad].any()
    if degree <= 2:  # affine in x: no second derivative in x
        assert not got_x.any() and not want_x.any()
    else:
        assert _rel(got_x, want_x) <= 1e-4
    if degree == 1:  # constant: dL/dx is 0 whatever dL/dy
        assert not got_dy.any() and not want_dy.any()
    else:
        assert _rel(got_dy, want_dy) <= 1e-4


@pytest.mark.parametrize("degree", [1, 3, 8])
def test_need_flags_and_dtypes(degree):
    """``need_x`` / ``need_dy`` drop the other output and leave the asked
    one unchanged; d/d(dL/dy) comes back in dL/dy's dtype."""
    x, dy, c = (torch.from_numpy(t) for t in _inputs(degree, 7, seed=degree))
    both = sh.sh_backward_backward(x, dy, c, degree, 7)
    only_x = sh.sh_backward_backward(x, dy, c, degree, 7, need_x=True, need_dy=False)
    only_dy = sh.sh_backward_backward(x, dy, c, degree, 7, need_x=False, need_dy=True)
    assert only_x[1] is None and only_dy[0] is None
    assert torch.equal(only_x[0], both[0]) and torch.equal(only_dy[1], both[1])
    d16 = sh.sh_backward_backward(x, dy.bfloat16(), c, degree, 7)[1]
    want16 = sh.sh_backward_backward_plain(x, dy.bfloat16(), c, degree, 7)[1].bfloat16()
    assert d16.dtype == torch.bfloat16 and torch.equal(d16, want16)
    with pytest.raises(ValueError, match="unsupported device"):
        sh.sh_backward_backward(x.to("meta"), dy.to("meta"), c.to("meta"), degree, 7)


def _counts():
    return (sh.LAUNCHES, sh.BWD_LAUNCHES, sh.BWDBWD_LAUNCHES, sh.PLAIN_BWDBWD_ON_CARD, dict(sh.ROUTE_LAUNCHES))


@pytest.mark.parametrize("degree", [2, 4])
def test_function_on_the_cpu_launches_nothing(degree):
    """A penalty on dL/dx through the encoding's apply: its second order
    runs ``ShBackwardBackwardFunction`` on the plain version here, counts
    no launch and no plain double backward on a card, and gives the
    wrapper's values."""
    x, dy, c = _inputs(degree, 7, seed=40 + degree)
    te = TorchSH(degree, 3)
    te.output_dtype = torch.float32
    te.set_padded_output_width(7 + degree * degree)
    before = _counts()
    xt, w = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(dy).requires_grad_(True)
    (gx,) = autograd.grad((te.apply(None, xt) * w).sum(), xt, create_graph=True)
    d_x, d_w = autograd.grad((gx * torch.from_numpy(c)).sum(), (xt, w))
    assert _counts() == before
    want_x, want_dy = sh.sh_backward_backward(torch.from_numpy(x), torch.from_numpy(dy), torch.from_numpy(c), degree, 7)
    torch.testing.assert_close(d_x, want_x, rtol=1e-6, atol=1e-6 * float(want_x.abs().max()))
    torch.testing.assert_close(d_w, want_dy, rtol=1e-6, atol=1e-6 * float(want_dy.abs().max()))


@pytest.mark.parametrize("degree", [2, 4])
def test_third_order_through_the_function_vs_jax(degree):
    """``ShBackwardBackwardFunction``'s backward (autograd of the plain
    double backward): d/dx, d/d(dL/dy) and d/dc of <w1, d_x> + <w2, d_dy>
    against jax.grad of the same through jax.vjp twice."""
    x, dy, c = _inputs(degree, 7, seed=70 + degree)
    r = np.random.default_rng(degree)
    w1 = r.standard_normal((B, 3)).astype(np.float32)
    w2 = r.standard_normal(dy.shape).astype(np.float32)
    first = _jax_first_backward(_jax_sh(degree, 7))

    def loss_j(xx, yy, cc):
        d_x, d_dy = jax.vjp(first, xx, yy)[1](cc)
        return jnp.sum(d_x * w1) + jnp.sum(d_dy * w2)

    want = [np.asarray(g) for g in jax.grad(loss_j, argnums=(0, 1, 2))(*(jnp.asarray(t) for t in (x, dy, c)))]
    ts = [torch.from_numpy(t).requires_grad_(True) for t in (x, dy, c)]
    d_x, d_dy = sh.ShBackwardBackwardFunction.apply(*ts, degree, 7, False, True, True)
    loss = (d_x * torch.from_numpy(w1)).sum() + (d_dy * torch.from_numpy(w2)).sum()
    got = autograd.grad(loss, ts, allow_unused=True, materialize_grads=True)
    for g, wg, what in zip(got, want, ("x", "dL/dy", "c")):
        if not wg.any():
            assert not g.any(), what
        else:
            assert _rel(g.numpy(), wg) <= 1e-4, what
