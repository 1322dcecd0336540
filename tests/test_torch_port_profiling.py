"""``tcnn_tpu_torch.utils.profiling`` against ``tcnn_tpu.utils.profiling``, on
the CPU.

- ``sync`` returns the first element of the first leaf as a float, as the
  JAX package's does for the same values (exact: fp32 values read back);
- ``time_fn`` makes ``warmup + iters`` calls, as the JAX package's, and
  returns positive seconds a call;
- ``trace`` writes a Chrome trace into its directory and yields it;
- ``profile_steps`` is the same function from its home and from
  ``benchmarks.grid_second_order_times``.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcnn_tpu.utils.profiling as jp
import tcnn_tpu_torch.utils.profiling as tp


@pytest.mark.parametrize("shape", [(), (1,), (3, 4)])
def test_sync_reads_the_first_element_like_jax(shape):
    v = np.asarray(np.random.default_rng(0).standard_normal(shape) + 2, np.float32)
    want = jp.sync({"a": jnp.asarray(v), "b": jnp.zeros(2)})
    assert tp.sync({"a": torch.from_numpy(v), "b": torch.zeros(2)}) == want
    assert tp.sync((torch.from_numpy(v).to(torch.bfloat16), 1)) == float(torch.from_numpy(v).reshape(-1)[0].bfloat16())


def test_time_fn_calls_like_jax():
    counts = {"jax": 0, "port": 0}

    def fn(key, x):
        counts[key] += 1
        return x * 2

    t_jax = jp.time_fn(fn, "jax", jnp.ones(4), iters=5, warmup=3)
    t_port = tp.time_fn(fn, "port", torch.ones(4), iters=5, warmup=3)
    assert counts == {"jax": 8, "port": 8}
    assert t_port > 0 and t_jax > 0


def test_trace_writes_a_chrome_trace(tmp_path):
    out = tmp_path / "trace"
    with tp.trace(str(out)) as d:
        assert d == str(out)
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    blob = json.loads((out / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in blob["traceEvents"])


def test_profile_steps_has_one_home():
    from tcnn_tpu_torch.benchmarks.grid_second_order_times import profile_steps

    assert profile_steps is tp.profile_steps
