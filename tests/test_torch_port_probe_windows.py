"""The WINDOW probes P10 (``ds8``) and P15 (``ds8_aligned``) of the port
(``tcnn_tpu_torch.ops.probe_rows.probe_gather``, MODE_WINDOW) against the
JAX package's own Pallas kernels, bit for bit.

The TPU probes ``benchmarks/probe_r5_pallas_gather2.py`` (``k_ds8``, its
``pallas_call`` at :308) and ``benchmarks/probe_r5_pallas_gather3.py``
(``k3``, :211) are run unchanged, from copies, in interpret mode in one
subprocess at B = 2^10 rows of an (S = 2^8, F = 8) table: there
``pallas_call`` is wrapped to record each kernel's output and ``jax.jit`` is
the identity, so the outputs are concrete arrays. The port gets the same
numpy seed-0 inputs (for ``ds8`` the indices clipped to S - 8, as :304
does). ``static_copy`` is not among them: in interpret mode its tile is
256 rows (``probe_r5_pallas_gather3.py:70``), not the port's 2048; it is
held to its loop in ``test_torch_port_probe_rows.py``.
"""

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tcnn_tpu_torch.ops import probe_rows as pr

ROOT = Path(__file__).resolve().parents[1]
LOG_B, LOG_S, F = 10, 8, 8
PROBES = {"ds8": "probe_r5_pallas_gather2.py", "ds8_aligned": "probe_r5_pallas_gather3.py"}

RUNNER = """
import runpy
import sys

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")
jax.jit = lambda f=None, **kw: f if f is not None else (lambda g: g)
from jax.experimental import pallas as pl

outputs = []
pallas_call = pl.pallas_call


def recording(*args, **kwargs):
    kernel = pallas_call(*args, **kwargs)

    def call(*xs):
        out = kernel(*xs)
        outputs.append(np.asarray(out))
        return out

    return call


pl.pallas_call = recording
for probe, script, dest in zip(sys.argv[1::3], sys.argv[2::3], sys.argv[3::3]):
    del outputs[:]
    sys.argv = [script, "--interpret", "--log-b", "{log_b}", "--log-s", "{log_s}", "--feat", "{feat}",
                "--only", probe]
    runpy.run_path(script, run_name="__main__")
    assert len(outputs) == 1, (probe, len(outputs))
    np.save(dest, outputs[0])
"""


@pytest.fixture(scope="module")
def jax_windows(tmp_path_factory):
    """{probe: the JAX probe's Pallas output} for ds8 and ds8_aligned."""
    tmp = tmp_path_factory.mktemp("jax_windows")
    (tmp / "benchmarks").mkdir()
    args = []
    for probe, name in PROBES.items():
        shutil.copy(ROOT / "benchmarks" / name, tmp / "benchmarks" / name)
        args += [probe, str(tmp / "benchmarks" / name), str(tmp / f"{probe}.npy")]
    runner = tmp / "run.py"
    runner.write_text(RUNNER.format(log_b=LOG_B, log_s=LOG_S, feat=F))
    proc = subprocess.run([sys.executable, str(runner), *args], cwd=tmp, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return {probe: np.load(tmp / f"{probe}.npy") for probe in PROBES}


@pytest.mark.parametrize("probe", list(PROBES))
def test_windows_match_the_jax_probes_pallas_kernels(jax_windows, probe):
    """``probe_gather`` (CPU: its plain version) in MODE_WINDOW, aligned for
    ds8_aligned, gives the JAX probe's Pallas output bit for bit."""
    r = np.random.default_rng(0)
    S, B = 1 << LOG_S, 1 << LOG_B
    table = r.standard_normal((S, F)).astype(np.float32)
    idx = r.integers(0, S, (B,)).astype(np.int32)
    aligned = probe == "ds8_aligned"
    if not aligned:
        idx = np.minimum(idx, S - 8)
    got = pr.probe_gather(torch.from_numpy(table), torch.from_numpy(idx), pr.MODE_WINDOW,
                          flags=pr.FLAG_ALIGNED if aligned else 0)
    want = jax_windows[probe]
    assert want.shape == (B, F) and want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want)
