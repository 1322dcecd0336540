"""Package boundaries of the PyTorch port.

- ``import tcnn_tpu_torch`` loads no jax and no tcnn_tpu (the port runs on
  machines without JAX).
- ``chip_smoke.py`` without a CUDA device, or outside a checkout, exits
  non-zero and never prints its success line: there is no CPU fallback.
- The kernel build paths are computed without a compiler at import time.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _run(args, cwd, **env):
    e = dict(os.environ)
    e.update(env)
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=e, capture_output=True, text=True, timeout=300
    )


def test_import_loads_no_jax():
    code = (
        "import sys, tcnn_tpu_torch, tcnn_tpu_torch.ops.ffmlp, tcnn_tpu_torch.ops.grid_encode, "
        "tcnn_tpu_torch.ops._build, tcnn_tpu_torch.ops.scatter_rows, tcnn_tpu_torch.ops.fused_adam, "
        "tcnn_tpu_torch.losses, tcnn_tpu_torch.optimizers, tcnn_tpu_torch.utils.sampling\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tcnn_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    r = _run(["-c", code], ROOT)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_chip_smoke_fails_without_cuda():
    r = _run(["chip_smoke.py"], ROOT, CUDA_VISIBLE_DEVICES="")
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "needs an NVIDIA GPU" in r.stderr


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(["chip_smoke.py"], tmp_path, CUDA_VISIBLE_DEVICES="", PYTHONPATH="")
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_kernel_sources_and_build_paths():
    from tcnn_tpu_torch.ops import _build

    for name in ("ffmlp_fwd", "grid_fwd", "ffmlp_bwd", "adam_step", "grid_bwd"):
        src = _build.CSRC / f"{name}.cu"
        assert src.exists()
        text = src.read_text()
        assert "Replaces:" in text and "What bounds it" in text
        assert 'extern "C" int tcnn_' in text
        path = _build.library_path(name)
        assert path.parent == ROOT / "build" / "tcnn_tpu_torch"
        assert path.name.startswith(f"lib{name}-") and path.suffix == ".so"


def test_library_name_covers_shared_headers(tmp_path, monkeypatch):
    """Editing a shared header (csrc/*.cuh) renames every library, so a
    stale build is never loaded; editing one source renames only its own."""
    from tcnn_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    names = ("ffmlp_fwd", "ffmlp_bwd", "grid_bwd")
    before = {n: _build.library_path(n) for n in names}
    header = csrc / "activations.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.library_path(n) for n in names}
    assert all(after[n] != before[n] for n in names)
    src = csrc / "grid_bwd.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    again = {n: _build.library_path(n) for n in names}
    assert again["grid_bwd"] != after["grid_bwd"] and again["ffmlp_bwd"] == after["ffmlp_bwd"]
