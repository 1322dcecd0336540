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
        "tcnn_tpu_torch.losses, tcnn_tpu_torch.optimizers, tcnn_tpu_torch.utils.sampling, "
        "tcnn_tpu_torch.interchange, tcnn_tpu_torch.utils.checkpoint, tcnn_tpu_torch.optimizers.composite, "
        "tcnn_tpu_torch.ops.sh_encode, tcnn_tpu_torch.samples.nerf_synthetic\n"
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

    for name in ("ffmlp_fwd", "grid_fwd", "ffmlp_bwd", "adam_step", "grid_bwd", "grid_input_grad", "grid_bwd_rng",
                 "grid_bwd_modes", "probe_rows", "sh_encode", "grid_sharded"):
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


def test_no_port_module_imports_jax():
    """Every module of the port, the module API and the benchmark entry
    points included, loads without jax, tcnn_tpu or the repo's own
    bench.py, benchmarks/ and samples/."""
    code = (
        "import importlib, pkgutil, sys, tcnn_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(tcnn_tpu_torch.__path__, 'tcnn_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert 'tcnn_tpu_torch.modules' in sys.modules and 'tcnn_tpu_torch.encodings.basic' in sys.modules\n"
        "assert 'tcnn_tpu_torch.benchmarks.bench' in sys.modules and 'tcnn_tpu_torch.samples' in sys.modules\n"
        "top = ('jax', 'jaxlib', 'tcnn_tpu', 'bench', 'benchmarks', 'samples', '__graft_entry__')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in top)\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    r = _run(["-c", code], ROOT)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 40


def test_entry_points_default_to_cuda():
    """Without a device argument the entry points use the CUDA card, and
    raise where there is none: no quiet CPU fallback."""
    code = (
        "import torch, tcnn_tpu_torch as tt\n"
        "from tcnn_tpu_torch import modules\n"
        "cfg = {'encoding': {'otype': 'HashGrid', 'n_levels': 2, 'log2_hashmap_size': 8},\n"
        "       'network': {'otype': 'FullyFusedMLP', 'n_neurons': 16, 'n_hidden_layers': 1}}\n"
        "calls = [tt.default_device, lambda: tt.create_from_config(2, 3, cfg),\n"
        "         lambda: tt.NetworkWithInputEncoding(2, 3, cfg['encoding'], cfg['network']),\n"
        "         lambda: modules.NetworkWithInputEncoding(2, 3, cfg['encoding'], cfg['network']),\n"
        "         lambda: modules.Network(16, 3, cfg['network']), lambda: modules.Encoding(2, cfg['encoding'])]\n"
        "for call in calls:\n"
        "    try:\n"
        "        call()\n"
        "    except RuntimeError as e:\n"
        "        assert 'no CUDA device' in str(e), e\n"
        "    else:\n"
        "        raise AssertionError(call)\n"
        "assert tt.create_from_config(2, 3, cfg, device='cpu').params.device.type == 'cpu'\n"
        "assert modules.Encoding(2, cfg['encoding'], device='cpu').params.device.type == 'cpu'\n"
        "torch.cuda.is_available = lambda: True\n"
        "assert tt.default_device() == torch.device('cuda')\n"
        "print('ok')\n"
    )
    r = _run(["-c", code], ROOT, CUDA_VISIBLE_DEVICES="")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")


def test_kernel_binds_each_symbol(monkeypatch):
    """Two entry points of one library each get their own argument types
    (a symbol left with ctypes' default int arguments would cut 64-bit
    pointers)."""
    import ctypes

    from tcnn_tpu_torch.ops import _build

    class Symbol:
        argtypes = None
        restype = None

    class Lib:
        a, b = Symbol(), Symbol()

    monkeypatch.setattr(_build, "load_library", lambda name: Lib)
    monkeypatch.setattr(_build, "_bound", {})
    fa = _build.kernel("fake", "a", [ctypes.c_void_p, ctypes.c_int])
    fb = _build.kernel("fake", "b", [ctypes.c_void_p] * 3)
    assert fa is Lib.a and fb is Lib.b
    assert fa.argtypes == [ctypes.c_void_p, ctypes.c_int] and fb.argtypes == [ctypes.c_void_p] * 3
    assert fa.restype is ctypes.c_int and fb.restype is ctypes.c_int
    assert _build.kernel("fake", "b", []) is fb and fb.argtypes == [ctypes.c_void_p] * 3


def _raises_without_cuda(calls_src: str, cpu_checks_src: str):
    """Each call of ``calls`` raises the port's no-card error; the lines of
    ``cpu_checks`` (which pass ``device="cpu"``) run."""
    code = (
        "import torch\n"
        "from tcnn_tpu_torch.utils.sampling import stratified_uniform\n"
        "from tcnn_tpu_torch.optimizers import AdamOptimizer, EmaOptimizer, Optimizer\n"
        "adam, ema, base = AdamOptimizer({}), EmaOptimizer({'decay': 0.9}), Optimizer()\n"
        "for o in (adam, ema, base):\n"
        "    o.allocate(40, [(4, 5)])\n"
        f"calls = [{calls_src}]\n"
        "for call in calls:\n"
        "    try:\n"
        "        call()\n"
        "    except RuntimeError as e:\n"
        "        assert 'no CUDA device' in str(e), e\n"
        "    else:\n"
        "        raise AssertionError(call)\n"
        f"{cpu_checks_src}"
        "print('ok')\n"
    )
    r = _run(["-c", code], ROOT, CUDA_VISIBLE_DEVICES="")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")


def test_stratified_uniform_defaults_to_cuda():
    """Without a generator or a device the sampler draws on the card (and
    raises without one); with a generator it keeps the generator's device."""
    _raises_without_cuda(
        "lambda: stratified_uniform(16, 2), lambda: stratified_uniform(64, 3, phase_locked=2)",
        "assert stratified_uniform(16, 2, device='cpu').device.type == 'cpu'\n"
        "g = torch.Generator().manual_seed(0)\n"
        "x = stratified_uniform(16, 2, g)\n"
        "assert x.device.type == 'cpu' and x.shape == (16, 2)\n",
    )


def test_optimizer_state_defaults_to_cuda():
    """``init_state()`` of Adam, EMA and the base class allocates on the
    card (and raises without one); ``init_state("cpu")`` stays on the CPU."""
    _raises_without_cuda(
        "adam.init_state, ema.init_state, base.init_state",
        "for o in (adam, ema, base):\n"
        "    s = o.init_state('cpu')\n"
        "    leaves = [s['step']] if o is base else ([s['nested']['step'], s['weights_ema']] if o is ema else\n"
        "              [s['step'], s['first_moments'], s['second_moments'], s['param_steps']])\n"
        "    assert all(t.device.type == 'cpu' for t in leaves)\n"
        "assert ema.init_state('cpu')['weights_ema'].shape == (40,)\n",
    )
