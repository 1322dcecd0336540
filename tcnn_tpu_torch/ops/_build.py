"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles alone with
``nvcc`` into ``build/tcnn_tpu_torch/lib<name>-<hash>.so`` at the root of the
checkout; the file name carries a hash of the source, of every shared header
``csrc/*.cuh`` and of the flags, so an edited source or header is rebuilt and
a stale library is never loaded. Nothing here runs at import time: this
module is imported on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tcnn_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}
_bound: Dict[tuple, object] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit (set CUDA_HOME)")


def library_path(name: str) -> Path:
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    # A source may include any shared header; all of them enter the digest.
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_library(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date build exists; the
    compiler's resource report (``-Xptxas -v``) is kept beside it as
    ``.log``. Returns the library path."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def build_libraries_timed(names) -> Dict[str, Tuple[Path, float]]:
    """``build_library`` for several sources at once, one ``nvcc`` each,
    all started together: each library's path and the seconds its build
    took (about 0 where it was built already). Raises the first failure
    after all have ended."""
    from concurrent.futures import ThreadPoolExecutor

    def timed(name):
        t0 = time.perf_counter()
        return build_library(name), time.perf_counter() - t0

    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        futures = {name: pool.submit(timed, name) for name in names}
    return {name: f.result() for name, f in futures.items()}


def build_libraries(names) -> Dict[str, Path]:
    """``build_libraries_timed`` without the seconds."""
    return {name: path for name, (path, _) in build_libraries_timed(names).items()}


def load_library(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(str(build_library(name)))
        return lib


def kernel(name: str, symbol: str, argtypes):
    """The C entry point ``symbol`` of library ``name``, built and loaded at
    first use, with its argument types set and an ``int`` (cudaError_t)
    result. Each symbol is bound on its own: a symbol left with ctypes'
    default ``int`` argument types would cut its 64-bit pointers."""
    key = (name, symbol)
    fn = _bound.get(key)
    if fn is None:
        fn = getattr(load_library(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        with _lock:
            _bound[key] = fn
    return fn


def stream(index: int) -> int:
    """The raw handle of the current stream of CUDA device ``index``, read
    anew each call (the caller may switch streams): what every kernel
    wrapper passes its C entry point. Cheaper on the host than
    ``torch.cuda.current_stream(dev).cuda_stream``, which builds a Stream
    object (PERF.md gives both readings)."""
    return torch._C._cuda_getCurrentRawStream(index)
