"""Builds and loads the port's native host helper (``host_sampler.cpp``).

The source compiles with ``g++`` at first use into
``build/tcnn_tpu_torch/libhost_sampler-<hash>.so`` at the root of the
checkout (the directory of the CUDA kernels, ``ops/_build.py``), the hash
covering the source and the flags, and is loaded with ctypes. ``_load()``
returns None where it cannot be built or loaded; its callers then take their
numpy fallback. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

from ..ops._build import BUILD_DIR

SRC = Path(__file__).resolve().parent / "host_sampler.cpp"
# No -march=native: the library must load on any x86-64 host.
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
build_error: Optional[str] = None


def library_path() -> Path:
    h = hashlib.sha1(SRC.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libhost_sampler-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the helper unless an up-to-date build exists; returns its
    path. Raises ``RuntimeError`` with the compiler's output on failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *FLAGS, str(SRC), "-o", str(tmp)], capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"g++ could not run: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SRC.name}:\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.sampler_create.restype = ctypes.c_void_p
    lib.sampler_create.argtypes = [
        ctypes.POINTER(ctypes.c_float),  # image
        ctypes.c_int64,  # h
        ctypes.c_int64,  # w
        ctypes.c_int64,  # c
        ctypes.c_int64,  # batch
        ctypes.c_int,  # strata (0 = iid)
        ctypes.c_uint64,  # seed
        ctypes.c_int,  # n_buffers
    ]
    lib.sampler_next.restype = None
    lib.sampler_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)]
    lib.sampler_destroy.restype = None
    lib.sampler_destroy.argtypes = [ctypes.c_void_p]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The loaded helper, built at the first call; None (and the reason in
    ``build_error``) where it cannot be built or loaded."""
    global _lib, _tried, build_error
    with _lock:
        if not _tried:
            _tried = True
            try:
                _lib = _bind(ctypes.CDLL(str(build())))
            except (OSError, RuntimeError) as e:
                build_error = str(e)
        return _lib
