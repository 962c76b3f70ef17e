"""Hand-written CUDA kernels for Hopper, built at first use.

Each kernel package keeps its sources under ``csrc/`` with a plain C
interface. ``load_library`` compiles them with ``nvcc`` for ``sm_90a`` into
one shared library under ``<repo>/build/kernels/``, named by a hash of the
sources and flags (a changed source builds anew, an unchanged one loads the
cached library), and opens it with ``ctypes``. Importing this module builds
and loads nothing; the first kernel launch does.

Wrappers pass pointers from ``tensor.data_ptr()`` and PyTorch's current
stream, declare every ``argtypes``/``restype``, and raise when a C entry
point returns a CUDA error.
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
from typing import Dict, Sequence, Tuple

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()                 # guards _LOCKS
_LOCKS: Dict[str, threading.Lock] = {}   # one per library: builds overlap
_LOADED: Dict[str, Tuple[ctypes.CDLL, float]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels are built on the machine with the card")


def library_path(name: str, sources: Sequence[Path],
                 headers: Sequence[Path] = ()) -> Path:
    """Where the library of ``sources`` (and the ``headers`` they include)
    lives once built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (*sources, *headers):
        h.update(Path(src).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_seconds(name: str) -> float:
    """Seconds the first ``load_library(name, ...)`` of this process spent
    compiling (0.0 when the cached library was loaded)."""
    return _LOADED[name][1]


def load_library(name: str, sources: Sequence[Path],
                 headers: Sequence[Path] = ()) -> ctypes.CDLL:
    """Build (once per hash of sources and headers) and load ``sources`` as
    one library. Different libraries build concurrently from threads."""
    with _LOCK:
        lock = _LOCKS.setdefault(name, threading.Lock())
    with lock:
        if name in _LOADED:
            return _LOADED[name][0]
        out = library_path(name, sources, headers)
        seconds = 0.0
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   *(str(s) for s in sources)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{proc.stderr}")
            os.replace(tmp, out)           # atomic: no half-written library
        _LOADED[name] = (ctypes.CDLL(str(out)), seconds)
        return _LOADED[name][0]
