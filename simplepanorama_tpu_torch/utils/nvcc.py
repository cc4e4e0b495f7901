"""Build-at-first-use for the hand-written CUDA kernels.

Each kernel source under ``simplepanorama_tpu_torch/csrc`` exposes a plain
C interface; it is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library named by a hash of its sources and flags, cached in
``build/kernels/`` at the repository root, and loaded with ``ctypes``.
Nothing is built when a module is imported: the first call that launches
a kernel builds it. A missing ``nvcc`` or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from collections import defaultdict
from typing import Dict, Sequence, Tuple

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC")

# one lock per library, so different libraries build at the same time
_LOCKS: Dict[str, threading.Lock] = defaultdict(threading.Lock)
_LOCKS_GUARD = threading.Lock()
_LIBS: Dict[str, Tuple[ctypes.CDLL, float]] = {}
_COUNT_LOCK = threading.Lock()


def count_launches(wrapper, n: int = 1) -> None:
    """Add ``n`` to ``wrapper.launches``, a kernel wrapper's launch count,
    under one lock: stitches in several threads launch the kernels."""
    with _COUNT_LOCK:
        wrapper.launches += n


def _nvcc() -> str:
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(exe):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return exe


def load_library(name: str, sources: Sequence[str],
                 rebuild: bool = False) -> Tuple[ctypes.CDLL, float]:
    """Compile (once per source hash, or anew with ``rebuild`` unless
    this process already loaded it) and load ``lib<name>``.

    Returns (library, seconds spent building in this process; 0.0 when
    the cached build was reused)."""
    with _LOCKS_GUARD:
        lock = _LOCKS[name]
    with lock:
        if name in _LIBS:
            return _LIBS[name]
        paths = [CSRC / s for s in sources]
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        # the sources and every header they may include
        for p in paths + sorted(CSRC.glob("*.cuh")):
            h.update(p.read_bytes())
        so = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
        seconds = 0.0
        if rebuild or not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, paths)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
            so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
            os.replace(tmp, so)
        _LIBS[name] = (ctypes.CDLL(str(so)), seconds)
        return _LIBS[name]
