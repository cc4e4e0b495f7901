"""The host min-cut: ctypes binding of native/mincut.cpp.

Port of simplepanorama_tpu/native.py. ``native/mincut.cpp`` is an exact
Dinic max-flow on the 4-connected seam grid (the slot the reference's
vendored Boykov-Kolmogorov solver fills); the CPU seam finder
(render/graphcut._solve_cut on CPU tensors) calls it, as the JAX package
does on its CPU backend.

The shared object is compiled with ``g++ -O3 -shared -fPIC`` at first use
into ``build/native/`` at the repository root (gitignored), named by a
hash of the source and the flags; ``native/`` itself is never written.
A failed build raises NativeUnavailable with the compiler's message, and
later calls in the process raise it again without building; the CPU
seam finder (render/graphcut._solve_cut) then takes the plain solver, as
the JAX package takes its XLA one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_REPO = pathlib.Path(__file__).resolve().parent.parent
SOURCE = _REPO / "native" / "mincut.cpp"
BUILD_DIR = _REPO / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
# the shared object whose build failed in this process, and the message;
# a library of other sources or flags is built anew
_FAILED: Optional[Tuple[pathlib.Path, str]] = None


class NativeUnavailable(RuntimeError):
    """g++ is missing or refused native/mincut.cpp."""


def _build(so: pathlib.Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise NativeUnavailable(f"cannot run {cmd[0]}: {e}") from e
    if proc.returncode != 0:
        raise NativeUnavailable(f"g++ failed to build {SOURCE}:\n"
                               f"{proc.stderr}")
    os.replace(tmp, so)


def _lib() -> ctypes.CDLL:
    global _LIB, _FAILED
    with _LOCK:
        if _LIB is not None:
            return _LIB
        h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
        h.update(SOURCE.read_bytes())
        so = BUILD_DIR / f"libspt_mincut-{h.hexdigest()[:16]}.so"
        if _FAILED is not None and _FAILED[0] == so:
            raise NativeUnavailable(_FAILED[1])
        if not so.exists():
            try:
                _build(so)
            except NativeUnavailable as e:
                _FAILED = (so, str(e))
                raise
        lib = ctypes.CDLL(str(so))
        lib.grid_mincut.restype = ctypes.c_float
        lib.grid_mincut.argtypes = [
            ctypes.c_int, ctypes.c_int,
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ]
        _LIB = lib
        return lib


def _host(x) -> np.ndarray:
    """A numpy view of a tensor (any device) or array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def grid_mincut_native(cap_h, cap_v, excess, node) -> Tuple[np.ndarray,
                                                            float]:
    """Exact min cut (Dinic) of the seam grid: ``cap_h``/``cap_v`` the
    right/down edge capacities, ``excess`` the signed t-links (+source,
    -sink), ``node`` the node mask, each (H, W), numpy or tensors.
    Returns (source side, bool (H, W) numpy, the max-flow value)."""
    cap_h, cap_v, excess, node = map(_host, (cap_h, cap_v, excess, node))
    H, W = cap_h.shape
    out = np.zeros(H * W, np.uint8)
    flow = _lib().grid_mincut(
        H, W,
        np.ascontiguousarray(cap_h, np.float32),
        np.ascontiguousarray(cap_v, np.float32),
        np.ascontiguousarray(excess, np.float32),
        np.ascontiguousarray(node, np.uint8),
        out)
    return out.reshape(H, W).astype(bool), float(flow)
