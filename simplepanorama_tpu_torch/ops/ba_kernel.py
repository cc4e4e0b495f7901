"""Bundle-adjustment normal equations accumulated from per-match streams.

Port of simplepanorama_tpu/ops/ba_kernel.py. From the small per-match
tensors of the chain rule it builds the camera-space sums

    U   = sum_m J_m^T J_m            (6N, 6N)
    eA  = sum_m J_m^T r_m            (6N,)    (+J^T r; ba negates it)
    YW  = sum_m W_m V_m^-1 W_m^T     (6N, 6N),  W_m = J_m^T B_m
    yeb = sum_m W_m (V_m^-1 eB_m)    (6N,)

Inputs: Jacobian rows ``ai``, ``aj`` (M, 2, 6) of cameras ``mi``, ``mj``;
the projected-row B block ``bp`` (M, 2, 2); projected residual rows
``r2`` (M, 2); the 2x2 Cholesky factors ``l00, l10, l11`` of V^-1 and
``g0, g1`` = V^-1 eB (M,). Without the Schur terms (``with_schur=False``,
the Lowe objective's system) YW and yeb are zeros.

``assemble_streams_ref`` is the plain version: the TPU kernel's
``_stream_block`` over the whole array (camera masks, dense (M, 6N) rows,
four products). ``assemble_streams`` dispatches on where its tensors
live: CPU tensors take the plain version; CUDA tensors launch
``csrc/ba_assemble.cu`` (built with nvcc at first use) or raise. Like the
JAX package, the port's ``ba`` does not call it; ``streams_from_problem``
rebuilds its inputs from a BA state.
"""

from __future__ import annotations

import ctypes

import torch

_BLOCK = 512
_FLOATS = ("ai", "aj", "bp", "r2", "l00", "l10", "l11", "g0", "g1")


def assemble_streams_ref(ai, aj, bp, r2, l00, l10, l11, g0, g1, mi, mj,
                         n_cams: int, with_schur: bool = True):
    """Plain PyTorch version: one whole-array block of _stream_block.
    Returns (U (6N, 6N), eA (6N,), YW (6N, 6N), yeb (6N,))."""
    sN = 6 * n_cams
    cam = torch.arange(sN, device=ai.device) // 6
    # an id outside [0, N) matches no column: the match adds nothing there
    mi_mask = (cam[None, :] == mi.reshape(-1, 1)).to(ai.dtype)
    mj_mask = (cam[None, :] == mj.reshape(-1, 1)).to(aj.dtype)
    jr0 = mi_mask * ai[:, 0, :].repeat(1, n_cams) \
        + mj_mask * aj[:, 0, :].repeat(1, n_cams)
    jr1 = mi_mask * ai[:, 1, :].repeat(1, n_cams) \
        + mj_mask * aj[:, 1, :].repeat(1, n_cams)
    U = jr0.T @ jr0 + jr1.T @ jr1
    eA = jr0.T @ r2[:, 0] + jr1.T @ r2[:, 1]
    if not with_schur:
        return U, eA, torch.zeros_like(U), torch.zeros_like(eA)
    col = lambda x: x.reshape(-1, 1)
    w0 = jr0 * col(bp[:, 0, 0]) + jr1 * col(bp[:, 1, 0])
    w1 = jr0 * col(bp[:, 0, 1]) + jr1 * col(bp[:, 1, 1])
    z0 = w0 * col(l00) + w1 * col(l10)
    z1 = w1 * col(l11)
    YW = z0.T @ z0 + z1.T @ z1
    yeb = w0.T @ g0 + w1.T @ g1
    return U, eA, YW, yeb


_LIB = {}


def build(rebuild: bool = False) -> float:
    """Build (or reuse, unless ``rebuild``) csrc/ba_assemble.cu; returns
    the seconds spent building in this process."""
    from simplepanorama_tpu_torch.utils.nvcc import load_library
    lib, seconds = load_library("spt_ba_assemble", ["ba_assemble.cu"],
                                rebuild=rebuild)
    if not _LIB:
        lib.spt_ba_assemble_scratch.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
        lib.spt_ba_assemble_scratch.restype = ctypes.c_int
        lib.spt_ba_assemble.argtypes = [ctypes.c_void_p] * 16 + \
            [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.spt_ba_assemble.restype = ctypes.c_int
        lib.spt_error_string.argtypes = [ctypes.c_int]
        lib.spt_error_string.restype = ctypes.c_char_p
        _LIB["lib"] = lib
    return seconds


def _check(args, mi, mj, n_cams: int):
    """Shapes, types and devices of the streams; returns M."""
    ai = args[0]
    if ai.dim() != 3 or tuple(ai.shape[1:]) != (2, 6):
        raise ValueError(f"ai must be (M, 2, 6), got {tuple(ai.shape)}")
    M = ai.shape[0]
    shapes = {"ai": (M, 2, 6), "aj": (M, 2, 6), "bp": (M, 2, 2),
              "r2": (M, 2), "l00": (M,), "l10": (M,), "l11": (M,),
              "g0": (M,), "g1": (M,)}
    for name, t in zip(_FLOATS, args):
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shapes[name]}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {t.dtype}, expected float32")
        if t.device != ai.device:
            raise ValueError(f"{name} is on {t.device}, ai on {ai.device}")
    for name, t in (("mi", mi), ("mj", mj)):
        if tuple(t.shape) != (M,):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected ({M},)")
        if t.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"{name} has dtype {t.dtype}, expected int32 "
                            "or int64")
        if t.device != ai.device:
            raise ValueError(f"{name} is on {t.device}, ai on {ai.device}")
    if ai.device.type not in ("cpu", "cuda"):
        raise ValueError(f"assemble_streams runs on cpu or cuda, not "
                         f"{ai.device}")
    if n_cams < 1:
        raise ValueError(f"n_cams must be >= 1, got {n_cams}")
    block = min(_BLOCK, M)
    if block < 1 or M % block:
        raise ValueError(f"M = {M} matches must be a positive multiple of "
                         f"min(512, M) (the match block)")
    return M


def assemble_streams(ai, aj, bp, r2, l00, l10, l11, g0, g1, mi, mj,
                     n_cams: int, with_schur: bool = True):
    """Fused accumulation over the matches (port of assemble_streams).
    Float inputs float32, ``mi``/``mj`` int32 or int64, all on one device;
    M a multiple of min(512, M), as the JAX kernel requires. Returns
    (U (6N, 6N), eA (6N,), YW (6N, 6N), yeb (6N,)) float32. CPU tensors
    run assemble_streams_ref; CUDA tensors launch csrc/ba_assemble.cu and
    count the launch in ``assemble_streams.launches``."""
    floats = (ai, aj, bp, r2, l00, l10, l11, g0, g1)
    M = _check(floats, mi, mj, n_cams)
    if ai.device.type == "cpu":
        return assemble_streams_ref(*floats, mi, mj, n_cams,
                                    with_schur=with_schur)
    build()
    lib = _LIB["lib"]
    floats = [t.contiguous() for t in floats]
    ids = [t.to(torch.int32).contiguous() for t in (mi, mj)]
    n_scratch = ctypes.c_longlong()
    rc = lib.spt_ba_assemble_scratch(M, n_cams, ctypes.byref(n_scratch))
    if rc != 0:
        raise RuntimeError("assemble_streams kernel: "
                           + lib.spt_error_string(rc).decode()
                           + f" (M={M}, n_cams={n_cams})")
    dev = ai.device
    sN = 6 * n_cams
    f32 = dict(dtype=torch.float32, device=dev)
    U, YW = torch.empty((sN, sN), **f32), torch.empty((sN, sN), **f32)
    eA, yeb = torch.empty(sN, **f32), torch.empty(sN, **f32)
    part = torch.empty(n_scratch.value, **f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.spt_ba_assemble(
            *(t.data_ptr() for t in floats), *(t.data_ptr() for t in ids),
            U.data_ptr(), eA.data_ptr(), YW.data_ptr(), yeb.data_ptr(),
            part.data_ptr(), M, n_cams, int(bool(with_schur)), stream)
    if rc != 0:
        raise RuntimeError("assemble_streams kernel failed: "
                           + lib.spt_error_string(rc).decode())
    assemble_streams.launches += 1
    return U, eA, YW, yeb


assemble_streams.launches = 0


def streams_from_problem(cams, data, active_m, lam, cam_active, n_cams: int,
                         fast: bool):
    """The 11 input streams of assemble_streams for one BA state of
    ``n_cams`` camera slots (``cam_active`` marks the live ones), as
    tests/test_ba_kernel.py rebuilds them from ba._assemble: Ai, Aj
    (M, 2, 6), B23 (M, 2, 2), r[:, 2:] (M, 2), the Cholesky factors
    l00, l10, l11 of the augmented V^-1 at ``lam``, g = V^-1 e_B, mi, mj;
    all zero on inactive matches. ``fast`` (the Lowe objective) projects
    b = t and has no V: its l and g streams are zeros."""
    from simplepanorama_tpu_torch import ba
    if cam_active.shape != (n_cams,):
        raise ValueError(f"cam_active has shape {tuple(cam_active.shape)}, "
                         f"expected ({n_cams},)")
    r, Ai, Aj, B = ba._jacobian_streams(cams, data, active_m, fast)
    M = r.shape[0]
    if fast:
        l00 = l10 = l11 = g0 = g1 = r.new_zeros(M)
    else:
        V, eB = ba._v_and_eb(B, r)
        Vinv = ba._v_inverse(V, ba._focal_last(cams, cam_active), lam,
                             active_m)
        l00, l10, l11, g0, g1 = ba._cholesky_streams(Vinv, eB)
    c = lambda t: t.contiguous()
    return (c(Ai), c(Aj), c(B[:, 2:, :]), c(r[:, 2:]), c(l00), c(l10),
            c(l11), c(g0), c(g1), data.mi, data.mj)
