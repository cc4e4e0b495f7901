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
``csrc/ba_assemble.cu`` (built with nvcc at first use) or raise. Unlike
the JAX package, which left its kernel unwired, the port's ``ba`` calls it
once per LM trial on every device (``ba.streams_from_problem`` builds its
inputs from a BA state).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

_BLOCK = 512
_FLOATS = ("ai", "aj", "bp", "r2", "l00", "l10", "l11", "g0", "g1")


def assemble_streams_ref(ai, aj, bp, r2, l00, l10, l11, g0, g1, mi, mj,
                         n_cams: int, with_schur: bool = True):
    """Plain PyTorch version: one whole-array block of _stream_block.
    Returns (U (6N, 6N), eA (6N,), YW (6N, 6N), yeb (6N,)). The per-match
    terms are float32 products, as the kernels form them; their sums over
    the matches run in float64 and are rounded once, so the result does
    not depend on a summation order (the gradient e_A cancels strongly
    near a minimum, where a float32 sum in one order or another moves an
    LM step by ~1e-5)."""
    sN = 6 * n_cams
    cam = torch.arange(sN, device=ai.device) // 6
    # an id outside [0, N) matches no column: the match adds nothing there
    mi_mask = (cam[None, :] == mi.reshape(-1, 1)).to(ai.dtype)
    mj_mask = (cam[None, :] == mj.reshape(-1, 1)).to(aj.dtype)
    jr0 = mi_mask * ai[:, 0, :].repeat(1, n_cams) \
        + mj_mask * aj[:, 0, :].repeat(1, n_cams)
    jr1 = mi_mask * ai[:, 1, :].repeat(1, n_cams) \
        + mj_mask * aj[:, 1, :].repeat(1, n_cams)

    def sums(a0, b0, a1, b1):   # a0^T b0 + a1^T b1 over the matches
        d = lambda x: x.to(torch.float64)
        return (d(a0).T @ d(b0) + d(a1).T @ d(b1)).to(torch.float32)
    U = sums(jr0, jr0, jr1, jr1)
    eA = sums(jr0, r2[:, 0], jr1, r2[:, 1])
    if not with_schur:
        return U, eA, torch.zeros_like(U), torch.zeros_like(eA)
    col = lambda x: x.reshape(-1, 1)
    w0 = jr0 * col(bp[:, 0, 0]) + jr1 * col(bp[:, 1, 0])
    w1 = jr0 * col(bp[:, 0, 1]) + jr1 * col(bp[:, 1, 1])
    z0 = w0 * col(l00) + w1 * col(l10)
    z1 = w1 * col(l11)
    return U, eA, sums(z0, z0, z1, z1), sums(w0, g0, w1, g1)


_LIB = {}


def build(rebuild: bool = False) -> float:
    """Build (or reuse, unless ``rebuild``) csrc/ba_assemble.cu; returns
    the seconds spent building in this process."""
    from simplepanorama_tpu_torch.utils.nvcc import load_library
    lib, seconds = load_library("spt_ba_assemble", ["ba_assemble.cu"],
                                rebuild=rebuild)
    if not _LIB:
        lib.spt_ba_assemble_init.argtypes = []
        lib.spt_ba_assemble_init.restype = ctypes.c_int
        lib.spt_ba_assemble_plan.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
        lib.spt_ba_assemble_plan.restype = ctypes.c_int
        lib.spt_ba_assemble.argtypes = [ctypes.c_void_p] * 17 + \
            [ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.spt_ba_assemble.restype = ctypes.c_int
        lib.spt_error_string.argtypes = [ctypes.c_int]
        lib.spt_error_string.restype = ctypes.c_char_p
        _raise_on(lib, lib.spt_ba_assemble_init(), "init")
        _LIB["lib"] = lib
    return seconds


def _raise_on(lib, rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"assemble_streams kernel ({what}): "
                           + lib.spt_error_string(rc).decode())


class Workspace(NamedTuple):
    """The kernel's launch plan and scratch for one (M, n_cams) on one
    card: made once per capacity bucket, then passed to every call."""
    M: int
    n_cams: int
    ctas: int
    per_cta: int
    off_in_smem: int
    smem: int
    part: torch.Tensor    # float32 partial sums, one slot per CTA and block
    flags: torch.Tensor   # uint8 touched flags, one per CTA and block


def workspace(M: int, n_cams: int, device) -> Workspace:
    """Plan and scratch of assemble_streams for ``M`` matches and
    ``n_cams`` cameras on the CUDA ``device`` (builds the kernel)."""
    build()
    lib = _LIB["lib"]
    dev = torch.device(device)
    plan = (ctypes.c_longlong * 6)()
    with torch.cuda.device(dev):
        _raise_on(lib, lib.spt_ba_assemble_plan(M, n_cams, plan),
                  f"plan, M={M}, n_cams={n_cams}")
    return Workspace(
        M=M, n_cams=n_cams, ctas=plan[0], per_cta=plan[1],
        off_in_smem=plan[2], smem=plan[3],
        part=torch.empty(plan[4], dtype=torch.float32, device=dev),
        flags=torch.empty(plan[5], dtype=torch.uint8, device=dev))


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
                     n_cams: int, with_schur: bool = True,
                     ws: Optional[Workspace] = None):
    """Fused accumulation over the matches (port of assemble_streams).
    Float inputs float32, ``mi``/``mj`` int32 or int64, all on one device;
    M a multiple of min(512, M), as the JAX kernel requires. Returns
    (U (6N, 6N), eA (6N,), YW (6N, 6N), yeb (6N,)) float32. CPU tensors
    run assemble_streams_ref; CUDA tensors launch csrc/ba_assemble.cu and
    count the launch in ``assemble_streams.launches``. On the card,
    ``ws`` (from ``workspace``) saves the plan and the scratch of each
    call, and int32 ids save their copy: a caller that launches many
    times at one shape passes both."""
    floats = (ai, aj, bp, r2, l00, l10, l11, g0, g1)
    M = _check(floats, mi, mj, n_cams)
    if ai.device.type == "cpu":
        return assemble_streams_ref(*floats, mi, mj, n_cams,
                                    with_schur=with_schur)
    if ws is None:
        ws = workspace(M, n_cams, ai.device)
    elif (ws.M, ws.n_cams) != (M, n_cams) or ws.part.device != ai.device:
        raise ValueError(f"workspace for M={ws.M}, n_cams={ws.n_cams} on "
                         f"{ws.part.device}, called with M={M}, "
                         f"n_cams={n_cams} on {ai.device}")
    lib = _LIB["lib"]
    floats = [t.contiguous() for t in floats]
    # float4 loads of ai, aj and bp, float2 of r2
    for name, t, align in zip(("ai", "aj", "bp", "r2"), floats,
                              (16, 16, 16, 8)):
        if t.data_ptr() % align:
            raise ValueError(f"{name} is not {align}-byte aligned")
    ids = [t.to(torch.int32).contiguous() for t in (mi, mj)]
    dev = ai.device
    sN = 6 * n_cams
    f32 = dict(dtype=torch.float32, device=dev)
    U, YW = torch.empty((sN, sN), **f32), torch.empty((sN, sN), **f32)
    eA, yeb = torch.empty(sN, **f32), torch.empty(sN, **f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.spt_ba_assemble(
            *(t.data_ptr() for t in floats), *(t.data_ptr() for t in ids),
            U.data_ptr(), eA.data_ptr(), YW.data_ptr(), yeb.data_ptr(),
            ws.part.data_ptr(), ws.flags.data_ptr(), M, n_cams,
            int(bool(with_schur)), ws.ctas, ws.per_cta, ws.off_in_smem,
            ws.smem, stream)
    _raise_on(lib, rc, "launch")
    assemble_streams.launches += 1
    return U, eA, YW, yeb


assemble_streams.launches = 0

