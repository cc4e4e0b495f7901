"""The LM trial around kernel 3: kernel 4, the per-match streams, and
kernel 5, the solve and the accept test.

No TPU kernel is replaced: the JAX package's trial is the body of its
``lax.while_loop`` (simplepanorama_tpu/ba.py), which XLA fuses. On the
card a single-card trial (ba.LMProgram, every bucket) is three launches
captured in one CUDA graph:

    trial_streams     kernel 4 (csrc/ba_trial.cu): from the trial state,
                      the pair tables and each match's chain rule, into
                      the workspace's streams;
    assemble_streams  kernel 3 (ops/ba_kernel, unchanged): the camera
                      system from the first nine of them;
    solve_accept      kernel 5 (csrc/ba_trial.cu): the augment and mask,
                      the preconditioned LU solve, the back-substitution,
                      the trial error and the accept test, written into
                      the state and the termination flag in place.

The plain versions are ba.trial_streams_ref and ba.solve_accept_ref,
which ba.lm_step chains with assemble_streams: the LM's own code, which
the sharded trial and the CPU run. Each wrapper launches its kernel
(built with nvcc at first use) on CUDA tensors and raises on others.
``workspace`` holds a bucket's plan and buffers. A bucket whose pair
tables (beyond ~480 pairs) or camera system (beyond 40 cameras) outgrow
a CTA's shared memory takes a global route for them: kernel 4 after
pair_tables_kernel, kernel 5 as solve_accept_global_kernel, with their
workspace in global memory.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from simplepanorama_tpu_torch.utils.nvcc import count_launches


class TrialStreams(NamedTuple):
    """Kernel 4's outputs: kernel 3's nine float streams (Ai23, Aj23
    (M, 2, 6), B23 (M, 2, 2), the projected residual rows (M, 2), the
    Cholesky factors l00, l10, l11 of V^-1 and g = V^-1 e_B (M,)), then
    e_B (M, 2) and V^-1 (M, 2, 2), which the back-substitution reads
    (None in the plain version of the Lowe objective)."""
    ai: torch.Tensor
    aj: torch.Tensor
    bp: torch.Tensor
    r2: torch.Tensor
    l00: torch.Tensor
    l10: torch.Tensor
    l11: torch.Tensor
    g0: torch.Tensor
    g1: torch.Tensor
    eB: Optional[torch.Tensor]
    vinv: Optional[torch.Tensor]


_LIB = {}


def build(rebuild: bool = False) -> float:
    """Build (or reuse, unless ``rebuild``) csrc/ba_trial.cu; returns the
    seconds spent building in this process."""
    from simplepanorama_tpu_torch.utils.nvcc import load_library
    lib, seconds = load_library("spt_ba_trial", ["ba_trial.cu"],
                                rebuild=rebuild)
    if not _LIB:
        lib.spt_ba_trial_init.argtypes = []
        lib.spt_ba_trial_init.restype = ctypes.c_int
        lib.spt_ba_trial_plan.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_longlong)]
        lib.spt_ba_trial_plan.restype = ctypes.c_int
        lib.spt_ba_trial_streams.argtypes = [ctypes.c_void_p] + \
            [ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.spt_ba_trial_streams.restype = ctypes.c_int
        lib.spt_ba_trial_solve.argtypes = [ctypes.c_void_p] + \
            [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.spt_ba_trial_solve.restype = ctypes.c_int
        lib.spt_ba_trial_error_string.argtypes = [ctypes.c_int]
        lib.spt_ba_trial_error_string.restype = ctypes.c_char_p
        _raise_on(lib, lib.spt_ba_trial_init(), "init")
        _LIB["lib"] = lib
    return seconds


def _raise_on(lib, rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"LM trial kernel ({what}): "
                           + lib.spt_ba_trial_error_string(rc).decode())


class Workspace(NamedTuple):
    """The plan and buffers of kernels 4 and 5 for one bucket (M matches,
    ``n_cams`` cameras, P pair rows) on one card: the streams kernel 4
    writes and kernels 3 and 5 read, kernel 5's trial b, and the global
    workspaces of the routes whose data outgrow a CTA's shared memory
    (None on the shared routes): kernel 4's pair tables and kernel 5's
    system."""
    M: int
    n_cams: int
    P: int
    ctas: int
    smem_streams: int
    smem_solve: int
    table_ctas: int
    streams: TrialStreams
    b_trial: torch.Tensor
    tables: Optional[torch.Tensor]
    system: Optional[torch.Tensor]


def workspace(M: int, n_cams: int, P: int, device) -> Workspace:
    """Plan and buffers for ``M`` matches, ``n_cams`` cameras and ``P``
    pair rows on the CUDA ``device`` (builds the kernels)."""
    build()
    lib = _LIB["lib"]
    dev = torch.device(device)
    plan = (ctypes.c_longlong * 6)()
    with torch.cuda.device(dev):
        _raise_on(lib, lib.spt_ba_trial_plan(M, n_cams, P, plan),
                  f"plan, M={M}, n_cams={n_cams}, P={P}")
    f = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    streams = TrialStreams(
        ai=f(M, 2, 6), aj=f(M, 2, 6), bp=f(M, 2, 2), r2=f(M, 2),
        l00=f(M), l10=f(M), l11=f(M), g0=f(M), g1=f(M), eB=f(M, 2),
        vinv=f(M, 2, 2))
    return Workspace(M=M, n_cams=n_cams, P=P, ctas=plan[0],
                     smem_streams=plan[1], smem_solve=plan[2],
                     table_ctas=plan[5], streams=streams, b_trial=f(M, 2),
                     tables=f(plan[3]) if plan[3] else None,
                     system=f(plan[4]) if plan[4] else None)


def _pointers(st, pb, ws: Workspace, sums=None, live=None):
    """The 39 device pointers of csrc/ba_trial.cu's interface, after
    checking every tensor's device, type, shape and layout (16-byte
    aligned: the kernels load a match's values as float2 and float4)."""
    M, N, P = ws.M, ws.n_cams, ws.P
    dev = ws.b_trial.device
    f32, i32, i64, b8 = torch.float32, torch.int32, torch.int64, torch.bool
    d = pb.data
    U = (6 * N, 6 * N)
    spec = [
        ("focal", st.cams.focal, f32, (N,)),
        ("ppal", st.cams.ppal, f32, (N, 2)),
        ("rotvec", st.cams.rotvec, f32, (N, 3)),
        ("b", st.cams.b, f32, (M, 2)),
        ("err", st.err, f32, ()), ("lam", st.lam, f32, ()),
        ("it", st.it, i64, ()), ("strikes", st.strikes, i64, ()),
        ("n_acc", st.n_acc, i64, ()), ("live", live, b8, ()),
        ("mi", pb.mi, i32, (M,)), ("mj", pb.mj, i32, (M,)),
        ("mp", d.mp, i64, (M,)), ("pi", d.pi, i64, (P,)),
        ("pj", d.pj, i64, (P,)), ("q", d.q, f32, (M, 2)),
        ("t", d.t, f32, (M, 2)), ("active_m", pb.active_m, b8, (M,)),
        ("cam_active", pb.cam_active, b8, (N,)),
        ("vaug_idx", pb.vaug_idx, i64, ()),
        ("max_iter", pb.max_iter, i64, ()),
        *((k, v, f32, tuple(v.shape)) for k, v in
          zip(TrialStreams._fields, ws.streams)),
        *((k, v, f32, s) for k, v, s in zip(
            ("U", "eA", "YW", "yeb"), sums or (None,) * 4,
            (U, U[:1], U, U[:1]))),
        ("b_trial", ws.b_trial, f32, (M, 2)),
        *((k, v, f32, None if v is None else tuple(v.shape)) for k, v in
          (("tables", ws.tables), ("system", ws.system)))]
    ptrs = []
    for name, t, dtype, shape in spec:
        if t is None:
            ptrs.append(0)
            continue
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(
                f"{name}: {tuple(t.shape)} {t.dtype} on {t.device}, "
                f"contiguous {t.is_contiguous()}, at {t.data_ptr():#x}; "
                f"the trial kernels take {shape} {dtype} on {dev}, "
                "contiguous and 16-byte aligned")
        ptrs.append(t.data_ptr())
    return ptrs


def _launched(wrapper):
    """Count a launch, or its recording under a CUDA graph capture (the
    graph's replays count it, ba.LMProgram.run)."""
    if torch.cuda.is_current_stream_capturing():
        wrapper.recorded += 1
    else:
        count_launches(wrapper)


def _array(ptrs):
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def trial_streams(st, pb, fast: bool, ws: Workspace) -> TrialStreams:
    """Kernel 4: the streams of the trial from state ``st`` (ba.LMState)
    of problem ``pb`` (ba.LMProblem), launched into ``ws``'s streams
    (returned) on the current stream, after pair_tables_kernel on the
    global route. A trial after the run's end launches kernels that
    return at once."""
    ptrs = _pointers(st, pb, ws)
    lib = _LIB["lib"]
    with torch.cuda.device(ws.b_trial.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.spt_ba_trial_streams(_array(ptrs), ws.M, ws.n_cams, ws.P,
                                      int(bool(fast)), ws.ctas,
                                      ws.smem_streams, ws.table_ctas,
                                      stream)
    _raise_on(lib, rc, "streams launch")
    _launched(trial_streams)
    return ws.streams


def solve_accept(st, pb, fast: bool, streams: TrialStreams, sums,
                 live: torch.Tensor, ws: Workspace) -> None:
    """Kernel 5: from kernel 3's ``sums`` (U, +J^T r, YW, yeb) and
    ``streams``, solve the trial's camera system, form its cameras and b
    and its error, and accept or reject it as ba.lm_step does, writing
    ``st``'s tensors and the termination flag ``live`` in place; launched
    (one CTA) on the current stream."""
    if streams is not ws.streams:
        raise ValueError("solve_accept reads the streams of its workspace")
    ptrs = _pointers(st, pb, ws, sums, live)
    lib = _LIB["lib"]
    with torch.cuda.device(ws.b_trial.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.spt_ba_trial_solve(_array(ptrs), ws.M, ws.n_cams, ws.P,
                                    int(bool(fast)), ws.smem_solve, stream)
    _raise_on(lib, rc, "solve launch")
    _launched(solve_accept)


trial_streams.launches = 0
trial_streams.recorded = 0
solve_accept.launches = 0
solve_accept.recorded = 0
