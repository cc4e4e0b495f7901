#!/usr/bin/env python3
"""Kernel 3 (csrc/ba_assemble.cu) against an earlier version of its
source, timed in turns on one CUDA card, at the capacity buckets the
bundle adjustment gives it.

    python3 kernel3_turns.py OLD.cu

OLD.cu is an earlier ba_assemble.cu with the two-launch C interface
(spt_ba_assemble_scratch, then spt_ba_assemble with a scratch buffer),
for example the one that `git show <commit>:simplepanorama_tpu_torch/
csrc/ba_assemble.cu` prints. The script stitches the 12-view 700-px
360-degree loop of chip_smoke.py twice (relaxed, then Lowe objective),
keeps the state each capacity bucket of the schedule ends with, rebuilds
kernel 3's streams there, checks both versions against the plain one
and times them in turns (new, old, old, new): CUDA events around one
call (median of 50) and device time from torch.profiler. One JSON line
per bucket and objective; the card's name and power limit first.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time


def _build_old(path):
    """nvcc of ``path`` with the package's flags into build/kernels/."""
    import ctypes
    import hashlib
    from simplepanorama_tpu_torch.utils import nvcc
    src = open(path, "rb").read()
    so = nvcc.BUILD_DIR / ("libspt_ba_assemble_old-"
                           + hashlib.sha256(src).hexdigest()[:16] + ".so")
    nvcc.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([nvcc._nvcc(), *nvcc.NVCC_FLAGS, "-o", str(so), path],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.spt_ba_assemble_scratch.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
    lib.spt_ba_assemble_scratch.restype = ctypes.c_int
    lib.spt_ba_assemble.argtypes = [ctypes.c_void_p] * 16 + \
        [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.spt_ba_assemble.restype = ctypes.c_int
    return lib


def _old_call(torch, lib, streams, n_cams, with_schur):
    """A call of the old version, as its wrapper made it: scratch query,
    int32 ids, allocations, two launches."""
    import ctypes
    M = streams[0].shape[0]
    n = ctypes.c_longlong()
    if lib.spt_ba_assemble_scratch(M, n_cams, ctypes.byref(n)):
        raise RuntimeError("old kernel: scratch query failed")
    dev = streams[0].device
    f32 = dict(dtype=torch.float32, device=dev)
    sN = 6 * n_cams
    outs = [torch.empty((sN, sN), **f32), torch.empty(sN, **f32),
            torch.empty((sN, sN), **f32), torch.empty(sN, **f32)]
    part = torch.empty(n.value, **f32)
    ids = [t.to(torch.int32) for t in streams[9:]]
    rc = lib.spt_ba_assemble(
        *(t.data_ptr() for t in streams[:9]), *(t.data_ptr() for t in ids),
        outs[0].data_ptr(), outs[1].data_ptr(), outs[2].data_ptr(),
        outs[3].data_ptr(), part.data_ptr(), M, n_cams, int(with_schur),
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"old kernel: launch failed ({rc})")
    return outs


def _bucket_states(torch, paths, fast):
    """{(n_cap, m_cap): (cams, active, data)} at the end of each bucket of
    the stitch of ``paths``."""
    from simplepanorama_tpu_torch import Config, Panorama, stitch
    states = {}
    chunk = stitch._lm_chunk

    def recording(cams, active, data, *a, **kw):
        out = chunk(cams, active, data, *a, **kw)
        states[out[0].focal.shape[0], data.mi.shape[0]] = (
            out[0], active.clone(), data)
        return out
    stitch._lm_chunk = recording
    try:
        Panorama(paths, device="cuda").stitch(Config(fast=fast))
    finally:
        stitch._lm_chunk = chunk
    return states


def _events_ms(torch, fn, reps=50):
    ts = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        ts.append(e0.elapsed_time(e1))
    return statistics.median(ts)


def main():
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel3_turns: no CUDA card")
    import chip_smoke
    from simplepanorama_tpu_torch import ba
    from simplepanorama_tpu_torch.fixtures import fkh360_views
    from simplepanorama_tpu_torch.ops import ba_kernel
    from simplepanorama_tpu_torch.pipeline import full_precision
    full_precision()
    print(chip_smoke._nvidia_smi(), flush=True)
    old = _build_old(sys.argv[1])
    ba_kernel.build()
    card = torch.cuda.get_device_name(0)
    with tempfile.TemporaryDirectory() as tmp:
        paths, _, _ = fkh360_views(12, 700, out_dir=os.path.join(tmp, "v"))
        for fast in (False, True):
            for (n_cap, m_cap), (cams, active, data) in sorted(
                    _bucket_states(torch, paths, fast).items()):
                am = ba._active_matches(data, active)
                streams = ba.streams_from_problem(cams, data, am, 0.05,
                                                  active, n_cap, fast)
                streams = list(streams[:9]) + [t.to(torch.int32)
                                               for t in streams[9:]]
                ws = ba_kernel.workspace(m_cap, n_cap, "cuda")
                new = lambda: ba_kernel.assemble_streams(
                    *streams, n_cap, with_schur=not fast, ws=ws)
                prev = lambda: _old_call(torch, old, streams, n_cap,
                                         not fast)
                want = ba_kernel.assemble_streams_ref(
                    *streams, n_cap, with_schur=not fast)
                errs = {}
                for name, fn in (("new", new), ("old", prev)):
                    got = fn()
                    torch.cuda.synchronize()
                    errs[name] = max(float((g - w).abs().max()
                                           / (1e-3 * w.abs().max() + 1e-4))
                                     for g, w in zip(got, want))
                ms = {"new": [], "old": []}
                for name in ("new", "old", "old", "new"):
                    fn = new if name == "new" else prev
                    fn()
                    ms[name].append(_events_ms(torch, fn))
                dev = {
                    "new": chip_smoke._device_ms(torch, new, (),
                                                 ("assemble_kernel",), 20),
                    "old": chip_smoke._device_ms(
                        torch, prev, (), ("partial_kernel",
                                          "reduce_kernel"), 20)}
                bound = chip_smoke._ba_bound(streams[9], streams[10], n_cap,
                                             not fast)
                print(json.dumps({
                    "bucket": [n_cap, m_cap], "fast": fast,
                    "active_matches": int(am.sum()), "ctas": ws.ctas,
                    "err_over_tol": errs, "ms_in_turns": ms,
                    "device_ms": dev, "bound_ms": bound[0],
                    "bound_by": bound[1], "device": card}), flush=True)
                if max(errs.values()) > 1.0:
                    raise RuntimeError(f"bucket {n_cap, m_cap}: {errs}")


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(json.dumps({"seconds": time.perf_counter() - t0}))
