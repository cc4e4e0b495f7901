#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (simplepanorama_tpu_torch).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases, each printing one line per input:
  env     the card (nvidia-smi name and power limit), torch/CUDA/nvcc;
  build   nvcc builds of csrc/mincut.cu, csrc/mincut_tiled.cu and
          csrc/ba_assemble.cu from the checkout's sources, all at once;
  kernel  grid_mincut (kernel 1, CUDA) against grid_mincut_ref (plain
          PyTorch) on the card: a 48x160 random grid with a hole, and a
          seam graph built by render/graphcut._build_cut_graph from two
          overlapping 700-px views at the packed block shape of slice 1;
          each line also has the solver's counters (outer rounds, BFS
          rounds, launches, host reads, device ns in push blocks and in
          BFSs) and the device ms of one solve by CUDA kernel name; then
          kernel 2 against kernel 1 on the seam graph, where kernel 1
          must keep its tiles resident (cut values within 1e-3);
  kernel2 grid_mincut_tiled (kernel 2) against grid_mincut_tiled_ref on
          the 48x160 grid and on a seam graph from two 1400-px views at
          the block shape of slice 2 (over 1.2M cells), with kernel 1 on
          the same seam graph beside it (there it takes kernel 2's route);
  crossover kernels 1 and 2 on seam graphs from two views of 850 to
          1000 px (kernel 1's route, both ms and cut values), and one BFS
          (maxflow.dist_to_sink) of each on a 128x128 serpentine maze:
          ms per unit of sink distance;
  kernel3 assemble_streams (kernel 3) against assemble_streams_ref, with
          and without the Schur terms, on random streams (N=8, M=1024 and
          N=40, M=20,480); the same on slice 3's own BA problem follows
          the slice3 phase;
  slice   a 12-view 360-degree loop of 700-px views through
          Panorama(paths, device="cuda").stitch(Config(cut=True))
          .get_preview(), with both kernels' launches counted;
  slice2  a 12-view loop of 2800-px views through
          Panorama(paths, device="cuda").stitch(Config(cut=True,
          init_size=1400, gain_compensation=True)), then get_preview()
          and get_panorama() (the full-res render), launches counted;
  slice3  a 12-view loop of 1400-px views through the CLI, as a user runs
          it: cli.main([dir, "--fast", "--timing", "--save-state", ...])
          (Lowe objective, default compositing), then cli.main(
          ["--from-state", ..., "--full-res", ...]); each command twice
          (cold, warm), no min-cut launches;
  kernel3 on the real BA problem of that stitch (its match tables at full
          capacity, 16 camera slots, the stitched cameras): the Lowe
          system and the relaxed one, held against the plain version and
          against the port's own assembly (ba._assemble_cache +
          _schur_solve_system), which is also timed, as computed and in
          the Jacobi scaling of the solve;
  cpu_vs_card  4 views of 640 px (preview 320 px) through the port on
          "cpu" and "cuda", with graph-cut seams and with the Lowe
          objective: previews and full-res panoramas.

Then one JSON line with the kernels' numbers and, last, the result line.
Any failure raises: the exit code is then non-zero and no result line
is printed. It needs no network and starts no process of its own except
nvidia-smi and nvcc.
"""

import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np


def _line(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def _nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _nvcc_version():
    from simplepanorama_tpu_torch.utils.nvcc import _nvcc
    out = subprocess.run([_nvcc(), "--version"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[-1]


def _time_ms(torch, fn, args, reps=5):
    """Median of ``reps`` warm runs, CUDA events (the caller has run
    ``fn`` once on the same inputs)."""
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn(*args)
        e1.record()
        torch.cuda.synchronize()
        ts.append(e0.elapsed_time(e1))
    return statistics.median(ts)


def _seam_graph(torch, tmp, size):
    """Seam graph of the second of two overlapping ``size``-px views
    against the first, warped with their true spherical geometry at the
    block shape of a loop of such views (what render/graphcut._cut_step
    hands the solver)."""
    import cv2
    from simplepanorama_tpu_torch.fixtures import fkh360_views
    from simplepanorama_tpu_torch.render import compose, graphcut
    paths, yaws, f = fkh360_views(2, size,
                                  out_dir=os.path.join(tmp, f"pair{size}"))
    imgs = [cv2.imread(p) for p in paths]
    Ks, Rs = [], []
    for im, yaw in zip(imgs, yaws):
        h, w = im.shape[:2]
        Ks.append(np.array([[f, 0, w // 2], [0, f, h // 2], [0, 0, 1.0]]))
        a = np.radians(yaw)
        Rs.append(np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                            [-np.sin(a), 0, np.cos(a)]]))
    st = compose.warp_all("spherical", f, imgs, Rs, Ks, [1.0, 1.0],
                          device="cuda")
    gray = graphcut._gray_batch(st.imgs)
    N, Hb, Wb = st.masks.shape
    H, W = st.canvas_hw
    canvas = torch.zeros((H + Hb, W + Wb), device="cuda")
    scene = torch.zeros((H + Hb, W + Wb), dtype=torch.bool, device="cuda")
    offs = st.offs.tolist()
    graphcut._paste_first(canvas, scene, gray[0], st.masks[0], offs[0])
    y, x = offs[1]
    return graphcut._build_cut_graph(
        canvas[y:y + Hb, x:x + Wb], gray[1],
        scene[y:y + Hb, x:x + Wb].float() * 255.0,
        st.masks[1].float() * 255.0)


def _coverage(img):
    """Share of the preview's nonzero bounding box that is filled."""
    nz = img.max(axis=2) > 0
    ys, xs = np.nonzero(nz)
    box = nz[ys.min():ys.max() + 1, xs.min():xs.max() + 1]
    return float(box.mean())


def _ncc(a, b):
    a = a.astype(np.float64).ravel()
    b = b.astype(np.float64).ravel()
    a -= a.mean()
    b -= b.mean()
    return float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()))


def _ncc_aligned(a, b, max_shift=3):
    """Best NCC of two previews over canvas shifts of up to ``max_shift``
    px: the two runs' float sums differ, so a canvas edge can round to
    another pixel. Returns (ncc, (dy, dx))."""
    best = (-1.0, (0, 0))
    for dy in range(-max_shift, max_shift + 1):
        for dx in range(-max_shift, max_shift + 1):
            h = min(a.shape[0], b.shape[0] - dy) - max(0, -dy)
            w = min(a.shape[1], b.shape[1] - dx) - max(0, -dx)
            ya, xa = max(0, -dy), max(0, -dx)
            pa = a[ya:ya + h, xa:xa + w]
            pb = b[ya + dy:ya + dy + h, xa + dx:xa + dx + w]
            best = max(best, (_ncc(pa, pb), (dy, dx)))
    return best


def _solve_pair(torch, maxflow, name, graph, kernel, plain, reps,
                plain_reps, card, phase, **plain_kw):
    """One solver input: the kernel and its plain version on the same
    tensors. Checks cut values within 1e-3 relative (float64 recount)
    and sides equal on >= 99.9% of nodes; prints one line; returns
    (|cut difference|, kernel ms, plain ms, the plain version's count of
    the work these inputs needed). The plain time is the median of
    ``plain_reps`` repeats, or with 0 its checking run (which also
    counts that work)."""
    side_k = kernel(*graph)
    stats = dict(kernel.last_stats)
    plain_stats = {}
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    side_r = plain(*graph, stats=plain_stats, **plain_kw)
    e1.record()
    torch.cuda.synchronize()
    plain_once_ms = e0.elapsed_time(e1)
    host = [t.cpu().numpy() for t in graph]
    node = host[3]
    sk, sr = side_k.cpu().numpy(), side_r.cpu().numpy()
    vk = maxflow.cut_value(*host, sk)
    vr = maxflow.cut_value(*host, sr)
    agree = float((sk == sr)[node].mean()) if node.any() else 1.0
    ms_k = _time_ms(torch, kernel, graph, reps)
    ms_r = _time_ms(torch, lambda *a: plain(*a, **plain_kw), graph,
                    plain_reps) if plain_reps else plain_once_ms
    _line(phase, input=name, shape=list(graph[0].shape),
          cells=int(node.size), nodes=int(node.sum()), cut_kernel=vk,
          cut_plain=vr, side_agreement=agree, kernel_ms=ms_k,
          plain_ms=ms_r, solver_stats=stats, plain_stats=plain_stats,
          device_ms_by_kernel=_device_ms_by_kernel(torch, kernel, graph),
          device=card)
    if not (abs(vk - vr) <= 1e-3 * max(1.0, abs(vr)) and agree >= 0.999):
        raise RuntimeError(f"{kernel.__name__} disagrees with its plain "
                           f"version on {name}: cut {vk} vs {vr}, "
                           f"agreement {agree}")
    return abs(vk - vr), ms_k, ms_r, plain_stats


def _kernel_pair(torch, maxflow, name, graph, reps, card, phase, **extra):
    """Kernel 1 (grid_mincut) and kernel 2 (grid_mincut_tiled) on the same
    tensors: their cut values (float64 recount) within 1e-3 relative,
    their ms, and kernel 1's route ("resident" tiles, or kernel 2's
    "tiled" route where its tiles do not fit); prints one line and
    returns it."""
    host = [t.cpu().numpy() for t in graph]
    out = {}
    for k, fn in (("kernel1", maxflow.grid_mincut),
                  ("kernel2", maxflow.grid_mincut_tiled)):
        side = fn(*graph)
        out[k + "_stats"] = dict(fn.last_stats)
        out["cut_" + k] = maxflow.cut_value(*host, side)
        out[k + "_ms"] = _time_ms(torch, fn, graph, reps)
    out["kernel1_route"] = ("resident" if out["kernel1_stats"]["resident"]
                            else "tiled")
    _line(phase, input=name, shape=list(graph[0].shape),
          cells=int(graph[0].numel()), **out, **extra, device=card)
    v1, v2 = out["cut_kernel1"], out["cut_kernel2"]
    if abs(v1 - v2) > 1e-3 * max(1.0, abs(v1)):
        raise RuntimeError(f"kernels 1 and 2 disagree on {name}: {v1} vs "
                           f"{v2}")
    return out


def _reset_launches(maxflow):
    maxflow.grid_mincut.launches = 0
    maxflow.grid_mincut_tiled.launches = 0


def _launches(maxflow):
    return (maxflow.grid_mincut.launches,
            maxflow.grid_mincut_tiled.launches)


def _ncc_common(a, b):
    """NCC over the pixels both images cover. A full-res render resized
    to the preview's shape covers about 2 preview px more at every
    footprint border (each resolution erodes its masks by 4 of its own
    px), so the whole-image NCC also counts that rim: on 4 views of
    640 px at init_size 320 the whole-image NCC is 0.945 for the port and
    0.944 for the JAX package, inside the common footprint 0.994 and
    0.996 (CPU)."""
    both = (a.max(axis=2) > 0) & (b.max(axis=2) > 0)
    return _ncc(a[both], b[both])


# Largest relative focal error of the slice-3 stitch (Lowe objective) on
# its 12-view loop: at least five times the JAX package's own error on
# the same loop on the CPU, which
# tests/test_torch_cli.py::test_jax_lowe_focals_set_the_slice3_gate
# measures and holds to this gate
SLICE3_FOCAL_GATE = 0.01

# H100 SXM peaks at the full 700 W power limit (NVIDIA's data sheet):
# device memory bytes/s, and float32 operations/s outside the tensor cores
_HBM_BYTES_S = 3.35e12
_F32_OPS_S = 67e12


def _bound(n_bytes, n_ops):
    """(least ms for moving ``n_bytes`` and doing ``n_ops`` float32
    operations on the card, "bytes" or "operations": the larger side)."""
    t_b = n_bytes / _HBM_BYTES_S * 1e3
    t_o = n_ops / _F32_OPS_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def _mincut_bound(node, plain_stats):
    """Bound of one min cut on these inputs: each input (three f32 planes
    and the node mask) read once and the side written once, 14 B per
    cell; the work counted by the plain version's run on the same inputs
    (not by the kernel under test): 36 f32 operations per cell that holds
    excess in a push phase (4 pushes and the relabel), and per BFS (one
    before the first outer round and one after each) 12 per node cell,
    each cell visited once (a relaxation of its 4 edges), whatever
    number of scan passes the plain version's BFS takes."""
    n_bfs = plain_stats["outer"] + 1
    ops = 36 * plain_stats["push_cells"] + 12 * n_bfs * int(node.sum())
    return _bound(14 * node.numel(), ops)


def _ba_bound(mi, mj, n_cams, with_schur):
    """Bound of one assemble_streams call on these camera ids: 37 four-byte
    values read per match and the four outputs written once; per match
    with c distinct ids in [0, N), c^2 6x6 blocks of U at 4 operations
    per entry (two rows, multiply and add) and c 6-segments of eA at 4;
    with the Schur terms as much again for YW and yeb, and W and Z at
    10 operations per segment entry."""
    ii = (mi >= 0) & (mi < n_cams)
    jj = (mj >= 0) & (mj < n_cams)
    c = (ii.long() + jj.long() - (ii & jj & (mi == mj)).long()).double()
    per = c * c * 144 + c * 24
    if with_schur:
        per = 2 * per + c * 60
    sN = 6 * n_cams
    n_bytes = mi.numel() * 37 * 4 + (2 * sN * sN + 2 * sN) * 4
    return _bound(n_bytes, float(per.sum()))


def _random_streams(torch, M, N, seed):
    """Random streams of assemble_streams, made as tests/test_ba_kernel.py
    makes them (seed 0, N=8, M=1024 are its own)."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)
    ai, aj = f32(M, 2, 6), f32(M, 2, 6)
    bp, r2 = f32(M, 2, 2), f32(M, 2)
    l00 = rng.uniform(0.5, 1, (M,)).astype(np.float32)
    l10 = f32(M)
    l11 = rng.uniform(0.5, 1, (M,)).astype(np.float32)
    g0, g1 = f32(M), f32(M)
    mi = rng.integers(0, N - 1, M).astype(np.int32)
    mj = (mi + 1).astype(np.int32)
    return [torch.from_numpy(a).cuda()
            for a in (ai, aj, bp, r2, l00, l10, l11, g0, g1, mi, mj)]


def _jacobi(torch, outs, diag_of):
    """``outs`` (matrices and vectors of the camera system) in the Jacobi
    scaling of ba._solve_preconditioned: D^-1/2 M D^-1/2 and D^-1/2 v,
    D = |diag(diag_of)| clamped at 1e-12. A row of rotation entries no
    longer hides an error in a focal or principal-point row."""
    d = torch.sqrt(torch.clamp(torch.diagonal(diag_of).abs(), min=1e-12))
    return [o / d[:, None] / d[None, :] if o.dim() == 2 else o / d
            for o in outs]


def _max_err(got, want):
    """{name: (max |got - want|, max |want|)}."""
    return {k: (float((g - w).abs().max()), float(w.abs().max()))
            for k, g, w in zip(("U", "eA", "YW", "yeb"), got, want)}


def _kernel3_pair(torch, ba_kernel, name, streams, n_cams, with_schur,
                  card, **extra):
    """assemble_streams and its plain version on the same streams. Checks
    every output within 1e-3 * max|plain| + 1e-4 (the TPU kernel's test
    bound; the sums run in another order), both as computed and in the
    Jacobi scaling of the plain U's diagonal (so that the small focal and
    principal-point entries are held to the same share of their own
    scale as the rotation entries); prints one line; returns (kernel
    outputs, largest |kernel - plain|, kernel ms, plain ms, (bound ms,
    bound side), launches of the checking call)."""
    before = ba_kernel.assemble_streams.launches
    got = ba_kernel.assemble_streams(*streams, n_cams, with_schur=with_schur)
    launches = ba_kernel.assemble_streams.launches - before
    want = ba_kernel.assemble_streams_ref(*streams, n_cams,
                                          with_schur=with_schur)
    torch.cuda.synchronize()
    raw = _max_err(got, want)
    scaled = _max_err(_jacobi(torch, got, want[0]),
                      _jacobi(torch, want, want[0]))
    errs = {k: v[0] for k, v in raw.items()}
    scales = {k: v[1] for k, v in raw.items()}
    call = lambda *a: ba_kernel.assemble_streams(*a, n_cams,
                                                 with_schur=with_schur)
    ms_k = _time_ms(torch, call, streams)
    ms_r = _time_ms(torch, lambda *a: ba_kernel.assemble_streams_ref(
        *a, n_cams, with_schur=with_schur), streams)
    bound = _ba_bound(streams[9], streams[10], n_cams, with_schur)
    _line("kernel3", input=name, n_cams=n_cams, matches=streams[0].shape[0],
          with_schur=with_schur, max_abs_err=errs, plain_max_abs=scales,
          jacobi_max_abs_err={k: v[0] for k, v in scaled.items()},
          jacobi_plain_max_abs={k: v[1] for k, v in scaled.items()},
          kernel_ms=ms_k, plain_ms=ms_r,
          device_ms=_device_ms(torch, call, streams,
                               ("partial_kernel", "reduce_kernel")),
          bound_ms=bound[0], bound_by=bound[1], device=card, **extra)
    bad = [(k, form) for form, e in (("raw", raw), ("jacobi", scaled))
           for k, (err, scale) in e.items() if not err <= 1e-3 * scale + 1e-4]
    if bad or launches != 1:
        raise RuntimeError(f"assemble_streams disagrees with its plain "
                           f"version on {name} ({bad}) or launched "
                           f"{launches} times")
    return got, max(errs.values()), ms_k, ms_r, bound, launches


def _device_ms(torch, fn, args, names, reps=5):
    """Device time (ms) per call of ``fn`` spent in the CUDA kernels whose
    names contain one of ``names``, from torch.profiler over ``reps``
    calls; None when the profiler records no device time. A call's CUDA
    events also count the host's launch work while the card waits."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn(*args)
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        if any(n in e.key for n in names):
            us += getattr(e, "device_time_total",
                          getattr(e, "cuda_time_total", 0.0))
    return us / reps / 1e3 if us > 0 else None


def _device_ms_by_kernel(torch, fn, args, reps=2):
    """Device ms per call of ``fn`` by CUDA kernel name, from
    torch.profiler over ``reps`` calls; {} when the profiler records no
    device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn(*args)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            out[e.key[:96]] = us / reps / 1e3
    return out


@contextlib.contextmanager
def _count_lm(ba):
    """Count the incremental bundle adjustment's LM runs, their trials
    (accepted and rejected) and accepted steps while the block runs."""
    counts = {"lm_runs": 0, "lm_trials": 0, "lm_accepted": 0}
    lm_run_impl = ba.lm_run_impl

    def counted(*a, **kw):
        out = lm_run_impl(*a, **kw)
        counts["lm_runs"] += 1
        counts["lm_trials"] += int(out.n_iter)
        counts["lm_accepted"] += int(out.n_accepted)
        return out
    ba.lm_run_impl = counted
    try:
        yield counts
    finally:
        ba.lm_run_impl = lm_run_impl


def _cli_run(torch, cli, timer, maxflow, ba_kernel, argv):
    """One CLI command on the card with fresh stage timers, peak memory
    and launch counts of all three kernels; its output is captured.
    Raises unless it returns 0. Returns its wall, the stage walls of its
    --timing report (when asked for) and of the timer, peak memory, and
    the min-cut and assemble_streams launches."""
    timer.durations.clear()
    timer.counts.clear()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(maxflow)
    ba_kernel.assemble_streams.launches = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli.main({argv}) returned {rc}:\n"
                           + out.getvalue())
    report = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^(\w+): ([0-9.]+)s x\d+$", out.getvalue(), re.M)}
    return {"wall_s": wall, "timing_report_s": report,
            "stages_s": dict(timer.durations),
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "mincut_launches": list(_launches(maxflow)),
            "assemble_streams_launches": ba_kernel.assemble_streams.launches}


def _slice3_ba_problem(torch, comp, adjres, res, n_pad=16):
    """The BA problem of the slice-3 stitch: stitch.build_ba_data of its
    component and adjacency (every match, capacity a multiple of 512, the
    component's own camera ids), ``n_pad`` camera slots with the stitched
    cameras of the checkpoint ``res`` active and the rest inactive, b at
    the train keypoints. Returns (cams, data, cam_active, active_m)."""
    from simplepanorama_tpu_torch import ba, stitch
    from simplepanorama_tpu_torch.geometry.rotation import rotvec_from_matrix
    if list(comp.nodes) != list(res.nodes):
        raise RuntimeError(f"component {comp.nodes} vs checkpoint "
                           f"{res.nodes}")
    data, _ = stitch.build_ba_data(comp, adjres, device="cuda")
    n = len(res.nodes)
    K = np.asarray(res.K, np.float64)
    half = np.array([[w // 2, h // 2] for h, w in res.sizes], np.float64)
    focal, ppal, rv = np.ones(n_pad), np.zeros((n_pad, 2)), \
        np.zeros((n_pad, 3))
    focal[:n] = K[:, 0, 0]
    ppal[:n] = K[:, :2, 2] - half
    for i in range(n):
        rv[i] = rotvec_from_matrix(torch.as_tensor(res.rot[i])).numpy()
    T = lambda a: torch.as_tensor(a, dtype=torch.float32, device="cuda")
    cams = ba.CamState(T(focal), T(ppal), T(rv), data.t.clone())
    active = torch.zeros(n_pad, dtype=torch.bool, device="cuda")
    active[:n] = True
    active_m = data.m_valid & active[data.mi] & active[data.mj]
    return cams, data, active, active_m


def _system_from_sums(ba, sums, aug, lam, active, fast):
    """The camera system (S, rhs) of ba._schur_solve_system rebuilt from
    assemble_streams' (U, +J^T r, YW, yeb)."""
    U, eA, YW, yeb = sums
    U_aug = ba._augment(U, lam, aug)
    S, rhs = (U_aug, -eA) if fast else (U_aug - YW, -eA - yeb)
    return ba._mask_inactive(S, rhs, active)


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs a CUDA GPU")
    import cv2
    from simplepanorama_tpu_torch import Config, Panorama, cli
    from simplepanorama_tpu_torch import ba, stitch as tstitch
    from simplepanorama_tpu_torch.fixtures import (cut_grid, fkh360_views,
                                                   maze_grid)
    from simplepanorama_tpu_torch.ops import ba_kernel, maxflow
    from simplepanorama_tpu_torch.utils.checkpoint import load_stitch_state
    from simplepanorama_tpu_torch.pipeline import full_precision
    from simplepanorama_tpu_torch.utils.timing import global_timer

    full_precision()
    smi = _nvidia_smi()
    print(smi, flush=True)
    card = torch.cuda.get_device_name(0)
    _line("env", nvidia_smi=smi, torch=torch.__version__,
          cuda=torch.version.cuda, nvcc=_nvcc_version(), device=card)

    # the three sources compiled at once, one nvcc each
    from concurrent.futures import ThreadPoolExecutor
    sources = {k: "simplepanorama_tpu_torch/csrc/" + maxflow._KERNELS[k][1]
               for k in ("grid_mincut", "grid_mincut_tiled")}
    sources["assemble_streams"] = \
        "simplepanorama_tpu_torch/csrc/ba_assemble.cu"
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as ex:
        futs = {k: ex.submit(maxflow.build, k, True)
                for k in ("grid_mincut", "grid_mincut_tiled")}
        futs["assemble_streams"] = ex.submit(ba_kernel.build, True)
        build_s = {k: f.result() for k, f in futs.items()}
    _line("build", sources=sources, nvcc_seconds=build_s,
          wall_seconds=time.perf_counter() - t0)
    for k, sec in build_s.items():
        if sec <= 0.0:
            raise RuntimeError(f"{k} was not built from source in this run")

    with tempfile.TemporaryDirectory() as tmp:
        grid = [torch.from_numpy(a).cuda()
                for a in cut_grid(48, 160, 7, (10, 20, 40, 70))]

        # ---- kernel 1 vs its plain version ----
        errs1 = []
        for name, graph in (("grid48x160", grid),
                            ("seam700", [t.contiguous() for t in
                                         _seam_graph(torch, tmp, 700)])):
            err, ms_k, ms_r, stats = _solve_pair(
                torch, maxflow, name, graph, maxflow.grid_mincut,
                maxflow.grid_mincut_ref, 5, 5, card, "kernel")
            errs1.append(err)
        # the seam graph's times and bound are reported
        timing1 = (ms_k, ms_r, _mincut_bound(graph[3], stats))
        # kernel 2 on the seam700 block, where kernel 1 keeps its tiles
        # resident: two different solvers on one input
        pair = _kernel_pair(torch, maxflow, "seam700", graph, 3, card,
                            "kernel")
        if pair["kernel1_route"] != "resident":
            raise RuntimeError("kernel 1 did not keep the seam700 block "
                               "resident")

        # ---- kernel 2 vs its plain version; kernel 1 beside it ----
        errs2 = []
        seam = [t.contiguous() for t in _seam_graph(torch, tmp, 1400)]
        if seam[0].numel() <= maxflow.WHOLE_GRID_MAX_CELLS:
            raise RuntimeError(f"slice-2 seam block {tuple(seam[0].shape)} "
                               "is not over 1.2M cells")
        # the plain version at the seam block is timed on its one
        # checking run (its CUDA-event time), not on repeats
        for name, graph, tile_rows, plain_reps in (
                ("grid48x160", grid, 16, 5), ("seam1400", seam, 512, 0)):
            err, ms_k, ms_r, stats = _solve_pair(
                torch, maxflow, name, graph, maxflow.grid_mincut_tiled,
                maxflow.grid_mincut_tiled_ref, 3, plain_reps, card,
                "kernel2", tile_rows=tile_rows)
            errs2.append(err)
        timing2 = (ms_k, ms_r, _mincut_bound(graph[3], stats))
        # kernel 1 at seam1400 takes kernel 2's tiled route (its tiles do
        # not fit), so this line is the crossover, not a second solver
        _kernel_pair(torch, maxflow, "seam1400", seam, 3, card, "kernel2")

        # ---- the crossover of kernels 1 and 2 between the two seam
        # blocks, and the cost of one BFS level ----
        for px in (850, 900, 950, 1000):
            _kernel_pair(torch, maxflow, f"seam{px}",
                         [t.contiguous() for t in
                          _seam_graph(torch, tmp, px)], 3, card,
                         "crossover", view_px=px)
        maze = [torch.from_numpy(a).cuda() for a in maze_grid(128, 128, 0)]
        for name in ("grid_mincut", "grid_mincut_tiled"):
            def bfs(*a):
                return maxflow.dist_to_sink(*a, kernel=name)
            d = bfs(*maze)
            ms = _time_ms(torch, bfs, maze)
            levels = int(d[d < 1e18].max())
            _line("crossover", input="maze128x128", bfs_of=name, bfs_ms=ms,
                  max_distance=levels, us_per_level=ms * 1e3 / levels,
                  device=card)

        # ---- kernel 3 vs its plain version on random streams: the
        # synthetic streams of tests/test_ba_kernel.py, and N=40 cameras
        # with 20,480 matches ----
        errs3 = []
        for name, M, N in (("random_n8_m1024", 1024, 8),
                           ("random_n40_m20480", 20480, 40)):
            streams = _random_streams(torch, M, N, 0)
            for schur in (True, False):
                errs3.append(_kernel3_pair(torch, ba_kernel, name, streams,
                                           N, schur, card)[1])

        timer = global_timer()
        os.environ["SPT_SYNC_STAGES"] = "1"

        # ---- slice 1: 12 views, 360 degrees, graph-cut seams ----
        paths, yaws, f_true = fkh360_views(
            12, 700, out_dir=os.path.join(tmp, "loop"))
        timer.durations.clear()
        timer.counts.clear()
        _reset_launches(maxflow)
        t0 = time.perf_counter()
        with _count_lm(ba) as lm1:
            pano = Panorama(paths, device="cuda").stitch(Config(cut=True))
        preview = pano.get_preview()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches1 = _launches(maxflow)
        focals = pano.result.K[:, 0, 0]
        cov = _coverage(preview)
        _line("slice", connected=list(pano.connected),
              launches={"grid_mincut": launches1[0],
                        "grid_mincut_tiled": launches1[1]},
              focal_true=f_true, focals=[float(x) for x in focals],
              blocks=list(pano.stitch_params.state.masks.shape),
              preview_shape=list(preview.shape), coverage=cov, wall_s=wall,
              stages_s=dict(timer.durations), **lm1, device=card)
        if tuple(pano.connected) != (12, 12):
            raise RuntimeError(f"slice connected {pano.connected}")
        if launches1[0] < 11:
            raise RuntimeError(f"only {launches1[0]} kernel-1 launches")
        if np.max(np.abs(focals / f_true - 1.0)) > 0.02:
            raise RuntimeError(f"focals {focals} vs true {f_true}")
        if not np.isfinite(preview).all() or cov <= 0.9:
            raise RuntimeError(f"preview coverage {cov}")
        del pano, preview

        # ---- slice 2: 12 views of 2800 px at init_size 1400, gain,
        # graph-cut seams, preview and full-res panorama ----
        paths, yaws, f_full = fkh360_views(
            12, 2800, out_dir=os.path.join(tmp, "loop2800"))
        f_true = f_full * 1400 / 2800
        timer.durations.clear()
        timer.counts.clear()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches(maxflow)
        t0 = time.perf_counter()
        pano = Panorama(paths, device="cuda").stitch(
            Config(cut=True, init_size=1400, gain_compensation=True))
        preview = pano.get_preview()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches2 = _launches(maxflow)
        t0 = time.perf_counter()
        full = pano.get_panorama()
        torch.cuda.synchronize()
        full_wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        focals = pano.result.K[:, 0, 0]
        gains = np.asarray(pano.stitch_params.gains)
        blocks = list(pano.stitch_params.state.masks.shape)
        cov = _coverage(preview)
        small = cv2.resize(full, (preview.shape[1], preview.shape[0]),
                           interpolation=cv2.INTER_AREA)
        ncc_whole, shift_full = _ncc_aligned(preview, small)
        ncc_full = _ncc_common(preview, small)
        _line("slice2", connected=list(pano.connected),
              launches={"grid_mincut": launches2[0],
                        "grid_mincut_tiled": launches2[1]},
              focal_true=f_true, focals=[float(x) for x in focals],
              gains=[float(g) for g in gains], blocks=blocks,
              block_cells=blocks[1] * blocks[2],
              preview_shape=list(preview.shape), coverage=cov,
              full_shape=list(full.shape), full_vs_preview_ncc=ncc_full,
              full_vs_preview_ncc_whole=ncc_whole,
              full_vs_preview_shift=list(shift_full), wall_s=wall,
              full_wall_s=full_wall, stages_s=dict(timer.durations),
              max_memory_allocated=peak,
              solver_stats=maxflow.grid_mincut_tiled.last_stats,
              device=card)
        if tuple(pano.connected) != (12, 12):
            raise RuntimeError(f"slice2 connected {pano.connected}")
        if np.max(np.abs(focals / f_true - 1.0)) > 0.02:
            raise RuntimeError(f"slice2 focals {focals} vs true {f_true}")
        if blocks[1] * blocks[2] <= maxflow.WHOLE_GRID_MAX_CELLS:
            raise RuntimeError(f"slice2 blocks {blocks} not over 1.2M cells")
        if launches2[1] < 11 or launches2[0] != 0:
            raise RuntimeError(f"slice2 launches {launches2}: wanted >= 11 "
                               "of kernel 2 and none of kernel 1")
        if not (np.all(np.isfinite(gains)) and np.all(gains > 0)):
            raise RuntimeError(f"slice2 gains {gains}")
        if not np.isfinite(preview).all() or cov <= 0.9:
            raise RuntimeError(f"slice2 preview coverage {cov}")
        if (abs(full.shape[0] - 2 * preview.shape[0]) > 8
                or abs(full.shape[1] - 2 * preview.shape[1]) > 8):
            raise RuntimeError(f"full-res {full.shape} is not about 2x the "
                               f"preview {preview.shape}")
        if ncc_full < 0.95:
            raise RuntimeError(f"full-res vs preview NCC {ncc_full}")
        del pano, preview, full, small

        # ---- slice 3: the CLI on 12 views of 1400 px, Lowe objective,
        # default compositing (distance-transform seams, MULTI_BLEND),
        # checkpoint, then the full-res render resumed from it; each
        # command cold (its first run) and warm ----
        views3 = os.path.join(tmp, "loop1400")
        paths, yaws, f_full = fkh360_views(12, 1400, out_dir=views3)
        f_true = f_full * 700 / 1400
        state = os.path.join(tmp, "slice3.npz")
        prev_p = os.path.join(tmp, "slice3_preview.jpg")
        full_p = os.path.join(tmp, "slice3_full.jpg")
        seen = {}
        bundle_adjust = tstitch.bundle_adjust_stitching

        def recording(comp, adjres, *a, **kw):   # the run's BA problem
            seen.update(comp=comp, adjres=adjres)
            return bundle_adjust(comp, adjres, *a, **kw)
        runs = {}
        tstitch.bundle_adjust_stitching = recording
        try:
            for run in ("cold", "warm"):
                with _count_lm(ba) as lm3:
                    runs["stitch_" + run] = _cli_run(
                        torch, cli, timer, maxflow, ba_kernel, [
                            views3, "--fast", "--timing", "--save-state",
                            state, "-o", prev_p])
                runs["stitch_" + run].update(lm3)
                runs["full_" + run] = _cli_run(
                    torch, cli, timer, maxflow, ba_kernel, [
                        "--from-state", state, "--full-res", "-o", full_p])
        finally:
            tstitch.bundle_adjust_stitching = bundle_adjust
        res3, saved_paths = load_stitch_state(state, with_paths=True)
        connected3 = (len(res3.nodes), len(saved_paths))
        focals = np.asarray(res3.K)[:, 0, 0]
        preview = cv2.imread(prev_p)
        full = cv2.imread(full_p)
        cov = _coverage(preview)
        small = cv2.resize(full, (preview.shape[1], preview.shape[0]),
                           interpolation=cv2.INTER_AREA)
        ncc_full = _ncc_common(preview, small)
        focal_gate = SLICE3_FOCAL_GATE
        _line("slice3", connected=list(connected3), focal_true=f_true,
              focals=[float(x) for x in focals], focal_gate=focal_gate,
              preview_shape=list(preview.shape), coverage=cov,
              full_shape=list(full.shape), full_vs_preview_ncc=ncc_full,
              runs=runs, device=card)
        if connected3 != (12, 12):
            raise RuntimeError(f"slice3 connected {connected3}")
        if np.max(np.abs(focals / f_true - 1.0)) > focal_gate:
            raise RuntimeError(f"slice3 focals {focals} vs true {f_true}")
        if cov <= 0.9:
            raise RuntimeError(f"slice3 preview coverage {cov}")
        if (abs(full.shape[0] - 2 * preview.shape[0]) > 8
                or abs(full.shape[1] - 2 * preview.shape[1]) > 8):
            raise RuntimeError(f"slice3 full-res {full.shape} is not about "
                               f"2x the preview {preview.shape}")
        if ncc_full < 0.95:
            raise RuntimeError(f"slice3 full-res vs preview NCC {ncc_full}")
        if any(r["mincut_launches"] != [0, 0] for r in runs.values()):
            raise RuntimeError("slice3 (cut=False) launched a min-cut")
        launches3_path = sum(r["assemble_streams_launches"]
                             for r in runs.values())
        os.environ.pop("SPT_SYNC_STAGES")

        # ---- kernel 3 on slice 3's own BA problem: the Lowe system and
        # the relaxed one (b = t), against the plain version and the
        # port's own assembly ----
        cams, data, active, active_m = _slice3_ba_problem(
            torch, seen["comp"], seen["adjres"], res3)
        lam = float(Config().lambda_)
        n_pad = cams.focal.shape[0]
        probe3 = 0
        for fast in (True, False):
            name = "slice3_ba_" + ("lowe" if fast else "relaxed")

            def assembly():      # the port's dense einsum assembly
                cache = ba._assemble_cache(cams, data, active_m, active,
                                           n_pad, fast=fast)
                return cache, ba._schur_solve_system(cache, active_m, lam,
                                                     active, fast)
            streams = ba_kernel.streams_from_problem(
                cams, data, active_m, lam, active, n_pad, fast)
            ms_streams = _time_ms(torch, ba_kernel.streams_from_problem, (
                cams, data, active_m, lam, active, n_pad, fast))
            cache, (S_ref, rhs_ref, _) = assembly()
            ms_dense = _time_ms(torch, assembly, ())
            sums, err, ms_k, ms_r, bound, n = _kernel3_pair(
                torch, ba_kernel, name, streams, n_pad, not fast, card,
                streams_ms=ms_streams, ba_assembly_ms=ms_dense,
                active_matches=int(active_m.sum()))
            probe3 += n
            errs3.append(err)
            S, rhs = _system_from_sums(ba, sums, cache.aug, lam, active,
                                       fast)
            rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
            dS, drhs = rel(S, S_ref), rel(rhs, rhs_ref)
            # and in the Jacobi scaling that _solve_preconditioned gives
            # the system before it solves
            (jS, jrhs), (jS_ref, jrhs_ref) = (
                _jacobi(torch, pair, S_ref) for pair in ((S, rhs),
                                                         (S_ref, rhs_ref)))
            jdS, jdrhs = rel(jS, jS_ref), rel(jrhs, jrhs_ref)
            _line("kernel3", input=name, vs="ba._assemble_cache + "
                  "_schur_solve_system", S_rel_err=dS, rhs_rel_err=drhs,
                  jacobi_S_rel_err=jdS, jacobi_rhs_rel_err=jdrhs,
                  device=card)
            if not max(dS, drhs, jdS, jdrhs) <= 1e-3:
                raise RuntimeError(f"kernel 3 vs the port's BA assembly on "
                                   f"{name}: S {dS} / {jdS}, rhs {drhs} / "
                                   f"{jdrhs} (as computed / Jacobi-scaled)")
        timing3 = (ms_k, ms_r, bound)     # the relaxed system's
        if probe3 != 2:
            raise RuntimeError(f"kernel 3 launched {probe3} times checking "
                               "slice 3's BA problem, wanted 2")
        del preview, full, small, cams, data, streams, sums

        # ---- the same 4 views through the port on the CPU and the card ----
        paths4, _, _ = fkh360_views(4, 640, yaw_step_deg=20.0, hfov_deg=45.0,
                                    roll_deg=3.0,
                                    out_dir=os.path.join(tmp, "four"))
        for cfg_name, cfg in (
                ("cut", Config(cut=True, init_size=320,
                               RANSAC_iterations=300)),
                ("lowe", Config(fast=True, init_size=320,
                                RANSAC_iterations=300))):
            out = {}
            for dev in ("cpu", "cuda"):
                p = Panorama(paths4, device=dev).stitch(cfg)
                out[dev] = (tuple(p.connected), p.get_preview(),
                            p.result.K[:, 0, 0], p.get_panorama())
            ncc, shift = _ncc_aligned(out["cpu"][1], out["cuda"][1])
            ncc_f, shift_f = _ncc_aligned(out["cpu"][3], out["cuda"][3])
            _line("cpu_vs_card", config=cfg_name,
                  connected_cpu=list(out["cpu"][0]),
                  connected_cuda=list(out["cuda"][0]),
                  shapes=[list(out["cpu"][1].shape),
                          list(out["cuda"][1].shape)],
                  full_shapes=[list(out["cpu"][3].shape),
                               list(out["cuda"][3].shape)],
                  focal_rel_diff=float(np.max(np.abs(
                      out["cuda"][2] / out["cpu"][2] - 1.0))),
                  ncc=ncc, shift=list(shift), full_ncc=ncc_f,
                  full_shift=list(shift_f), device=card)
            if (out["cpu"][0] != out["cuda"][0] or ncc < 0.98
                    or ncc_f < 0.98):
                raise RuntimeError(f"CPU and card panoramas disagree "
                                   f"({cfg_name})")

    # no single PyTorch call computes a min cut or the block-sparse
    # normal-equation sums, so library_ms is null for all three
    print(json.dumps({"kernels": [
        {"name": "grid_mincut",
         "route": "cuda",
         "source": sources["grid_mincut"],
         "replaces": "simplepanorama_tpu/ops/maxflow.py:366",
         "launches": launches1[0],
         # largest |cut value (kernel) - cut value (plain)| over its inputs
         "max_abs_err": max(errs1),
         "ms": timing1[0],
         "plain_ms": timing1[1],
         "bound_ms": timing1[2][0],
         "bound_by": timing1[2][1],
         "library_ms": None},
        {"name": "grid_mincut_tiled",
         "route": "cuda",
         "source": sources["grid_mincut_tiled"],
         "replaces": "simplepanorama_tpu/ops/maxflow.py:666",
         "launches": launches2[1],
         "max_abs_err": max(errs2),
         "ms": timing2[0],
         "plain_ms": timing2[1],
         "bound_ms": timing2[2][0],
         "bound_by": timing2[2][1],
         "library_ms": None},
        {"name": "assemble_streams",
         "route": "cuda",
         "source": sources["assemble_streams"],
         "replaces": "simplepanorama_tpu/ops/ba_kernel.py:140",
         # its launches in slice 3's four commands: 0, as it is wired into
         # no path, like the TPU kernel in the JAX package
         "launches": launches3_path,
         # its checking calls on slice 3's own BA problem, kernel3 phase
         "probe_launches": probe3,
         # largest |kernel - plain| over every output of every input
         "max_abs_err": max(errs3),
         "ms": timing3[0],
         "plain_ms": timing3[1],
         "bound_ms": timing3[2][0],
         "bound_by": timing3[2][1],
         "library_ms": None}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
