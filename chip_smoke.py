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
  slice5  the little planet: the slice-3 loop through
          Panorama(paths, device="cuda").stitch(Config(proj=
          STEREOGRAPHIC)) (fix_center on, as by default), get_preview()
          and get_panorama(); a PanoramaViewer on it (zoom, crop, undo,
          redo, save of the full-res crop); the same result without the
          fix (the centre must stay dark), then re-composited with
          cut=True, no second BA, with the min-cut launches counted,
          and kernel 1 against grid_mincut_ref on the first seam graph
          of that re-composite (the sten-fixed blocks, over kernel 1's
          residency limit: its tiled route);
  stream  load + keypoints of the loops of slices 1, 2 and 3 through
          the list path (every image decoded, then SIFT) and through the
          streaming decode, in turns, with SIFT's peak device memory;
  cpu_vs_card  4 views of 640 px (preview 320 px) through the port on
          "cpu" and "cuda", with graph-cut seams and with the Lowe
          objective: previews and full-res panoramas; and the little
          planet of a 12-view 300-px loop with its true geometry
          (set_config + render_preview, no BA).

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
    from simplepanorama_tpu_torch.render import compose
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
    return _first_cut_graph(torch, st, (0, 1))


def _first_cut_graph(torch, st, seq):
    """The seam graph of the first cut that render/graphcut.graph_cut_state
    makes on the ComposeState ``st`` in the order ``seq``: block seq[1]
    against block seq[0] pasted on the canvas, as contiguous tensors."""
    from simplepanorama_tpu_torch.render import graphcut
    gray = graphcut._gray_batch(st.imgs)
    N, Hb, Wb = st.masks.shape
    H, W = st.canvas_hw
    dev = st.imgs.device
    canvas = torch.zeros((H + Hb, W + Wb), device=dev)
    scene = torch.zeros((H + Hb, W + Wb), dtype=torch.bool, device=dev)
    offs = st.offs.tolist()
    a, b = seq[0], seq[1]
    graphcut._paste_first(canvas, scene, gray[a], st.masks[a], offs[a])
    y, x = offs[b]
    return [t.contiguous() for t in graphcut._build_cut_graph(
        canvas[y:y + Hb, x:x + Wb], gray[b],
        scene[y:y + Hb, x:x + Wb].float() * 255.0,
        st.masks[b].float() * 255.0)]


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


def _center_dark(img, frac=6):
    """Share of near-black pixels in the central third of a panorama
    (tests/test_e2e_golden.py's measure of the little planet's hole)."""
    h, w = img.shape[:2]
    c = img[h // 2 - h // frac:h // 2 + h // frac,
            w // 2 - w // frac:w // 2 + w // frac]
    return float((c.sum(-1) <= 3).mean())


def _loop_result(yaws, f, size):
    """The true geometry of a pure-yaw loop of ``size``-px views as the BA
    would hand it over: R = rot_y(yaw), K with focal ``f``."""
    from simplepanorama_tpu_torch.stitch import StitchResult
    n = len(yaws)
    Rs = [np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                    [-np.sin(a), 0, np.cos(a)]]) for a in np.radians(yaws)]
    K = np.array([[f, 0, size // 2], [0, f, size // 2], [0, 0, 1.0]])
    adj = np.zeros((n, n))
    for i in range(n):
        adj[min(i, (i + 1) % n), max(i, (i + 1) % n)] = 0.5
    return StitchResult(
        rot=np.stack(Rs), K=np.stack([K] * n), adj=adj,
        connectivity=np.ones(n), order=[(0, -1)] + [(i, i - 1)
                                                    for i in range(1, n)],
        nodes=list(range(n)), center=0, sizes=[(size, size)] * n)


def _load_and_keypoints(torch, paths, cfg, stream):
    """The load and keypoints stages of run_pipeline on the card: every
    image decoded before SIFT (``stream`` False, the list path) or the
    streaming decode. Returns (wall s, SIFT's peak device memory,
    keypoints found)."""
    from simplepanorama_tpu_torch.features import extract_features
    from simplepanorama_tpu_torch.io import ImageSet
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    images = ImageSet(paths)
    if stream:
        feats = extract_features(
            images.load_resized_stream(cfg.init_size, cfg.threads), cfg,
            device="cuda")
    else:
        images.load_resized(cfg.init_size, cfg.threads)
        feats = extract_features(images.img_data, cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (wall, torch.cuda.max_memory_allocated() - base,
            sum(f.count for f in feats))


# Largest relative focal error of the slice-3 stitch (Lowe objective) on
# its 12-view loop: at least five times the JAX package's own error on
# the same loop on the CPU, which
# tests/test_torch_cli.py::test_jax_lowe_focals_set_the_slice3_gate
# measures and holds to this gate
SLICE3_FOCAL_GATE = 0.01

# Least NCC of slice 5's fixed little planet, full-res against preview
# (common footprint). The full-res render estimates the circle again on
# the full-res masks, as the reference's return_full does; their 4-px
# erosion is half as wide in preview pixels, so the hole, and with it the
# radial stretch, comes out slightly different, and the two planets are
# not one picture at two sizes (without the fix they are: NCC >= 0.95).
# The JAX package's own value on the same loop with its true geometry,
# which tests/test_torch_sten.py::test_jax_little_planet_sets_the_slice5_gate
# measures on the CPU, stays at least 0.02 above this gate.
SLICE5_FIXED_NCC_GATE = 0.90

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


def _slice5(torch, paths, f_true, tmp, card):
    """Slice 5 on the card: the little planet of ``paths`` (the slice-3
    loop; full-res twice the 700-px preview), the viewer on it, the same
    result without the fix and re-composited with graph-cut seams (no
    second BA). Prints the slice5 line, checks its gates, and returns
    the min-cut launches (kernel 1, kernel 2) of the re-composite and
    kernel 1's |cut difference| from its plain version on the
    re-composite's first seam graph."""
    import cv2
    from simplepanorama_tpu_torch import (Config, Panorama, PanoramaViewer,
                                          Projection, ba)
    from simplepanorama_tpu_torch.ops import maxflow
    from simplepanorama_tpu_torch.utils.timing import global_timer
    timer = global_timer()
    os.environ["SPT_SYNC_STAGES"] = "1"
    sten = Config(proj=Projection.STEREOGRAPHIC)
    timer.durations.clear()
    timer.counts.clear()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(maxflow)
    t0 = time.perf_counter()
    with _count_lm(ba) as lm5:
        pano = Panorama(paths, device="cuda").stitch(sten)
    preview = pano.get_preview()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches5_stitch = _launches(maxflow)
    stages5 = dict(timer.durations)
    t0 = time.perf_counter()
    full = pano.get_panorama()
    torch.cuda.synchronize()
    full_wall = time.perf_counter() - t0
    peak5 = torch.cuda.max_memory_allocated()
    focals = pano.result.K[:, 0, 0]
    circle = pano.stitch_params.sten_circle
    blocks = list(pano.stitch_params.state.masks.shape)
    small = cv2.resize(full, (preview.shape[1], preview.shape[0]),
                       interpolation=cv2.INTER_AREA)
    ncc_full = _ncc_common(preview, small)
    dark = (_center_dark(preview), _center_dark(full))

    viewer = PanoramaViewer(pano)
    zoomed = viewer.zoom_in()
    dh, dw = viewer.display().shape[:2]
    cropped = viewer.crop((dw // 4, dh // 4, dw // 2, dh // 2))
    crop_rect = viewer.crop_preview
    undone, redone = viewer.undo_crop(), viewer.redo_crop()
    saved_p = os.path.join(tmp, "slice5_crop.png")
    t0 = time.perf_counter()
    saved_ok = viewer.save(saved_p, full_res=True)
    save_wall = time.perf_counter() - t0
    saved = cv2.imread(saved_p)
    want_shape = pano.get_panorama(viewer.crop_preview).shape

    pano.set_config(Config(proj=Projection.STEREOGRAPHIC,
                           fix_center=False))
    preview_nofix = pano.get_preview()
    dark_nofix = _center_dark(preview_nofix)
    circle_nofix = pano.stitch_params.sten_circle
    full_nofix = cv2.resize(pano.get_panorama(), (preview_nofix.shape[1],
                                                   preview_nofix.shape[0]),
                            interpolation=cv2.INTER_AREA)
    ncc_nofix = _ncc_common(preview_nofix, full_nofix)
    del preview_nofix, full_nofix
    timer.durations.clear()
    timer.counts.clear()
    _reset_launches(maxflow)
    t0 = time.perf_counter()
    pano.set_config(Config(proj=Projection.STEREOGRAPHIC, cut=True))
    cut_preview = pano.get_preview()
    torch.cuda.synchronize()
    cut_wall = time.perf_counter() - t0
    launches5 = _launches(maxflow)
    cut_blocks = list(pano.stitch_params.state.masks.shape)
    route = ("kernel 2 (grid_mincut_tiled)" if launches5[1] else
             "kernel 1 (grid_mincut), resident" if
             maxflow.grid_mincut.last_stats["resident"] else
             "kernel 1 (grid_mincut), tiled route")
    # kernel 1 against its plain version on the first cut of this
    # re-composite, at the sten-fixed block shape the path gave it
    graph = _first_cut_graph(torch, pano.stitch_params.state,
                             [n for n, _ in pano.stitch_params.res.order])
    err5, ms5, plain_ms5, _ = _solve_pair(
        torch, maxflow, f"sten{cut_blocks[1]}x{cut_blocks[2]}", graph,
        maxflow.grid_mincut, maxflow.grid_mincut_ref, 3, 0, card, "kernel")
    resident5 = maxflow.grid_mincut.last_stats["resident"]
    del graph
    _line("slice5", connected=list(pano.connected), focal_true=f_true,
          focals=[float(x) for x in focals], sten_circle=circle,
          blocks=blocks, block_cells=blocks[1] * blocks[2],
          preview_shape=list(preview.shape),
          full_shape=list(full.shape), full_vs_preview_ncc=ncc_full,
          center_dark_preview=dark[0], center_dark_full=dark[1],
          center_dark_no_fix=dark_nofix,
          full_vs_preview_ncc_no_fix=ncc_nofix, wall_s=wall,
          full_wall_s=full_wall, stages_s=stages5,
          max_memory_allocated=peak5, **lm5,
          stitch_mincut_launches=list(launches5_stitch),
          viewer={"zoom_in": zoomed, "crop": cropped,
                  "crop_preview": list(crop_rect), "undo": undone,
                  "redo": redone, "saved_shape": list(saved.shape),
                  "get_panorama_roi_shape": list(want_shape),
                  "save_s": save_wall},
          cut={"launches": {"grid_mincut": launches5[0],
                            "grid_mincut_tiled": launches5[1]},
               "blocks": cut_blocks,
               "block_cells": cut_blocks[1] * cut_blocks[2],
               "route": route, "wall_s": cut_wall,
               "first_cut": {"max_abs_err": err5, "kernel_ms": ms5,
                             "plain_ms": plain_ms5,
                             "resident": resident5},
               "stages_s": dict(timer.durations),
               "center_dark_preview": _center_dark(cut_preview)},
          device=card)
    os.environ.pop("SPT_SYNC_STAGES")
    if tuple(pano.connected) != (12, 12):
        raise RuntimeError(f"slice5 connected {pano.connected}")
    if np.max(np.abs(focals / f_true - 1.0)) > 0.02:
        raise RuntimeError(f"slice5 focals {focals} vs true {f_true}")
    if circle is None:
        raise RuntimeError("slice5: the centre fix did not trigger")
    if max(dark) >= 0.10 or dark_nofix <= 0.4:
        raise RuntimeError(f"slice5 centre-dark {dark} with the fix, "
                           f"{dark_nofix} without")
    if circle_nofix is not None:
        raise RuntimeError("slice5: fix_center=False estimated a "
                           "circle")
    if (abs(full.shape[0] - 2 * preview.shape[0]) > 8
            or abs(full.shape[1] - 2 * preview.shape[1]) > 8):
        raise RuntimeError(f"slice5 full-res {full.shape} is not about "
                           f"2x the preview {preview.shape}")
    if ncc_full < SLICE5_FIXED_NCC_GATE or ncc_nofix < 0.95:
        raise RuntimeError(f"slice5 full-res vs preview NCC {ncc_full} "
                           f"with the fix, {ncc_nofix} without")
    if launches5_stitch != (0, 0):
        raise RuntimeError(f"slice5 (cut=False) launched a min-cut "
                           f"{launches5_stitch}")
    if sum(launches5) < 11:
        raise RuntimeError(f"slice5 cut=True re-composite: min-cut "
                           f"launches {launches5}, wanted >= 11")
    if cut_blocks[1] * cut_blocks[2] > maxflow.WHOLE_GRID_MAX_CELLS \
            or resident5 != 0:
        raise RuntimeError(f"slice5 cut=True blocks {cut_blocks}: wanted "
                           f"kernel 1 on its tiled route, resident "
                           f"{resident5}")
    if not (zoomed and cropped and undone and redone and saved_ok
            and tuple(saved.shape) == tuple(want_shape)):
        raise RuntimeError(f"slice5 viewer: zoom {zoomed}, crop "
                           f"{cropped}, undo {undone}, redo {redone}, "
                           f"save {saved_ok}, saved {saved.shape} vs "
                           f"get_panorama(roi) {want_shape}")
    return launches5, err5


def _stream_phase(torch, loops, card):
    """Load + keypoints of each (name, view directory, init_size) in
    ``loops`` with every image decoded first (the list path, as before
    the streaming decode) and through the streaming decode, in turns
    (list, stream, stream, list). Prints one stream line per loop; the
    two paths must find the same keypoints, and the streamed SIFT's peak
    memory on the slice-2 loop must not exceed the list path's."""
    from simplepanorama_tpu_torch import Config
    stream_rows = {}
    for name, loop_paths, init in loops:
        files = sorted(os.path.join(loop_paths, f)
                       for f in os.listdir(loop_paths))
        cfg = Config(init_size=init)
        runs = {"list": [], "stream": []}
        for mode in ("list", "stream", "stream", "list"):
            runs[mode].append(_load_and_keypoints(
                torch, files, cfg, mode == "stream"))
        stream_rows[name] = runs
        _line("stream", loop=name, views=len(files), init_size=init,
              list_s=[r[0] for r in runs["list"]],
              stream_s=[r[0] for r in runs["stream"]],
              list_peak=[r[1] for r in runs["list"]],
              stream_peak=[r[1] for r in runs["stream"]],
              keypoints_list=runs["list"][0][2],
              keypoints_stream=runs["stream"][0][2], device=card)
        if runs["list"][0][2] != runs["stream"][0][2]:
            raise RuntimeError(f"{name}: the stream found other "
                               "keypoints than the list path")
    peak_list = max(r[1] for r in stream_rows["slice2"]["list"])
    peak_stream = max(r[1] for r in stream_rows["slice2"]["stream"])
    if peak_stream > peak_list:
        raise RuntimeError(f"slice2 SIFT peak {peak_stream} B streamed "
                           f"vs {peak_list} B listed")


def _sten_cpu_vs_card(torch, tmp, card):
    """The little planet of a 12-view 300-px loop with its true geometry
    (set_config + render_preview, no BA) on "cpu" and "cuda": the same
    sten_circle, and the previews within NCC 0.98."""
    import cv2
    from simplepanorama_tpu_torch import Config, Projection, stitcher
    from simplepanorama_tpu_torch.fixtures import fkh360_views
    sten = Config(proj=Projection.STEREOGRAPHIC)
    loop300, yaws300, f300 = fkh360_views(
        12, 300, out_dir=os.path.join(tmp, "loop300"))
    imgs300 = [cv2.imread(p) for p in loop300]
    res300 = _loop_result(yaws300, f300, 300)
    out = {}
    for dev in ("cpu", "cuda"):
        params = stitcher.set_config(res300, imgs300, sten, device=dev)
        out[dev] = (params.sten_circle, params.state.min_xy,
                    stitcher.render_preview(params, sten))
    ncc, shift = _ncc_aligned(out["cpu"][2], out["cuda"][2])
    _line("cpu_vs_card", config="sten_known_geometry",
          sten_circle_cpu=out["cpu"][0], sten_circle_cuda=out["cuda"][0],
          min_xy=[list(out["cpu"][1]), list(out["cuda"][1])],
          shapes=[list(out["cpu"][2].shape), list(out["cuda"][2].shape)],
          ncc=ncc, shift=list(shift), device=card)
    if out["cpu"][0] != out["cuda"][0] or out["cpu"][0] is None \
            or ncc < 0.98:
        raise RuntimeError("CPU and card little planets disagree")


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
                            ("seam700", _seam_graph(torch, tmp, 700))):
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
        seam = _seam_graph(torch, tmp, 1400)
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
                         _seam_graph(torch, tmp, px), 3, card, "crossover",
                         view_px=px)
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

        launches5, err5 = _slice5(torch, paths, f_true, tmp, card)
        errs1.append(err5)

        _stream_phase(torch, (("slice", os.path.join(tmp, "loop"), 700),
                              ("slice2", os.path.join(tmp, "loop2800"),
                               1400),
                              ("slice3", views3, 700)), card)

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

        _sten_cpu_vs_card(torch, tmp, card)

    # no single PyTorch call computes a min cut or the block-sparse
    # normal-equation sums, so library_ms is null for all three
    print(json.dumps({"kernels": [
        {"name": "grid_mincut",
         "route": "cuda",
         "source": sources["grid_mincut"],
         "replaces": "simplepanorama_tpu/ops/maxflow.py:366",
         "launches": launches1[0],
         # its launches on each path that runs it (slice 5: the cut=True
         # re-composite of the little planet)
         "launches_by_path": {"slice": launches1[0], "slice2": launches2[0],
                              "slice5": launches5[0]},
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
         "launches_by_path": {"slice": launches1[1], "slice2": launches2[1],
                              "slice5": launches5[1]},
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
