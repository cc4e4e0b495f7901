#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (simplepanorama_tpu_torch).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases, each printing one line per input:
  env     the card (nvidia-smi name and power limit), torch/CUDA/nvcc;
  build   nvcc builds of csrc/mincut.cu, csrc/mincut_tiled.cu,
          csrc/ba_assemble.cu and csrc/ba_trial.cu from the checkout's
          sources, all at once;
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
          then grid_mincut_auto, the seam dispatch, on that graph
          (seam1400_crop: solved on its node box, the overlap band,
          against the uncropped kernel 2, in turns, and against
          grid_mincut_tiled_ref's side of the seam1400 check) and on the
          middle of three such views against both neighbours
          (seam1400_closing: a box over 0.9 of the grid, sent whole to
          kernel 2, against kernel 2's plain version);
  crossover kernels 1 and 2 on seam graphs from two views of 850 to
          1000 px (kernel 1's route, both ms and cut values), and one BFS
          (maxflow.dist_to_sink) of each on a 128x128 serpentine maze:
          ms per unit of sink distance;
  kernel3 assemble_streams (kernel 3) against assemble_streams_ref, with
          and without the Schur terms, on random streams (N=8, M=1024 and
          N=40, M=20,480); the same on slice 3's own BA problem follows
          the slice3 phase, and at every capacity bucket of the BA's
          schedule in the ba phase;
  slice   a 12-view 360-degree loop of 700-px views through
          Panorama(paths, device="cuda").stitch(Config(cut=True))
          .get_preview(), with the min-cut launches counted, and kernel
          3's (one per LM trial executed, as on every stitch below);
  slice2  a 12-view loop of 2800-px views through
          Panorama(paths, device="cuda").stitch(Config(cut=True,
          init_size=1400, gain_compensation=True)), then get_preview()
          and get_panorama() (the full-res render), launches counted,
          each of the 11 cuts with its node box, route (kernel 1
          resident, kernel 1's tiled route, or kernel 2) and ms, each
          launch checked against the crop rule of grid_mincut_auto,
          and kernel 1 against grid_mincut_ref on the cropped planes of
          the first cut of each of its routes (resident, tiled route):
          get_panorama joins the full-res prefetch that stitch() started
          (decode and upload under the preview); then the same render
          through the synchronous path and through a second prefetch, in
          turns, equal bit for bit, with their walls;
  prefetch_oom the same get_panorama() with the prefetch's upload out
          of device memory (fullres.prefetch_sources made to raise
          torch.OutOfMemoryError, after the peaks of the two routes show
          whether a memory cap could force it): the decoded images
          rendered through the chunked route on the card, equal bit for
          bit to the synchronous render, decoded once;
  slice3  a 12-view loop of 1400-px views through the CLI, as a user runs
          it: cli.main([dir, "--fast", "--timing", "--save-state", ...])
          (Lowe objective, default compositing), then cli.main(
          ["--from-state", ..., "--full-res", ...]); each command twice
          (cold, warm), no min-cut launches; the warm stitch captures no
          CUDA graph (it replays the BA programs the cold one left,
          ba.program) and gives the cold one's cameras and preview bytes;
  kernel3 on the real BA problem of that stitch (its match tables at full
          capacity, 16 camera slots, the stitched cameras): the Lowe
          system and the relaxed one, held against the plain version and
          against the port's own assembly (ba._assemble_cache +
          _schur_solve_system), which is also timed, as computed and in
          the Jacobi scaling of the solve;
  dist    the multi-device layer (parallel/) at world 1 over NCCL, in
          this process: the match-sharded LM (lm_run_sharded: one CUDA
          graph a trial with its all-reduces inside, kernel 3 on the
          rank's matches) against the same LM run eagerly and the
          single-card graph and eager runs on the BA problems of slices
          1 and 3, bit for bit; multi_blend_sharded on
          slice 2's blocks; the image-split and canvas-split full-res
          schedules against slice 2's single-device render; the
          column-sharded min-cut on slice 1's first seam graph against
          grid_mincut_ref and kernel 1;
  ba_cache the process's BA program cache (ba.program) on the BA problems
          of slices 1 and 3 padded to one bucket: the kept program on one,
          the other, the first again, each run equal bit for bit to a
          fresh LMProgram's, one capture in all;
  hostcut render/graphcut.graph_cut, the per-image host loop, on slice 1's
          blocks on the card: kernel 1 once per cut, seams against the
          device chain's;
  threads two stitches at once in two threads of this process, sharing
          kept BA programs (ba.program): the BA problems of slices
          1 and 3 through stitch.bundle_adjust_stitching, three rounds
          (the first cold), then two Panorama stitches of the 700-px
          loops of slices 1 and 3 (cold); each equal to its run alone
          bit for bit, kernel 3 once per trial executed;
  fresh   what a fresh process pays (fresh_trace.py): the CLI on slice
          3's views in two processes of their own (walls from launch
          to exit, imports, stage walls; equal preview files), and two
          cut=True stitches of slice 1's loop in one fresh process
          (the second captures nothing; equal cameras and preview
          bytes; kernel 1 11 launches a stitch); neither CLI process
          nor the first stitch imports torch._dynamo;
  two_card with two or more cards, slice 2 in a world of 2 ranks over
          NCCL (one process a card; its BA splits the matches, each
          bucket's trial a CUDA graph with its all-reduces) against the
          single-card run; with one card a line says it was skipped;
  ba      the BA problems of slice 1 (relaxed) and slice 3 (Lowe) again
          through stitch.bundle_adjust_stitching, fused=False (eager
          trials) and fused=True (each bucket's trial a CUDA graph): one
          eager run, two cold graph runs (kept programs released first),
          then one warm graph run (no capture, the cold run's bits) and
          the memory the kept programs hold: walls, LM trials,
          host reads, graphs, kernel-3 launches, the cameras of the two,
          the device's busy share (torch.profiler), kernel 3 at each
          bucket;
  trial   the LM trial at each bucket of the same two problems: kernels
          4 and 5 against their plain versions, their device ms, the
          plain versions' ms and the bounds; the single-card trial's
          graph (kernels 4, 3, 5) against the same program captured with
          ba.lm_trial: device operations a replay, device ms and us per
          trial;
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
  options the slice-3 loop through Panorama(...).stitch(Config(proj=
          CYLINDRICAL, cut=True, gain_compensation=True, bands=3)), then
          set_config on the same BA result for SIMPLE_BLEND, NO_BLEND
          without seams, straighten=False with blend_intensity=False, and
          the little planet with LINEAR_SCALING: previews, full-res and
          the CPU's previews from the same BA result;
  stream  load + keypoints of the loops of slices 1, 2 and 3 through
          the list path (every image decoded, then SIFT) and through the
          streaming decode, in turns, with SIFT's peak device memory;
  sift_oom SIFT of slice 2's loop with a budget of 6 images a chunk, then
          under torch.cuda.set_per_process_memory_fraction: the chunk
          halves until it fits, the features equal bit for bit;
  cpu_vs_card  4 views of 640 px (preview 320 px) through the port on
          "cpu" and "cuda", with graph-cut seams and with the Lowe
          objective: previews and full-res panoramas; and the little
          planet of a 12-view 300-px loop with its true geometry
          (set_config + render_preview, no BA).

Then one JSON line with the kernels' numbers and, last, the result line.
Any failure raises: the exit code is then non-zero and no result line
is printed. Without a CUDA card, or run alone (without the
simplepanorama_tpu_torch package beside it), it exits with code 1 before
any phase. It needs no network and starts no process of its own except
nvidia-smi, nvcc, the fresh phase's three processes (each waited for,
with a time limit) and, with two or more cards, the two ranks of the
two_card phase (parallel/launch.run_world, which kills them if they
outlive its time limit).
"""

import contextlib
import dataclasses
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np


_T0 = time.perf_counter()


def _line(phase, **kw):
    print(json.dumps({"phase": phase, **kw,
                      "t_s": time.perf_counter() - _T0}), flush=True)


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


def _views_state(torch, tmp, size, n):
    """The ComposeState of ``n`` overlapping ``size``-px views (30-degree
    yaw steps) warped with their true spherical geometry, at the block
    shape of a loop of such views."""
    import cv2
    from simplepanorama_tpu_torch.fixtures import fkh360_views
    from simplepanorama_tpu_torch.render import compose
    paths, yaws, f = fkh360_views(
        n, size, out_dir=os.path.join(tmp, f"views{n}_{size}"))
    imgs = [cv2.imread(p) for p in paths]
    Ks, Rs = [], []
    for im, yaw in zip(imgs, yaws):
        h, w = im.shape[:2]
        Ks.append(np.array([[f, 0, w // 2], [0, f, h // 2], [0, 0, 1.0]]))
        a = np.radians(yaw)
        Rs.append(np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                            [-np.sin(a), 0, np.cos(a)]]))
    return compose.warp_all("spherical", f, imgs, Rs, Ks, [1.0] * n,
                            device="cuda")


def _seam_graph(torch, tmp, size):
    """Seam graph of the second of two overlapping ``size``-px views
    against the first, at the block shape of a loop of such views (what
    render/graphcut._cut_step hands the solver)."""
    return _first_cut_graph(torch, _views_state(torch, tmp, size, 2), (0, 1))


def _first_cut_graph(torch, st, seq):
    """The seam graph of the first cut that render/graphcut.graph_cut_state
    makes on the ComposeState ``st`` in the order ``seq``: block seq[1]
    against block seq[0] pasted on the canvas, as contiguous tensors."""
    return _cut_graph(torch, st, seq[:1], seq[1])


def _cut_graph(torch, st, pasted, b):
    """The seam graph of block ``b`` of the ComposeState ``st`` against
    the blocks ``pasted`` pasted on the canvas, as contiguous tensors."""
    from simplepanorama_tpu_torch.render import graphcut
    gray = graphcut._gray_batch(st.imgs)
    N, Hb, Wb = st.masks.shape
    H, W = st.canvas_hw
    dev = st.imgs.device
    canvas = torch.zeros((H + Hb, W + Wb), device=dev)
    scene = torch.zeros((H + Hb, W + Wb), dtype=torch.bool, device=dev)
    offs = st.offs.tolist()
    for a in pasted:
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
    the work these inputs needed, the plain version's side). The plain
    time is the median of
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
    return abs(vk - vr), ms_k, ms_r, plain_stats, side_r


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


def _crop_rule(maxflow, H, W, box):
    """The kernel and the shape grid_mincut_auto's crop rule gives an
    (H, W) grid with node box ``box``: the whole grid at or under
    WHOLE_GRID_MAX_CELLS to kernel 1; over it, a box of at most 0.9 of the
    grid to kernel 1 at or under the limit, else to kernel 2; a larger
    box or no nodes, the whole grid to kernel 2."""
    limit = maxflow.WHOLE_GRID_MAX_CELLS
    if H * W <= limit:
        return "kernel1", (H, W)
    if box is not None:
        r0, r1, c0, c1 = box
        cells = (r1 - r0) * (c1 - c0)
        if cells <= 0.9 * H * W:
            return ("kernel1" if cells <= limit else "kernel2"), \
                (r1 - r0, c1 - c0)
    return "kernel2", (H, W)


def _route(maxflow, launched):
    """The route of one min-cut solve from the launches it added to
    kernels 1 and 2: kernel 1 with its tiles resident, kernel 1's tiled
    route, or kernel 2."""
    if launched == (1, 0):
        return ("kernel1_resident" if maxflow.grid_mincut.last_stats[
            "resident"] else "kernel1_tiled_route")
    return "kernel2" if launched == (0, 1) else f"launches {launched}"


def _check_route(name, maxflow, H, W, box, launched):
    """Fail unless one solve launched the one kernel the crop rule gives
    its box."""
    want = _crop_rule(maxflow, H, W, box)[0]
    if launched != ((1, 0) if want == "kernel1" else (0, 1)):
        raise RuntimeError(f"{name}: box {box} of a {H}x{W} grid launched "
                           f"kernels 1, 2 {launched} times, the crop rule "
                           f"gives {want}")


def _auto_pair(torch, maxflow, name, graph, turns, card, plain=False,
               plain_side=None):
    """grid_mincut_auto, the seam dispatch, on one seam graph: its node
    box, the kernel it launched (checked against the crop rule) and its
    cut, held against kernel 2 on the uncropped grid (grid_mincut_tiled),
    or with ``plain`` against kernel 2's plain version, and against
    ``plain_side`` where given (a plain version's side of the same graph,
    computed before), cut values within 1e-3 relative (float64 recount)
    and sides equal on >= 99.9% of nodes; then the dispatch and kernel 2
    timed in ``turns`` alternating turns (CUDA events, one solve each).
    Prints one line; returns it."""
    H, W = graph[0].shape
    box = maxflow._node_bbox(graph[3], H, W)
    before = _launches(maxflow)
    side_a = maxflow.grid_mincut_auto(*graph)
    after = _launches(maxflow)
    launched = (after[0] - before[0], after[1] - before[1])
    route = _route(maxflow, launched)
    ref = maxflow.grid_mincut_tiled_ref if plain else \
        maxflow.grid_mincut_tiled
    side_r = ref(*graph)
    host = [t.cpu().numpy() for t in graph]
    node = host[3]
    sa, sr = side_a.cpu().numpy(), side_r.cpu().numpy()
    va = maxflow.cut_value(*host, sa)
    vr = maxflow.cut_value(*host, sr)
    agree = float((sa == sr)[node].mean()) if node.any() else 1.0
    checks = [(ref.__name__ + ("" if plain else ", uncropped"), va, vr,
               agree)]
    if plain_side is not None:
        sp = plain_side.cpu().numpy()
        checks.append(("grid_mincut_tiled_ref, uncropped", va,
                       maxflow.cut_value(*host, sp),
                       float((sa == sp)[node].mean()) if node.any()
                       else 1.0))
    fns = (("auto", maxflow.grid_mincut_auto),
           ("uncropped_kernel2", maxflow.grid_mincut_tiled))
    ms = {k: [] for k, _ in fns}
    for turn in range(turns):
        for k, fn in (fns if turn % 2 == 0 else fns[::-1]):
            ms[k].append(_time_ms(torch, fn, graph, 1))
    cells = None if box is None else (box[1] - box[0]) * (box[3] - box[2])
    out = dict(input=name, shape=[H, W], cells=H * W,
               nodes=int(node.sum()), box=box, box_cells=cells,
               box_share=None if box is None else cells / (H * W),
               route=route, launches=list(launched), cut_auto=va,
               checks=[{"vs": c[0], "cut_reference": c[2],
                        "side_agreement": c[3]} for c in checks],
               auto_ms=statistics.median(ms["auto"]),
               uncropped_kernel2_ms=statistics.median(
                   ms["uncropped_kernel2"]), turns_ms=ms)
    _line("kernel2", **out, device=card)
    _check_route(name, maxflow, H, W, box, launched)
    for vs, va, vr, agree in checks:
        if not (abs(va - vr) <= 1e-3 * max(1.0, abs(vr))
                and agree >= 0.999):
            raise RuntimeError(f"grid_mincut_auto disagrees with {vs} on "
                               f"{name}: cut {va} vs {vr}, agreement "
                               f"{agree}")
    return out


@contextlib.contextmanager
def _cut_log(torch, maxflow):
    """Log every call of grid_mincut_auto that render/graphcut makes
    inside the block: a copy of its four planes, the launches it added to
    kernels 1 and 2, the route, the launched kernel's counters and CUDA
    events around it. Yields the list; ``_cut_table`` and ``_check_crops``
    read it after the block."""
    from simplepanorama_tpu_torch.render import graphcut
    auto = graphcut.grid_mincut_auto
    cuts = []

    def logged(cap_h, cap_v, excess0, node, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        before = _launches(maxflow)
        e0.record()
        side = auto(cap_h, cap_v, excess0, node, **kw)
        e1.record()
        after = _launches(maxflow)
        launched = (after[0] - before[0], after[1] - before[1])
        fn = maxflow.grid_mincut if launched[0] else \
            maxflow.grid_mincut_tiled
        cuts.append(([t.clone() for t in (cap_h, cap_v, excess0, node)],
                     launched, _route(maxflow, launched),
                     dict(fn.last_stats), e0, e1))
        return side
    graphcut.grid_mincut_auto = logged
    try:
        yield cuts
    finally:
        graphcut.grid_mincut_auto = auto


def _cut_table(torch, maxflow, name, cuts):
    """Each logged cut's node box, box cells, route, solver counters and
    ms; fails unless each launched the one kernel the crop rule gives its
    box."""
    torch.cuda.synchronize()
    table = []
    for graph, launched, route, stats, e0, e1 in cuts:
        node = graph[3]
        H, W = node.shape
        box = maxflow._node_bbox(node, H, W)
        _check_route(name, maxflow, H, W, box, launched)
        table.append({"box": box, "solved_shape": list(_crop_rule(
            maxflow, H, W, box)[1]), "nodes": int(node.sum()),
            "route": route, "solver_stats": stats,
            "ms": e0.elapsed_time(e1)})
    return table


def _check_crops(torch, maxflow, name, cuts, card):
    """Kernel 1 against its plain version (grid_mincut_ref) on the cropped
    planes that grid_mincut_auto handed it on a path: the first logged cut
    of each of kernel 1's routes (its tiles resident, or kernel 2's tiled
    route), through ``_solve_pair`` (cut values within 1e-3 relative,
    sides >= 99.9% of nodes). Returns {route: (input name, |cut
    difference|, kernel ms, plain ms, bound)}."""
    out = {}
    for i, (graph, launched, route, stats, e0, e1) in enumerate(cuts):
        if launched != (1, 0) or route in out:
            continue
        H, W = graph[3].shape
        box = maxflow._node_bbox(graph[3], H, W)
        if H * W <= maxflow.WHOLE_GRID_MAX_CELLS or box is None:
            box = (0, H, 0, W)     # solved whole, as the crop rule says
        r0, r1, c0, c1 = box
        crop = [t[r0:r1, c0:c1].contiguous() for t in graph]
        label = f"{name}_cut{i}_{r1 - r0}x{c1 - c0}"
        err, ms_k, ms_r, plain_stats, _ = _solve_pair(
            torch, maxflow, label, crop, maxflow.grid_mincut,
            maxflow.grid_mincut_ref, 3, 0, card, name)
        if maxflow.grid_mincut.last_stats["resident"] != \
                (route == "kernel1_resident"):
            raise RuntimeError(f"{label}: kernel 1 took another route "
                               f"than on the path ({route})")
        out[route] = (label, err, ms_k, ms_r,
                      _mincut_bound(crop[3], plain_stats))
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
    scale as the rotation entries), and a second call equal bit for bit;
    prints one line; returns (kernel outputs, largest |kernel - plain|,
    kernel ms, plain ms, (bound ms, bound side), launches of the checking
    call). The kernel is timed as the LM trial calls it: int32 ids and
    the bucket's workspace made once."""
    before = ba_kernel.assemble_streams.launches
    got = ba_kernel.assemble_streams(*streams, n_cams, with_schur=with_schur)
    launches = ba_kernel.assemble_streams.launches - before
    want = ba_kernel.assemble_streams_ref(*streams, n_cams,
                                          with_schur=with_schur)
    ws = ba_kernel.workspace(streams[0].shape[0], n_cams, streams[0].device)
    args = list(streams[:9]) + [t.to(torch.int32) for t in streams[9:]]
    call = lambda *a: ba_kernel.assemble_streams(*a, n_cams,
                                                 with_schur=with_schur, ws=ws)
    again = call(*args)
    torch.cuda.synchronize()
    same_bits = all(torch.equal(a, b) for a, b in zip(got, again))
    raw = _max_err(got, want)
    scaled = _max_err(_jacobi(torch, got, want[0]),
                      _jacobi(torch, want, want[0]))
    errs = {k: v[0] for k, v in raw.items()}
    scales = {k: v[1] for k, v in raw.items()}
    ms_k = _time_ms(torch, call, args)
    ms_r = _time_ms(torch, lambda *a: ba_kernel.assemble_streams_ref(
        *a, n_cams, with_schur=with_schur), streams)
    bound = _ba_bound(streams[9], streams[10], n_cams, with_schur)
    _line("kernel3", input=name, n_cams=n_cams, matches=streams[0].shape[0],
          with_schur=with_schur, max_abs_err=errs, plain_max_abs=scales,
          jacobi_max_abs_err={k: v[0] for k, v in scaled.items()},
          jacobi_plain_max_abs={k: v[1] for k, v in scaled.items()},
          same_bits_twice=same_bits, ctas=ws.ctas, per_cta=ws.per_cta,
          kernel_ms=ms_k, plain_ms=ms_r,
          device_ms=_device_ms(torch, call, args, ("assemble_kernel",), 20),
          bound_ms=bound[0], bound_by=bound[1], device=card, **extra)
    bad = [(k, form) for form, e in (("raw", raw), ("jacobi", scaled))
           for k, (err, scale) in e.items() if not err <= 1e-3 * scale + 1e-4]
    if bad or launches != 1 or not same_bits:
        raise RuntimeError(f"assemble_streams disagrees with its plain "
                           f"version on {name} ({bad}), launched "
                           f"{launches} times or changed bits between two "
                           f"calls ({not same_bits})")
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


def _private_pool_bytes(torch):
    """Bytes the caching allocator holds in private pools (those of CUDA
    graphs), from its segment snapshot."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0))


@contextlib.contextmanager
def _count_lm(stitch):
    """Count what the incremental bundle adjustment runs while the block
    runs, from the counts the chunk driver (stitch._lm_chunk) returns,
    read once per chunk: LM runs, their trials (accepted and rejected),
    accepted steps, trials executed (the warm-up before a capture and the
    no-op trials after a run's end included: kernel 3 launches once per
    executed trial), host reads of the termination flag, CUDA graphs
    captured and the host seconds spent capturing (0 and 0.0 when every
    bucket's program was kept from an earlier stitch: ba.program), and
    the last LM run's error."""
    counts = {"lm_runs": 0, "lm_trials": 0, "lm_accepted": 0,
              "trials_executed": 0, "fused_trials": 0, "host_reads": 0,
              "graphs": 0, "capture_s": 0.0, "lm_error": None}
    chunk = stitch._lm_chunk

    def counted(*a, **kw):
        cams, c = chunk(*a, **kw)
        counts["lm_runs"] += c.runs
        counts["lm_trials"] += int(c.trials)
        counts["lm_accepted"] += int(c.accepted)
        counts["trials_executed"] += c.executed
        counts["fused_trials"] += c.fused
        counts["host_reads"] += c.reads
        counts["graphs"] += c.graphs
        counts["capture_s"] += c.capture_s
        counts["lm_error"] = float(c.error)
        return cams, c
    stitch._lm_chunk = counted
    try:
        yield counts
    finally:
        stitch._lm_chunk = chunk


def _check_kernel3_path(name, launches, lm, k45, trial_kernels=True):
    """Kernel 3 launched once per trial executed on the path ``name``,
    and kernels 4 and 5 (their launches ``k45``, counted since the
    path's reset) too, each trial counted in ba.fused_trials where the
    path counts it (_check_trial_path); none of them where the path's
    trial is ba.lm_step (``trial_kernels`` False)."""
    if launches != lm["trials_executed"] or launches < lm["lm_trials"] \
            or lm["lm_trials"] < 1:
        raise RuntimeError(f"{name}: kernel 3 launched {launches} times for "
                           f"{lm['trials_executed']} trials executed "
                           f"({lm['lm_trials']} LM trials)")
    _check_trial_path(name, k45, lm["trials_executed"] if trial_kernels
                      else 0, lm["fused_trials"])


# kernels 4 and 5's launches on each path of the run, by path name:
# (trial_streams, solve_accept, trials executed through them)
_TRIAL_PATHS = {}


def _trial_launches(reset=False):
    """Launches of kernels 4 and 5 (ops/ba_trial: trial_streams,
    solve_accept; a graph's replays counted) since their last reset;
    ``reset`` zeroes them after reading."""
    from simplepanorama_tpu_torch.ops import ba_trial
    got = (ba_trial.trial_streams.launches, ba_trial.solve_accept.launches)
    if reset:
        ba_trial.trial_streams.launches = 0
        ba_trial.solve_accept.launches = 0
    return got


def _check_trial_path(name, k45, want, fused=None):
    """Kernels 4 and 5 launched ``want`` times each on the path ``name``
    (its trials executed on a single card, 0 where the trial is
    ba.lm_step), and ba.fused_trials (``fused``, where the path counts
    it) equal to that; recorded in _TRIAL_PATHS."""
    _TRIAL_PATHS[name] = (*k45, want)
    if tuple(k45) != (want, want) or fused not in (None, want):
        raise RuntimeError(f"{name}: kernels 4 and 5 launched {tuple(k45)} "
                           f"times and {fused} fused trials for {want} "
                           "trials")


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
    _trial_launches(reset=True)
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
            "assemble_streams_launches": ba_kernel.assemble_streams.launches,
            "trial_launches": _trial_launches()}


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


def _slice5(torch, paths, f_true, tmp, card):
    """Slice 5 on the card: the little planet of ``paths`` (the slice-3
    loop; full-res twice the 700-px preview), the viewer on it, the same
    result without the fix and re-composited with graph-cut seams (no
    second BA). Prints the slice5 line, checks its gates, and returns
    the min-cut launches (kernel 1, kernel 2) of the re-composite,
    kernel 1's |cut difference| from its plain version on the
    re-composite's first seam graph, and kernel 3's launches in the
    stitch (one per LM trial executed)."""
    import cv2
    from simplepanorama_tpu_torch import (Config, Panorama, PanoramaViewer,
                                          Projection, stitch)
    from simplepanorama_tpu_torch.ops import ba_kernel, maxflow
    from simplepanorama_tpu_torch.utils.timing import global_timer
    timer = global_timer()
    os.environ["SPT_SYNC_STAGES"] = "1"
    sten = Config(proj=Projection.STEREOGRAPHIC)
    timer.durations.clear()
    timer.counts.clear()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(maxflow)
    ba_kernel.assemble_streams.launches = 0
    _trial_launches(reset=True)
    t0 = time.perf_counter()
    with _count_lm(stitch) as lm5:
        pano = Panorama(paths, device="cuda").stitch(sten)
    preview = pano.get_preview()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches5_stitch = _launches(maxflow)
    launches5_k3 = ba_kernel.assemble_streams.launches
    k45_5 = _trial_launches()
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
    err5, ms5, plain_ms5, _, _ = _solve_pair(
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
          assemble_streams_launches=launches5_k3,
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
    _check_kernel3_path("slice5", launches5_k3, lm5, k45_5)
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
    return launches5, err5, launches5_k3, pano.result


def _disk_coverage(img):
    """Share of the ellipse inscribed in the preview's nonzero bounding
    box that is filled: the coverage of a little planet, a disk that
    fills at most pi / 4 of its box."""
    nz = img.max(axis=2) > 0
    ys, xs = np.nonzero(nz)
    box = nz[ys.min():ys.max() + 1, xs.min():xs.max() + 1]
    h, w = box.shape
    v, u = np.mgrid[0:h, 0:w]
    inside = (((v + 0.5) / h - 0.5) ** 2 + ((u + 0.5) / w - 0.5) ** 2
              <= 0.25)
    return float(box[inside].mean())


def _options_phase(torch, paths, f_true, card, slice5_result):
    """The compositing options on the card: the slice-3 loop (12 views of
    1400 px, previews at 700) through Panorama(paths, device="cuda")
    .stitch(Config(proj=CYLINDRICAL, cut=True, gain_compensation=True,
    bands=3)) (relaxed BA, graph-cut seams: kernel 1 once a cut),
    get_preview() and get_panorama(); then, on the same BA result,
    set_config, get_preview() and get_panorama() for SIMPLE_BLEND,
    NO_BLEND with cut_seams=False (both cylindrical), spherical with
    straighten=False and blend_intensity=False, and the little planet
    with LINEAR_SCALING. Each configuration's preview is also made on
    the CPU from the same BA result (convert.stitch_result_from_numpy:
    the port's set_config and render_preview with device="cpu"; for the
    graph cut, with the card's seams). One
    line a configuration; gates: coverage > 0.9 (of the box, or of the
    disk inscribed in it for the little planet, whose centre must not
    stay dark), full-res about 2x the preview with NCC >= 0.95 in the
    common footprint (SLICE5_FIXED_NCC_GATE for the little planet), the
    card's preview against the CPU's NCC >= 0.98, kernel 1 once a cut
    on the stitch and kernel 3 once per LM trial executed. Returns the
    stitch's min-cut launches (kernel 1, kernel 2) and kernel 3's."""
    import cv2
    from simplepanorama_tpu_torch import (Blending, Config, Panorama,
                                          Projection, Stretch, stitch,
                                          stitcher)
    from simplepanorama_tpu_torch.convert import stitch_result_from_numpy
    from simplepanorama_tpu_torch.ops import ba_kernel, maxflow
    cyl = Projection.CYLINDRICAL
    options = [     # (name, Config): the first is the stitch's
        ("cylindrical_cut_gain_bands3",
         Config(proj=cyl, cut=True, gain_compensation=True, bands=3)),
        ("cylindrical_simple_blend",
         Config(proj=cyl, blend=Blending.SIMPLE_BLEND)),
        ("cylindrical_no_blend_no_cut_seams",
         Config(proj=cyl, blend=Blending.NO_BLEND, cut_seams=False)),
        ("spherical_no_straighten_no_blend_intensity",
         Config(proj=Projection.SPHERICAL, straighten=False,
                blend_intensity=False)),
        ("stereographic_linear_scaling",
         Config(proj=Projection.STEREOGRAPHIC,
                stretching=Stretch.LINEAR_SCALING))]
    _reset_launches(maxflow)
    ba_kernel.assemble_streams.launches = 0
    _trial_launches(reset=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _count_lm(stitch) as lm:
        pano = Panorama(paths, device="cuda").stitch(options[0][1])
    res = pano.result
    comp_imgs = [pano.images.img_data[g] for g in res.nodes]
    n_cuts = len(res.order) - 1
    focals = res.K[:, 0, 0]
    for k, (name, cfg) in enumerate(options):
        if k:
            _reset_launches(maxflow)
            ba_kernel.assemble_streams.launches = 0
            _trial_launches(reset=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pano.set_config(cfg)
        preview = pano.get_preview()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launches(maxflow)
        launches_k3 = ba_kernel.assemble_streams.launches
        if not k:
            launches_stitch, k3 = launches, launches_k3
            k45 = _trial_launches()
        t0 = time.perf_counter()
        full = pano.get_panorama()
        torch.cuda.synchronize()
        full_wall = time.perf_counter() - t0
        planet = cfg.proj == Projection.STEREOGRAPHIC
        cov = _disk_coverage(preview) if planet else _coverage(preview)
        small = cv2.resize(full, (preview.shape[1], preview.shape[0]),
                           interpolation=cv2.INTER_AREA)
        ncc_full = _ncc_common(preview, small)
        t0 = time.perf_counter()
        # with cut=True the CPU takes the card's seams: its host Dinic
        # loop took 268 s on the 12 blocks of 700-px views (the seams are
        # held by the kernel lines and the hostcut phase)
        params = stitcher.set_config(
            stitch_result_from_numpy(res), comp_imgs,
            dataclasses.replace(cfg, cut=False), device="cpu")
        if cfg.cut:
            params.state.seam_masks = pano.stitch_params.state \
                .seam_masks.cpu()
        cpu_preview = stitcher.render_preview(params, cfg)
        cpu_wall = time.perf_counter() - t0
        # pixel for pixel on one canvas, else the best over shifts
        ncc_cpu, shift = ((_ncc(cpu_preview, preview), (0, 0))
                          if cpu_preview.shape == preview.shape
                          else _ncc_aligned(cpu_preview, preview))
        extra = {}
        if not k:
            extra = dict(lm, focal_true=f_true,
                         focals=[float(x) for x in focals], cuts=n_cuts,
                         cameras_equal_slice5_bits=bool(
                             np.array_equal(res.K, slice5_result.K)
                             and np.array_equal(res.rot,
                                                slice5_result.rot)))
        if planet:
            extra.update(center_dark=_center_dark(preview),
                         sten_circle=pano.stitch_params.sten_circle)
        _line("options", config=name, preview_shape=list(preview.shape),
              full_shape=list(full.shape), coverage=cov,
              full_vs_preview_ncc=ncc_full, cpu_vs_card_ncc=ncc_cpu,
              cpu_vs_card_shift=list(shift),
              cpu_shape=list(cpu_preview.shape),
              wall_s=wall, full_wall_s=full_wall, cpu_wall_s=cpu_wall,
              mincut_launches=list(launches),
              assemble_streams_launches=launches_k3, **extra, device=card)
        gate = SLICE5_FIXED_NCC_GATE if planet else 0.95
        if not np.isfinite(preview).all() or cov <= 0.9:
            raise RuntimeError(f"options {name}: coverage {cov}")
        if planet and extra["center_dark"] >= 0.10:
            raise RuntimeError(f"options {name}: centre-dark "
                               f"{extra['center_dark']}")
        if (abs(full.shape[0] - 2 * preview.shape[0]) > 8
                or abs(full.shape[1] - 2 * preview.shape[1]) > 8
                or ncc_full < gate):
            raise RuntimeError(f"options {name}: full-res {full.shape} vs "
                               f"preview {preview.shape}, NCC {ncc_full}")
        if ncc_cpu < 0.98:
            raise RuntimeError(f"options {name}: CPU and card previews NCC "
                               f"{ncc_cpu}")
        if k and (launches != (0, 0) or launches_k3):
            raise RuntimeError(f"options {name}: min-cut launches "
                               f"{launches}, kernel 3 {launches_k3}, "
                               "without cut or BA")
        del preview, full, small, params, cpu_preview
    if tuple(pano.connected) != (12, 12):
        raise RuntimeError(f"options connected {pano.connected}")
    if np.max(np.abs(focals / f_true - 1.0)) > 0.02:
        raise RuntimeError(f"options focals {focals} vs true {f_true}")
    if launches_stitch != (n_cuts, 0):
        raise RuntimeError(f"options: min-cut launches {launches_stitch} "
                           f"for {n_cuts} cuts, wanted kernel 1 once a cut")
    _check_kernel3_path("options", k3, lm, k45)
    return launches_stitch, k3


def _sift_oom_phase(torch, views, card, budget=40_000_000_000,
                    cap=24_000_000_000):
    """SIFT of slice 2's loop (12 views of 2800 px at init_size 1400,
    the list path) with SPT_SIFT_MEM_BUDGET at ``budget`` bytes (6 images
    a chunk by the memory model) without a cap, then under
    torch.cuda.set_per_process_memory_fraction for ``cap`` bytes, where a
    chunk of that size runs out of memory: the chunk must halve until it
    fits (features._SIFT_CHUNK_CACHE remembers the size that ran), and
    the features must equal the uncapped run's bit for bit. The fraction
    is set back to 1 afterwards. Prints one line."""
    from simplepanorama_tpu_torch import Config, ba, features
    from simplepanorama_tpu_torch.io import ImageSet
    files = sorted(os.path.join(views, f) for f in os.listdir(views))
    cfg = Config(init_size=1400)
    images = ImageSet(files)
    images.load_resized(cfg.init_size, cfg.threads)
    imgs = images.img_data
    Hp, Wp = features._pad8([im.shape[:2] for im in imgs])
    key = features._shape_key(Hp, Wp, cfg)
    old = os.environ.get("SPT_SIFT_MEM_BUDGET")
    os.environ["SPT_SIFT_MEM_BUDGET"] = str(budget)
    features._SIFT_CHUNK_CACHE.pop(key, None)
    runs = {}
    try:
        chunk = features._sift_chunk_size(len(imgs), Hp, Wp, cfg)
        ba.release_programs()
        for name in ("uncapped", "capped"):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            total = torch.cuda.get_device_properties(0).total_memory
            if name == "capped":
                torch.cuda.set_per_process_memory_fraction(cap / total)
            try:
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                feats = features.extract_features(imgs, cfg, device="cuda")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                torch.cuda.set_per_process_memory_fraction(1.0)
            runs[name] = (wall, torch.cuda.max_memory_allocated(),
                          features._SIFT_CHUNK_CACHE.get(key, chunk),
                          [(f.xy, f.size, f.response, f.desc, f.valid)
                           for f in feats])
            del feats
    finally:
        if old is None:
            os.environ.pop("SPT_SIFT_MEM_BUDGET")
        else:
            os.environ["SPT_SIFT_MEM_BUDGET"] = old
    equal = all(np.array_equal(a, b)
                for fa, fb in zip(runs["uncapped"][3], runs["capped"][3])
                for a, b in zip(fa, fb))
    ran = runs["capped"][2]
    _line("sift_oom", views=len(imgs), padded=[Hp, Wp], budget=budget,
          budget_chunk=chunk, cap=cap, chunk_ran=ran,
          uncapped_chunk=runs["uncapped"][2], equal_bits=equal,
          keypoints=int(sum(f[4].sum() for f in runs["capped"][3])),
          walls_s={k: v[0] for k, v in runs.items()},
          peaks={k: v[1] for k, v in runs.items()}, device=card)
    if not (chunk > 1 and runs["uncapped"][2] == chunk and ran < chunk
            and runs["capped"][1] <= cap and equal):
        raise RuntimeError(f"sift_oom: chunk {chunk} under a {cap}-byte cap "
                           f"ran at {ran}, peak {runs['capped'][1]}, "
                           f"features equal: {equal}")


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


class _WindowDone(Exception):
    """Raised in _busy_share's wrapped _lm_chunk once its window has
    closed."""


def _busy_share(torch, stitch, run, chunks):
    """The device's busy share over the first ``chunks`` chunks of the BA
    that ``run()`` drives: torch.profiler (device activity only) on from
    the first chunk's start to the end of chunk ``chunks`` (a window,
    because the profiler's post-processing of a whole eager BA, ~300k
    kernels and their host ops, takes minutes); the BA stops there.
    Returns (device seconds in CUDA kernels and copies, window seconds);
    device seconds None when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CUDA])
    chunk = stitch._lm_chunk
    window = {"n": 0}

    def profiled(*a, **kw):
        if window["n"] == 0:
            torch.cuda.synchronize()
            prof.start()
            window["t0"] = time.perf_counter()
        out = chunk(*a, **kw)
        window["n"] += 1
        if window["n"] == chunks:
            torch.cuda.synchronize()
            window["t1"] = time.perf_counter()
            prof.stop()
            raise _WindowDone
        return out
    stitch._lm_chunk = profiled
    try:
        run()
    except _WindowDone:
        pass
    finally:
        stitch._lm_chunk = chunk
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
             for e in prof.key_averages())
    return (us / 1e6 if us > 0 else None), window["t1"] - window["t0"]


# chunks of the schedule in the profiled window of the BA's busy share,
# graph and eager: a fifth of a 12-view schedule's, with its first
# capture for the graphs; the eager window is one chunk, since the
# profiler's processing of the eager trials' kernels and launches took
# ~30 s a problem for two
BUSY_CHUNKS = {True: 2, False: 1}


def _eager_kernel_trials(torch):
    """A stand-in for ba.lm_trial that runs kernels 4, 3 and 5 eagerly
    (ba.fused_trial on a copy of the state, the problem's tables copied
    once into buffers of the layout the kernels take): ba.lm_run_eager
    then runs the graph's arithmetic without a graph."""
    from simplepanorama_tpu_torch import ba
    from simplepanorama_tpu_torch.ops import ba_trial
    held = {}

    def trial(st, pb, fast):
        if held.get("pb") is not pb:
            data = ba.BAData(*(t.clone() for t in pb.data))
            held.update(pb=pb, copy=pb._replace(
                data=data, cam_active=pb.cam_active.clone()),
                tw=ba_trial.workspace(data.mi.shape[0],
                                      st.cams.focal.shape[0],
                                      data.pi.shape[0], "cuda"))
        new = ba.LMState(ba.CamState(*(t.clone() for t in st.cams)),
                         *(t.clone() for t in st[1:]))
        live = torch.zeros((), dtype=torch.bool, device="cuda")
        ba.fused_trial(new, held["copy"], fast, live, held["tw"])
        return new
    return trial


def _ba_phase(torch, problems, card):
    """Each recorded BA problem {name: (comp, adjres, sizes, focal, cfg)}
    through stitch.bundle_adjust_stitching on the card with fused=False
    (eager trials) and fused=True (the buckets' CUDA graphs): one eager
    run, then two graph runs, each cold (the process's kept programs
    released first, ba.release_programs), then one warm graph run on the
    programs the cold one left; one line per
    run, the device memory the kept programs hold (reserved before and
    after release_programs, and in graphs' private pools), then one run
    of each with the device's busy share measured over its first chunks
    (torch.profiler; the graph run cold), and kernel 3 at each capacity
    bucket of the schedule (the streams of that bucket's last state)
    against its plain version. The graph runs' trial is kernels 4, 3
    and 5; the eager run's is ba.lm_step, and before it one more eager
    run takes kernels 4, 3 and 5 launched one by one
    (_eager_kernel_trials), the first run the others are held to.
    Checks: the same LM trials and accepted steps in every run but
    ba.lm_step's, cameras within 1e-5 relative between them; kernel 3
    launched once per trial executed, kernels 4 and 5 too in the
    kernels' runs and never in ba.lm_step's (_check_kernel3_path), which
    runs the same LM runs; one graph per bucket in a cold run, none in
    the warm run, whose trials, cameras and error equal the cold run's
    bit for bit. A host sync inside a trial would fail the graph run's
    capture. Returns {name: {"launches": kernel-3 launches of the runs,
    "buckets": the kernel3 results of the largest bucket}}."""
    from simplepanorama_tpu_torch import ba, stitch
    from simplepanorama_tpu_torch.ops import ba_kernel
    out = {}
    for name, (comp, adjres, sizes, focal, cfg) in problems.items():
        ref = graphs = cold = None
        launches = 0
        walls = {"lm_step": [], False: [], True: [], "warm": []}
        chunks = []
        for step, fused, warm in ((True, False, False),
                                  (False, False, False), (False, True, False),
                                  (False, True, False), (False, True, True)):
            ba_kernel.assemble_streams.launches = 0
            _trial_launches(reset=True)
            record = fused and not walls[True]    # the first graph run
            if fused and not warm:
                ba.release_programs()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with _count_lm(stitch) as lm:
                counted = stitch._lm_chunk

                def recording(cams, active, data, *a, **kw):
                    res = counted(cams, active, data, *a, **kw)
                    if record:
                        chunks.append((res[0], active.clone(), data))
                    return res
                stitch._lm_chunk = recording
                lm_trial = ba.lm_trial
                if not fused and not step:
                    ba.lm_trial = _eager_kernel_trials(torch)
                try:
                    res = stitch.bundle_adjust_stitching(
                        comp, adjres, sizes, focal, cfg, device="cuda",
                        fused=fused)
                finally:
                    stitch._lm_chunk = counted
                    ba.lm_trial = lm_trial
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            walls["warm" if warm else "lm_step" if step else fused].append(
                wall)
            k3 = ba_kernel.assemble_streams.launches
            k45 = _trial_launches()
            launches += k3
            if step:
                _line("ba", problem=name, trial="ba.lm_step", fused=False,
                      fast=bool(cfg.fast), wall_s=wall, **lm,
                      assemble_streams_launches=k3, device=card)
                _check_kernel3_path(f"ba {name} lm_step", k3, lm, k45,
                                    trial_kernels=False)
                lm_step_runs = lm["lm_runs"]
                continue
            if ref is None:
                ref = (res, lm)
            if fused and graphs is None:
                graphs = lm["graphs"]
                cold = (res, lm)
            df = float(np.max(np.abs(res.K[:, 0, 0] / ref[0].K[:, 0, 0]
                                      - 1.0)))
            drot = float(np.max(np.abs(res.rot - ref[0].rot)))
            extra = {}
            if warm:
                # the memory the kept programs hold, and what releasing
                # them frees
                torch.cuda.synchronize()
                held = (torch.cuda.memory_reserved(), _private_pool_bytes(
                    torch))
                ba.release_programs()
                torch.cuda.empty_cache()
                extra = dict(
                    cold_equal_bits=bool(
                        np.array_equal(res.K, cold[0].K)
                        and np.array_equal(res.rot, cold[0].rot)
                        and lm["lm_error"] == cold[1]["lm_error"]),
                    kept_programs_memory={
                        "reserved_before_release": held[0],
                        "private_pools_before_release": held[1],
                        "reserved_after_release": (
                            torch.cuda.memory_reserved()),
                        "private_pools_after_release": _private_pool_bytes(
                            torch)})
            _line("ba", problem=name, trial="kernels 4, 3, 5",
                  fused=fused, warm=warm,
                  fast=bool(cfg.fast), wall_s=wall, **lm,
                  ms_per_trial=wall * 1e3 / max(1, lm["lm_trials"]),
                  assemble_streams_launches=k3,
                  read_every=ba.READ_EVERY,
                  focal_rel_diff_vs_first=df, rot_diff_vs_first=drot,
                  focals=[float(x) for x in res.K[:, 0, 0]], **extra,
                  device=card)
            if (lm["lm_runs"], lm["lm_trials"], lm["lm_accepted"]) != (
                    ref[1]["lm_runs"], ref[1]["lm_trials"],
                    ref[1]["lm_accepted"]) or lm_step_runs != lm["lm_runs"]:
                raise RuntimeError(f"ba {name}: fused={fused} ran {lm}, the "
                                   f"first run {ref[1]}, ba.lm_step "
                                   f"{lm_step_runs} LM runs")
            if df > 1e-5 or drot > 1e-5:
                raise RuntimeError(f"ba {name}: fused={fused} cameras differ "
                                   f"from the first run's by {df} (focal) "
                                   f"and {drot} (rotation)")
            if fused and not warm and lm["graphs"] != graphs:
                raise RuntimeError(f"ba {name}: a cold graph run captured "
                                   f"{lm['graphs']} graphs, the first "
                                   f"{graphs}")
            if warm and (lm["graphs"] != 0 or lm["capture_s"] != 0.0
                         or not extra["cold_equal_bits"]):
                raise RuntimeError(f"ba {name}: the warm graph run captured "
                                   f"{lm['graphs']} graphs, equal to the "
                                   f"cold run: {extra['cold_equal_bits']}")
            # the eager kernels' trials are no program's: ba.fused_trials
            # counts none of them
            _check_kernel3_path(f"ba {name} {'graph' if fused else 'eager'}"
                                f"{' warm' if warm else ''}", k3,
                                lm if fused else dict(lm, fused_trials=None),
                                k45)
        busy = {}
        for fused in (False, True):
            ba.release_programs()    # the graph run's window holds a capture
            dev_s, wall = _busy_share(
                torch, stitch, lambda: stitch.bundle_adjust_stitching(
                    comp, adjres, sizes, focal, cfg, device="cuda",
                    fused=fused), BUSY_CHUNKS[fused])
            busy["graph" if fused else "eager"] = {
                "chunks": BUSY_CHUNKS[fused], "device_s": dev_s,
                "window_s": wall,
                "busy_share": dev_s / wall if dev_s else None}
        # kernel 3 at each bucket the graph run used: the bucket's last
        # chunk's final state
        buckets = {}
        for cams, active, data in chunks:
            buckets[(cams.focal.shape[0], data.mi.shape[0])] = \
                (cams, active, data)
        results = {}
        for (n_cap, m_cap), (cams, active, data) in sorted(buckets.items()):
            active_m = ba._active_matches(data, active)
            streams = ba.streams_from_problem(
                cams, data, active_m, float(cfg.lambda_), active, n_cap,
                bool(cfg.fast))
            results[n_cap, m_cap] = _kernel3_pair(
                torch, ba_kernel, f"{name}_bucket_n{n_cap}_m{m_cap}",
                streams, n_cap, not cfg.fast, card,
                active_matches=int(active_m.sum()))
        _line("ba", problem=name, summary=True,
              lm_step_walls_s=walls["lm_step"],
              eager_walls_s=walls[False], graph_walls_s=walls[True],
              warm_graph_walls_s=walls["warm"], busy=busy,
              buckets=[list(k) for k in sorted(buckets)], device=card)
        if graphs != len(buckets):
            raise RuntimeError(f"ba {name}: {graphs} graphs captured for "
                               f"{len(buckets)} capacity buckets")
        out[name] = {"launches": launches,
                     "largest": results[max(results)]}
    return out


def _trial_bound(M, N, P, fast):
    """Bounds (ms, side) of kernels 4 and 5 at one bucket: bytes each
    input read once and each output written once, against 3.35 TB/s;
    f32 operations against 67 TFLOP/s. Kernel 4 reads mi, mj (4 B), mp
    (8 B), q, t and, relaxed, b (8 B each) and active_m (1 B) a match,
    writes Ai23, Aj23 (48 B each), B23 (16 B), the residual rows (8 B),
    the five l and g streams (20 B) and, relaxed, e_B (8 B) and V^-1
    (16 B); it does ~400 operations a match (dehomogenization 25, dH/dcam
    b 180 and its projection 120, B23 20, V, e_B and V^-1 ~55) and ~1,800
    a pair table (thirteen 3x3 chains). Kernel 5 reads U and, relaxed,
    YW (36 N^2 floats each), e_A, yeb, then a match's mi, mj, mp, q, t,
    active_m and, relaxed, Ai23, Aj23, B23, e_B, V^-1 and b (41 or 169
    B), writes b (8 B, relaxed; the trial b once more through its
    scratch); it does (2/3) n^3 for the LU of n = 6N, n^2 for the
    back-substitution, and ~40 operations a match (the trial residual
    and its norm), relaxed 60 more (W^T da, db)."""
    n = 6 * N
    k4_bytes = M * (41 + (8 if not fast else 0)) + M * (140 + (
        0 if fast else 24))
    k4_ops = M * 400 + P * 1800
    k5_bytes = (n * n * (1 if fast else 2) + 2 * n) * 4 + M * (
        41 if fast else 169) + (0 if fast else M * 24)
    k5_ops = 2 * n ** 3 / 3 + n * n + M * (40 if fast else 100)
    return _bound(k4_bytes, k4_ops), _bound(k5_bytes, k5_ops)


def _graph_ops(torch, graph):
    """The operations one replay of ``graph`` runs on the card, by name,
    from torch.profiler (the ranges the host marks left out)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    cuda_t = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    host = {e.name() for e in events if e.device_type() != cuda_t}
    return [e.name() for e in events
            if e.device_type() == cuda_t and e.name() not in host]


def _lm_trial_program(data, n_cams, fast):
    """A single-card ba.LMProgram whose captured trial is ba.lm_trial (the
    trial before kernels 4 and 5, a sharded program's): the trial phase's
    baseline and the dist phase's single-card run."""
    from simplepanorama_tpu_torch import ba

    class LmTrialProgram(ba.LMProgram):
        trial_kernels = False

        def trial(self):
            self._store(ba.lm_trial(self.st, self.pb, self.fast))
    return LmTrialProgram(data, n_cams, fast)


def _event_ms(torch, launch, reset=None, reps=9):
    """Median device ms of ``launch()`` by CUDA events around it, the card
    kept busy before the first event (torch.cuda._sleep) so that the
    events time the kernels and not the host's launch; ``reset()`` runs
    before each, outside the events."""
    ts = []
    for _ in range(reps):
        if reset is not None:
            reset()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        e0.record()
        launch()
        e1.record()
        torch.cuda.synchronize()
        ts.append(e0.elapsed_time(e1))
    return statistics.median(ts)


def _trial_phase(torch, problems, card):
    """The LM trial at each capacity bucket of the BA problems
    {name: (comp, adjres, sizes, focal, cfg)} (slice 1's is the
    benchmark cell's: 12 views of 700 px, relaxed objective), from the
    result of the bucket's last chunk with the focals 3% high and the
    rotations moved (_perturbed), so the trials are live:
     * kernels 4 and 5 against their plain versions (ba.trial_streams_ref,
       ba.solve_accept_ref) on that state: the largest difference of each
       stream over its largest entry (at most 1e-4), the same accept
       decision, and each camera tensor's largest difference within 1e-4
       of the trial's step (max |want - start|) plus 4 float32 roundings
       of its largest entry; each kernel's device ms by CUDA events
       around its eager launch (_event_ms; kernel 5 from the reloaded
       state each time), the plain version's ms (CUDA events, eager on
       the card) and the bound (_trial_bound);
     * the whole trial: the bucket's single-card LMProgram (kernels 4, 3
       and 5 captured) against the same buffers with the trial captured
       as ba.lm_trial (_lm_trial_program, what the sharded program still
       replays): device operations one replay runs (torch.profiler), us
       per trial by CUDA events over groups of 8 replays (each group from
       the reloaded state) and device ms per trial by the profiler (None
       where it recorded none of the graph's kernels).
    One "trial" line per bucket; returns the numbers of the largest
    bucket of slice 1's problem."""
    from simplepanorama_tpu_torch import ba, stitch
    from simplepanorama_tpu_torch.ops import ba_kernel, ba_trial
    out = {}
    copy = lambda st: ba.LMState(ba.CamState(*(t.clone() for t in st.cams)),
                                 *(t.clone() for t in st[1:]))
    for name, (comp, adjres, sizes, focal, cfg) in problems.items():
        fast = bool(cfg.fast)
        buckets = {}
        chunk = stitch._lm_chunk

        def recording(cams, active, data, *a, **kw):
            res = chunk(cams, active, data, *a, **kw)
            buckets[(res[0].focal.shape[0], data.mi.shape[0])] = (
                res[0], active.clone(), data)
            return res
        stitch._lm_chunk = recording
        try:
            stitch.bundle_adjust_stitching(comp, adjres, sizes, focal, cfg,
                                           device="cuda")
        finally:
            stitch._lm_chunk = chunk
        for (N, M), (cams, active, data) in sorted(buckets.items()):
            P = data.pi.shape[0]
            start = _perturbed(torch, cams, active)
            lam = float(cfg.lambda_)
            row = {}
            for fused in (True, False):
                prog = ba.LMProgram(data, N, fast) if fused else \
                    _lm_trial_program(data, N, fast)
                try:
                    prog._load(start, active, lam)
                    if fused:
                        loaded = copy(prog.st)
                        st = copy(loaded)
                        live = prog.live.clone()
                        ts = ba_trial.trial_streams(st, prog.pb, fast,
                                                    prog.tw)
                        streams = ba_trial.TrialStreams(
                            *(t.clone() for t in ts))
                        sums = ba_kernel.assemble_streams(
                            *ts[:9], prog.pb.mi, prog.pb.mj, N,
                            with_schur=not fast, ws=prog.pb.ws)
                        ba_trial.solve_accept(st, prog.pb, fast, ts, sums,
                                              live, prog.tw)
                        want_ts = ba.trial_streams_ref(loaded, prog.pb,
                                                       fast)
                        ref_in = streams if not fast else streams._replace(
                            eB=None, vinv=None)
                        want, _ = ba.solve_accept_ref(loaded, prog.pb, fast,
                                                      ref_in, sums)
                        rel = lambda g, w: float((g - w).abs().max()) / max(
                            float(w.abs().max()), 1.0)
                        row["k4_max_rel"] = max(
                            rel(g, w) for g, w in zip(streams, want_ts)
                            if w is not None)
                        row["k5_max_rel"] = max(
                            rel(g, w) for g, w in zip(st.cams, want.cams))
                        steps, within = {}, True
                        for k, g, w, s0 in zip(ba.CamState._fields,
                                               st.cams, want.cams,
                                               loaded.cams):
                            step = float((w - s0).abs().max())
                            err = float((g - w).abs().max())
                            steps[k] = [err, step]
                            within &= err <= 1e-4 * step + 4 * 2.0 ** -24 \
                                * float(w.abs().max())
                        row["k5_err_and_step"] = steps
                        row["k5_within_step"] = within
                        row["k5_same_decision"] = bool(
                            torch.equal(st.n_acc, want.n_acc))
                        row["k4_plain_ms"] = _time_ms(
                            torch, ba.trial_streams_ref,
                            (loaded, prog.pb, fast))
                        row["k5_plain_ms"] = _time_ms(
                            torch, ba.solve_accept_ref,
                            (loaded, prog.pb, fast, ref_in, sums))
                        row["k4_ms"] = _event_ms(
                            torch, lambda: ba_trial.trial_streams(
                                st, prog.pb, fast, prog.tw))

                        def reload():
                            for dst, src in zip(prog._tensors(st),
                                                prog._tensors(loaded)):
                                dst.copy_(src)
                        ts = ba_trial.trial_streams(loaded, prog.pb, fast,
                                                    prog.tw)
                        sums = ba_kernel.assemble_streams(
                            *ts[:9], prog.pb.mi, prog.pb.mj, N,
                            with_schur=not fast, ws=prog.pb.ws)
                        row["k5_ms"] = _event_ms(
                            torch, lambda: ba_trial.solve_accept(
                                st, prog.pb, fast, ts, sums, live, prog.tw),
                            reload)
                    prog._capture()
                    ops = _graph_ops(torch, prog.graph)
                    by_kernel = {}
                    walls = []
                    for rep_ in range(8):
                        prog._load(start, active, lam)
                        torch.cuda.synchronize()
                        if rep_ == 0:
                            by_kernel = _device_ms_by_kernel(
                                torch, lambda: [prog.graph.replay()
                                                for _ in range(8)], (), 1)
                            continue
                        e0 = torch.cuda.Event(enable_timing=True)
                        e1 = torch.cuda.Event(enable_timing=True)
                        e0.record()
                        for _ in range(8):
                            prog.graph.replay()
                        e1.record()
                        torch.cuda.synchronize()
                        walls.append(e0.elapsed_time(e1) / 8)
                    key = "fused" if fused else "lm_trial"
                    row[key] = {
                        "graph_ops": len(ops),
                        "us_per_trial": statistics.median(walls) * 1e3,
                        "device_ms_per_trial": (sum(by_kernel.values()) / 8
                                                if by_kernel else None),
                        "top": sorted(((v / 8, k) for k, v in
                                       by_kernel.items()), reverse=True)[:4]}
                    if fused:
                        row["per_trial"] = {
                            k.__name__: v for k, v in prog.per_trial.items()}
                finally:
                    prog.close()
            b4, b5 = _trial_bound(M, N, P, fast)
            row.update(k4_bound_ms=b4[0], k4_bound_by=b4[1],
                       k5_bound_ms=b5[0], k5_bound_by=b5[1])
            _line("trial", problem=name, n_cams=N, matches=M, pairs=P,
                  fast=fast, active_matches=int(ba._active_matches(
                      data, active).sum()), **row, device=card)
            if row["per_trial"] != {"assemble_streams": 1,
                                    "trial_streams": 1, "solve_accept": 1} \
                    or row["fused"]["graph_ops"] > 6:
                raise RuntimeError(f"trial {name} n{N} m{M}: the fused "
                                   f"trial ran {row['fused']['graph_ops']} "
                                   f"operations, {row['per_trial']}")
            if row["k4_max_rel"] > 1e-4 or not row["k5_same_decision"] \
                    or row["k5_max_rel"] > 1e-4 or not row["k5_within_step"]:
                raise RuntimeError(f"trial {name} n{N} m{M}: kernels 4 and "
                                   f"5 disagree with their plain versions "
                                   f"({row['k4_max_rel']}, "
                                   f"{row['k5_max_rel']}, "
                                   f"{row['k5_err_and_step']}, "
                                   f"{row['k5_same_decision']})")
            if name == "slice1_relaxed":
                out = row
    return out


def _perturbed(torch, cams, active, seed=0):
    """``cams`` with the focals 3% high and the rotation vectors of the
    active cameras but the first moved by N(0, 0.01) rad (numpy ``seed``),
    so that an LM run from there takes many trials."""
    rng = np.random.default_rng(seed)
    n = int(active.sum())
    noise = np.zeros(tuple(cams.rotvec.shape), np.float32)
    noise[1:n] = rng.normal(0.0, 0.01, (n - 1, 3))
    return cams._replace(focal=cams.focal * 1.03,
                         rotvec=cams.rotvec + torch.from_numpy(noise).cuda())


def _dist_phase(torch, card, tmp, ba_problems, pano2, seam_graph):
    """The multi-device layer (simplepanorama_tpu_torch/parallel/) at
    world 1 over NCCL on cuda:0, in this process (a FileStore in ``tmp``),
    at full width:
      * parallel.dist_ba.lm_run_sharded, the path: each trial one CUDA
        graph holding its two NCCL all-reduces (ba.LMProgram with the
        mesh's group), on each of ``ba_problems`` {name: (cams, data,
        active, fast, lambda)} (the BA problems of slices 1 and 3 as
        _slice3_ba_problem builds them, started from _perturbed cameras,
        50 trials at most), against the same sharded LM run eagerly
        (fused=False) and the single-card eager run (ba.lm_run_eager):
        trials, accepted steps, error and every camera tensor equal bit
        for bit (an all-reduce over one rank is the identity), and the
        single-card graph (ba.LMProgram without a group: kernels 4, 3
        and 5, whose LU parts from cuSOLVER's once lambda is small),
        which must end below its start's error; kernel 3 launched once
        per trial executed in each; one line a problem, with each run's
        wall, capture seconds, trials executed and host reads;
      * tiled_compose.multi_blend_sharded against blending.multi_blend on
        slice 2's blocks (``pano2``): within 0.05 on the 0..255 scale;
      * render/fullres.render_full_dev through the image-split schedule
        (fullres_multi_dp) and the canvas-split one
        (fullres_multi_canvas) against the single-device render:
        image-split within 1 level on >= 99.9% of pixels, canvas-split
        beyond 2 levels on < 1% of pixels (tests/test_tiled.py's bound),
        both NCC >= 0.999;
      * dist_mincut.grid_mincut_sharded on ``seam_graph`` (slice 1's first
        seam graph) against grid_mincut_ref on the card (the same side,
        bit for bit) and kernel 1 (cut values within 1e-3 relative).
    Prints one line per check with its wall; raises on any failure; the
    process group is destroyed before it returns. Returns the launches
    of the path's own calls (not of the single-card or checking calls)
    as {"assemble_streams": kernel 3's in the graphed sharded LM runs
    (the replays), counted around each, "mincut": (kernel 1's, kernel 2's) from the start of
    the phase to the end of the sharded min-cut, before kernel 1's
    checking call; the single-card calls in between launch no
    min-cut}."""
    import torch.distributed as dist
    from simplepanorama_tpu_torch import ba
    from simplepanorama_tpu_torch.ops import ba_kernel, maxflow
    from simplepanorama_tpu_torch.parallel import dist_mincut
    from simplepanorama_tpu_torch.parallel import tiled_compose as tc
    from simplepanorama_tpu_torch.parallel.dist_ba import lm_run_sharded
    from simplepanorama_tpu_torch.parallel.mesh import make_mesh
    from simplepanorama_tpu_torch.render.blending import multi_blend
    from simplepanorama_tpu_torch.render.fullres import render_full_dev
    torch.cuda.set_device(0)
    store = dist.FileStore(os.path.join(tmp, "nccl_store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    launches = 0
    _reset_launches(maxflow)
    try:
        t0 = time.perf_counter()
        mesh = make_mesh()
        _line("dist", check="init", backend=dist.get_backend(),
              world=mesh.size, device_of_rank=str(mesh.device),
              wall_s=time.perf_counter() - t0, device=card)

        # ---- the match-sharded BA: as one CUDA graph with its
        # all-reduces (the path), eagerly, and the single-card runs ----
        for name, (cams, data, active, fast, lam) in ba_problems.items():
            M, n_cams = data.mi.shape[0], cams.focal.shape[0]
            ws = ba_kernel.workspace(M, n_cams, "cuda")
            cams0 = _perturbed(torch, cams, active)
            runs = {}

            def single_graph():
                # the trial captured as ba.lm_trial, the sharded program's
                program = _lm_trial_program(data, n_cams, fast)
                try:
                    out = program.run(cams0, active, lam)
                finally:
                    program.close()
                return out, program.capture_s

            def sharded(fused):
                out = lm_run_sharded(cams0, data, active, lam, mesh,
                                     fast=fast, ws=ws, with_counts=True,
                                     fused=fused)
                return out, lm_run_sharded.last_stats["capture_s"]

            for run, fn in (
                    ("graph_sharded", lambda: sharded(True)),
                    ("eager_sharded", lambda: sharded(False)),
                    ("graph_single", single_graph),
                    ("eager_single", lambda: (ba.lm_run_eager(
                        cams0, data, active, lam, fast=fast, ws=ws), 0.0))):
                torch.cuda.synchronize()
                ba_kernel.assemble_streams.launches = 0
                _trial_launches(reset=True)
                t0 = time.perf_counter()
                (res, executed, reads), capture_s = fn()
                torch.cuda.synchronize()
                runs[run] = dict(
                    res=res, wall_s=time.perf_counter() - t0,
                    capture_s=capture_s, trials=int(res.n_iter),
                    accepted=int(res.n_accepted), trials_executed=executed,
                    host_reads=reads,
                    assemble_streams_launches=(
                        ba_kernel.assemble_streams.launches))
                _check_trial_path(f"dist {name} {run}", _trial_launches(), 0)
            launches += runs["graph_sharded"]["assemble_streams_launches"]
            ref = runs["graph_sharded"]["res"]
            equal = {run: bool(
                all(torch.equal(a, b) for a, b in zip(ref.cams, r["res"].cams))
                and torch.equal(ref.error, r["res"].error))
                for run, r in runs.items() if run != "graph_sharded"}
            trials = runs["graph_sharded"]["trials"]
            _line("dist", check="lm_run_sharded", problem=name, fast=fast,
                  tolerance="the graphed sharded LM equal, bit for bit, to "
                  "the eager sharded and the single-card graph (its trial "
                  "captured as ba.lm_trial) and eager runs in trials, "
                  "accepted steps, cameras and error; kernel 3 once per "
                  "trial executed in each, kernels 4 and 5 never",
                  matches=M, n_cams=n_cams, equal_bits=equal,
                  ms_per_trial_executed={
                      run: 1e3 * (r["wall_s"] - r["capture_s"])
                      / r["trials_executed"] for run, r in runs.items()},
                  runs={run: {k: v for k, v in r.items() if k != "res"}
                        for run, r in runs.items()}, device=card)
            if not (all(equal.values()) and trials >= 8
                    and all(r["trials"] == trials
                            and r["accepted"]
                            == runs["graph_sharded"]["accepted"]
                            and r["assemble_streams_launches"]
                            == r["trials_executed"] for r in runs.values())
                    and runs["graph_sharded"]["capture_s"] > 0):
                raise RuntimeError(f"dist: the sharded LM on {name} differs "
                                   "between its graphed, eager and "
                                   "single-card runs at world 1")

        # ---- the sharded multiband blend on slice 2's blocks ----
        st = pano2.stitch_params.state
        cfg2 = pano2.config
        imgs = st.imgs / torch.as_tensor(
            pano2.stitch_params.gains, dtype=torch.float32,
            device="cuda")[:, None, None, None]
        from simplepanorama_tpu_torch.render.compose import \
            apply_intensity_dev
        imgs = apply_intensity_dev(imgs, st.intensity)
        args = (imgs, st.seam_masks.float(), st.masks.float(), st.offs,
                st.canvas_hw)
        kw = dict(bands=cfg2.bands, sigma=float(cfg2.sigma_blend))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = multi_blend(*args, **kw)
        torch.cuda.synchronize()
        wall_1 = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = tc.multi_blend_sharded(*args, mesh, **kw)
        torch.cuda.synchronize()
        wall_m = time.perf_counter() - t0
        err = float((got - want).abs().max())
        _line("dist", check="multi_blend_sharded",
              blocks=list(st.imgs.shape[:3]), canvas=list(st.canvas_hw),
              max_abs_err=err, tolerance=0.05, single_wall_s=wall_1,
              sharded_wall_s=wall_m, device=card)
        if not err <= 0.05:
            raise RuntimeError(f"dist: multi_blend_sharded off by {err}")
        del got, want, imgs, args

        # ---- the full-res schedules against the single-device render ----
        full_imgs = pano2.images.load_connected_images(
            [True] * len(pano2.images.loaded), cfg2.threads)
        full_imgs = [full_imgs[g] for g in pano2.result.nodes]
        walls = {}
        outs = {}
        for sched in (None, "dp", "canvas"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            outs[sched] = render_full_dev(
                pano2.stitch_params, cfg2, full_imgs,
                mesh=None if sched is None else mesh, schedule=sched)
            torch.cuda.synchronize()
            walls[sched] = (time.perf_counter() - t0,
                            torch.cuda.max_memory_allocated())
        ref = outs[None].astype(np.int32)
        for sched in ("dp", "canvas"):
            diff = np.abs(outs[sched].astype(np.int32) - ref)
            ncc = _ncc(outs[sched], outs[None])
            within1 = float((diff <= 1).mean())
            over2 = float((diff > 2).mean())
            _line("dist", check="fullres_multi_" + sched,
                  tolerance=("within 1 level on >= 99.9% of pixels"
                             if sched == "dp" else
                             "over 2 levels on < 1% of pixels")
                  + ", NCC >= 0.999",
                  shape=list(outs[sched].shape), max_level_diff=int(
                      diff.max()), share_within_1=within1,
                  share_over_2=over2, ncc=ncc, wall_s=walls[sched][0],
                  peak_memory=walls[sched][1], single_wall_s=walls[None][0],
                  single_peak_memory=walls[None][1], device=card)
            ok = (within1 >= 0.999) if sched == "dp" else (over2 < 0.01)
            if outs[sched].shape != ref.shape or not ok or ncc < 0.999:
                raise RuntimeError(f"dist: fullres_multi_{sched} disagrees "
                                   "with the single-device render")
        del outs, ref, full_imgs

        # ---- the column-sharded min-cut against the plain solver and
        # kernel 1 ----
        host = [t.cpu().numpy() for t in seam_graph]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        side_s = dist_mincut.grid_mincut_sharded(*seam_graph, mesh)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches_mc = _launches(maxflow)
        t0 = time.perf_counter()
        side_r = maxflow.grid_mincut_ref(*seam_graph)
        torch.cuda.synchronize()
        wall_r = time.perf_counter() - t0
        side_k = maxflow.grid_mincut(*seam_graph)
        same = bool(torch.equal(side_s, side_r))
        v_s = maxflow.cut_value(*host, side_s.cpu().numpy())
        v_k = maxflow.cut_value(*host, side_k.cpu().numpy())
        _line("dist", check="grid_mincut_sharded",
              tolerance="side equal to grid_mincut_ref's bit for bit, cut "
              "within 1e-3 relative of kernel 1's",
              shape=list(seam_graph[0].shape),
              nodes=int(host[3].sum()), equal_to_plain_bits=same,
              cut_sharded=v_s, cut_kernel1=v_k, sharded_wall_s=wall_s,
              plain_wall_s=wall_r, dist_mincut_launches=list(launches_mc),
              device=card)
        if not same or abs(v_s - v_k) > 1e-3 * max(1.0, abs(v_k)):
            raise RuntimeError("dist: grid_mincut_sharded disagrees with "
                               f"grid_mincut_ref ({same}) or kernel 1 "
                               f"({v_s} vs {v_k})")
    finally:
        dist.destroy_process_group()
    return {"assemble_streams": launches, "mincut": launches_mc}


def _ba_cache_phase(torch, card, ba_problems):
    """The process's program cache (ba.program) across two BA problems:
    ``ba_problems`` {name: (cams, data, active, fast, lambda)} (the BA
    problems of slices 1 and 3, as the dist phase takes them), padded to
    common shapes (invalid match slots, pair rows of camera 0), so that
    one kept program serves both. For each objective: the kept program
    on problem A, then B, then A, each run from _perturbed cameras;
    every run equal bit for bit to a fresh LMProgram's run of the same
    problem (trials, accepted steps, error and cameras), one capture in
    all, kernel 3 launched once per trial executed, and A's and B's runs
    not equal. Prints one line per objective; returns kernel 3's launches
    on the kept program."""
    from simplepanorama_tpu_torch import ba
    from simplepanorama_tpu_torch.ops import ba_kernel
    M = max(d.mi.shape[0] for _, d, _, _, _ in ba_problems.values())
    P = max(d.pi.shape[0] for _, d, _, _, _ in ba_problems.values())

    def pad(t, n):
        return torch.cat([t, t.new_zeros((n - t.shape[0], *t.shape[1:]))])
    padded = {}
    for name, (cams, data, active, _, lam) in ba_problems.items():
        data = ba.BAData(*(pad(t, P if k in ("pi", "pj") else M)
                           for k, t in data._asdict().items()))
        cams = _perturbed(torch, cams._replace(b=pad(cams.b, M)), active)
        padded[name] = (cams, data, active, lam)
    names = list(padded)
    launches = 0
    for fast in (False, True):
        ba.release_programs()
        runs, out, programs = [], {}, set()
        for name in (names[0], names[1], names[0]):
            cams, data, active, lam = padded[name]
            n_cams = cams.focal.shape[0]
            with ba.program(data, n_cams, fast) as prog:
                programs.add(id(prog))
                ba_kernel.assemble_streams.launches = 0
                _trial_launches(reset=True)
                got, executed, _ = prog.run(cams, active, lam)
                torch.cuda.synchronize()
            k3 = ba_kernel.assemble_streams.launches
            _check_trial_path(f"ba_cache fast={fast} {name}",
                              _trial_launches(), executed)
            launches += k3
            fresh = ba.LMProgram(data, n_cams, fast)
            try:
                want = fresh.run(cams, active, lam)[0]
            finally:
                fresh.close()
            same = bool(all(torch.equal(a, b) for a, b in
                            zip((*got.cams, got.error, got.n_iter,
                                 got.n_accepted),
                                (*want.cams, want.error, want.n_iter,
                                 want.n_accepted))))
            runs.append({"problem": name, "trials": int(got.n_iter),
                         "error": float(got.error), "trials_executed":
                         executed, "assemble_streams_launches": k3,
                         "equal_to_fresh_program_bits": same})
            if name in out and not torch.equal(out[name].error, got.error):
                same = runs[-1]["equal_to_fresh_program_bits"] = False
            out[name] = got
            if not same or k3 != executed:
                raise RuntimeError(f"ba_cache: the kept program on {name} "
                                   f"(fast={fast}) gave {runs[-1]}")
        a, b = (out[n] for n in names)
        differ = not torch.equal(a.cams.focal, b.cams.focal)
        _line("ba_cache", fast=fast, matches=M, pair_rows=P,
              programs=len(programs), kept=len(ba._PROGRAMS), runs=runs,
              problems_differ=differ, device=card)
        if len(programs) != 1 or not differ:
            raise RuntimeError(f"ba_cache: {len(programs)} programs for one "
                               f"key, problems differ: {differ}")
    ba.release_programs()
    return launches


def _hostcut_phase(torch, card, pano1):
    """render/graphcut.graph_cut, the per-image host loop, on slice 1's
    blocks on the card (the per-image crops of its state, the BA's
    insertion order): one kernel-1 launch per cut, 11 for 12 views, and
    seams equal to the device chain's (graph_cut_state, which set_config
    ran on the card) on >= 99.9% of pixels, as the JAX package's
    test_device_chain_matches_host_loop holds. Prints one line; returns
    the launches of kernels 1, 2 and 3 in graph_cut."""
    from simplepanorama_tpu_torch.ops import ba_kernel, maxflow
    from simplepanorama_tpu_torch.render import graphcut
    from simplepanorama_tpu_torch.render.blending import pad_stack
    params = pano1.stitch_params
    st = params.state
    seq = [n for n, _ in pano1.result.order]
    imgs_l, masks_l, corners_l = params._lists()
    _reset_launches(maxflow)
    ba_kernel.assemble_streams.launches = 0
    _trial_launches(reset=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seams_l = graphcut.graph_cut(imgs_l, masks_l, corners_l, seq)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches(maxflow)
    k3 = ba_kernel.assemble_streams.launches
    _check_trial_path("hostcut", _trial_launches(), 0)
    seams = pad_stack(seams_l, st.masks.shape[1:], "cuda") > 0
    agree = float((seams == st.seam_masks).float().mean())
    _line("hostcut", tolerance="one kernel-1 launch per cut, seams equal "
          "to the device chain's on >= 99.9% of pixels",
          views=len(seq), launches={
        "grid_mincut": launches[0], "grid_mincut_tiled": launches[1],
        "assemble_streams": k3},
          seam_agreement_with_device_chain=agree, wall_s=wall, device=card)
    if launches != (len(seq) - 1, 0) or agree < 0.999:
        raise RuntimeError(f"hostcut: launches {launches}, seam agreement "
                           f"{agree}")
    return launches + (k3,)


_TWO_CARD_WORKER = """
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import simplepanorama_tpu_torch as T
from simplepanorama_tpu_torch.parallel import multihost
from simplepanorama_tpu_torch.parallel.mesh import pipeline_mesh
multihost.initialize()
mesh = pipeline_mesh()
pano = T.Panorama(sys.argv[3:], device="cuda").stitch(
    T.Config(cut=True, init_size=1400, gain_compensation=True))
out = dict(connected=np.array(pano.connected), K=pano.result.K,
           preview=pano.get_preview(), full=pano.get_panorama(),
           world=np.array(mesh.size))
if mesh.rank == 0:
    np.savez(sys.argv[2], **out)
print("rank", mesh.rank, "ok", flush=True)
"""


def _two_card_phase(torch, card, tmp, paths, single):
    """With two or more cards: slice 2's stitch, preview and full-res in a
    world of 2 ranks over NCCL (parallel/launch.run_world, one process a
    card; the BA splits its matches over the ranks, each bucket's trial
    one CUDA graph holding its all-reduces) against the single-card run ``single`` = (connected, focals,
    preview, full): the same views connected, focals within 1e-3
    relative, preview and full-res NCC >= 0.99. With one card it prints
    why it was skipped."""
    n = torch.cuda.device_count()
    if n < 2:
        _line("two_card", skipped=True, cards=n,
              reason="one card: the 2-rank NCCL run needs two", device=card)
        return
    from simplepanorama_tpu_torch.parallel.launch import run_world
    here = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(tmp, "two_card_worker.py")
    with open(script, "w") as f:
        f.write(_TWO_CARD_WORKER)
    out_p = os.path.join(tmp, "two_card.npz")
    t0 = time.perf_counter()
    outs = run_world([script, here, out_p, *paths], 2, timeout_s=600)
    wall = time.perf_counter() - t0
    for rank, (rc, log) in enumerate(outs):
        if rc != 0:
            raise RuntimeError(f"two_card: rank {rank} failed:\n{log[-3000:]}")
    r = np.load(out_p)
    connected, focals, preview, full = single
    df = float(np.max(np.abs(r["K"][:, 0, 0] / focals - 1.0)))
    ok_shape = r["preview"].shape == preview.shape and \
        r["full"].shape == full.shape
    ncc_p = _ncc(r["preview"], preview) if ok_shape else None
    ncc_f = _ncc(r["full"], full) if ok_shape else None
    _line("two_card", world=int(r["world"]), connected=r["connected"].tolist(),
          focal_rel_diff=df, preview_ncc=ncc_p, full_ncc=ncc_f, wall_s=wall,
          device=card)
    if (tuple(r["connected"]) != tuple(connected) or df > 1e-3
            or not ok_shape or ncc_p < 0.99 or ncc_f < 0.99):
        raise RuntimeError("two_card: the 2-rank stitch disagrees with the "
                           "single-card one")


def _prefetch_oom_phase(torch, card, pano):
    """Slice 2's get_panorama() with the prefetch's upload out of device
    memory. First the peaks of the two routes: the chunked render
    (stitcher.render_full_from_imageset: its images decoded in the call)
    and the size of the packed source stack the prefetch uploads. A cap
    (torch.cuda.set_per_process_memory_fraction) would fail the upload
    and let the chunked render run only if the stack were larger than
    the render's own peak above what the card held before it; where it
    is not, the upload is made to raise torch.OutOfMemoryError
    (fullres.prefetch_sources replaced), as the line says. Then the
    prefetch as stitch() starts it, and get_panorama(). Gates: the
    panorama equals the synchronous render bit for bit, the thread
    decoded the images once, prefetch_stats["upload_oom"] is true, and
    the render ran on the card (its peak above the memory held before
    it). Prints one line."""
    from simplepanorama_tpu_torch import io as tio
    from simplepanorama_tpu_torch import stitcher
    from simplepanorama_tpu_torch.render import fullres
    params, cfg = pano.stitch_params, pano.config
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    want = stitcher.render_full_from_imageset(params, cfg, pano.images)
    torch.cuda.synchronize()
    sync_wall = time.perf_counter() - t0
    sync_peak = torch.cuda.max_memory_allocated() - base
    decodes = []
    load = tio.ImageSet.load_connected_images
    prefetch = fullres.prefetch_sources
    stack_bytes = []

    def counted(self, *a, **kw):
        decodes.append(threading.current_thread().name)
        return load(self, *a, **kw)

    def out_of_memory(params, full_images):
        sel_, (Hs, Ws) = fullres._selected(params, full_images)
        stack_bytes.append(len(sel_) * Hs * Ws * 3)
        raise torch.OutOfMemoryError(
            "CUDA out of memory (raised by chip_smoke's prefetch_oom phase)")
    tio.ImageSet.load_connected_images = counted
    fullres.prefetch_sources = out_of_memory
    try:
        pano._full_pano = None
        pano._start_full_prefetch()          # as stitch() starts it
        pano.get_preview()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = pano.get_panorama()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
    finally:
        tio.ImageSet.load_connected_images = load
        fullres.prefetch_sources = prefetch
    cap_fits = bool(stack_bytes and stack_bytes[0] > sync_peak)
    stats = dict(pano.prefetch_stats)
    same = bool(np.array_equal(got, want))
    _line("prefetch_oom", forced="fullres.prefetch_sources raised "
          "torch.OutOfMemoryError" + ("" if cap_fits else
                                      ": no cap fails the stack's upload "
                                      "and lets the chunked render run, "
                                      "the stack being smaller than the "
                                      "render's peak"),
          stack_bytes=stack_bytes[0] if stack_bytes else None,
          chunked_render_peak_bytes=sync_peak, a_cap_would_fit=cap_fits,
          synchronous_wall_s=sync_wall, full_wall_s=wall,
          fallback_render_peak_bytes=peak, prefetch=stats,
          decodes=len(decodes), equal_to_synchronous_bits=same,
          full_shape=list(got.shape), device=card)
    if not (same and stats.get("upload_oom") is True and len(decodes) == 1
            and pano.device.type == "cuda" and peak > 0):
        raise RuntimeError(f"prefetch_oom: equal bits {same}, stats {stats}, "
                           f"{len(decodes)} decodes, render peak {peak} "
                           f"bytes on {pano.device}")
    del want, got


def _thread_counts(stitch):
    """stitch._lm_chunk wrapped to count, per thread, what the chunks ran:
    trials executed, those through kernels 4 and 5, LM trials, graphs
    captured and their seconds, the
    last run's error and the program keys (n_cams, M, P). Returns
    (wrapper, take): take() pops the calling thread's counts."""
    lock = threading.Lock()
    counts = {}
    chunk = stitch._lm_chunk

    def counted(cams, active, data, *a, **kw):
        out, c = chunk(cams, active, data, *a, **kw)
        key = (int(cams.focal.shape[0]), int(data.mi.shape[0]),
               int(data.pi.shape[0]))
        trials, error = int(c.trials), float(c.error)
        with lock:
            d = counts.setdefault(threading.get_ident(), {
                "trials_executed": 0, "fused_trials": 0, "lm_trials": 0,
                "graphs": 0, "capture_s": 0.0, "keys": []})
            d["trials_executed"] += c.executed
            d["fused_trials"] += c.fused
            d["lm_trials"] += trials
            d["graphs"] += c.graphs
            d["capture_s"] += c.capture_s
            d["lm_error"] = error
            if key not in d["keys"]:
                d["keys"].append(key)
        return out, c

    def take():
        with lock:
            return counts.pop(threading.get_ident(), None)
    return counted, take


def _threads_phase(torch, card, problems, loops):
    """Two stitches at once in two threads of this process, sharing kept
    BA programs (ba.program). First the BA problems of slices 1 and
    3 (``problems``) through stitch.bundle_adjust_stitching, both under
    slice 1's config (relaxed) so that their schedules share capacity
    buckets: each alone, then both at once, three times (the first after
    ba.release_programs(), so its captures run beside the other thread's
    work; the others replay). Then two Panorama(...).stitch(Config())
    .get_preview() of two loops of 700-px working size (``loops``: the
    views of slices 1 and 3), each alone, then both at once after
    ba.release_programs(). Gates: every concurrent result equals its
    single-thread run bit for bit (cameras and the last LM error; the
    preview's bytes for the Panoramas), no capture fails, the two
    threads' program keys intersect, a cold round captures one graph a
    key (the union of the two threads' keys) and a warm round none, and
    kernel 3 launches once per trial executed in both threads. Prints
    one line per round; returns kernel 3's launches in the concurrent
    rounds."""
    from concurrent.futures import ThreadPoolExecutor
    from simplepanorama_tpu_torch import Config, Panorama, ba, stitch
    from simplepanorama_tpu_torch.ops import ba_kernel
    counted, take = _thread_counts(stitch)
    cfg = problems["slice1_relaxed"][4]
    names = ("slice1_relaxed", "slice3_lowe")

    def ba_run(name, meet=None):
        comp, adjres, sizes, focal, _ = problems[name]
        take()
        if meet is not None:
            meet.wait()
        res = stitch.bundle_adjust_stitching(comp, adjres, sizes, focal, cfg,
                                             device="cuda")
        c = take()
        return (res.K, res.rot, c["lm_error"]), c

    def pano_run(paths, meet=None):
        take()
        if meet is not None:
            meet.wait()
        p = Panorama(paths, device="cuda").stitch(Config())
        preview = p.get_preview()
        p._stop_full_prefetch()
        c = take()
        return (p.result.K, p.result.rot, c["lm_error"],
                preview.tobytes()), c

    def same(a, b):
        return all(np.array_equal(x, y) if isinstance(x, np.ndarray)
                   else x == y for x, y in zip(a, b))

    launches = 0
    chunk = stitch._lm_chunk
    stitch._lm_chunk = counted
    try:
        for part, run, inputs, rounds in (
                ("bundle_adjust", ba_run, names, 3),
                ("panorama", pano_run, tuple(
                    sorted(os.path.join(d, f) for f in os.listdir(d))
                    for d in loops), 1)):
            alone, alone_wall = [], []
            for x in inputs:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                alone.append(run(x))
                torch.cuda.synchronize()
                alone_wall.append(time.perf_counter() - t0)
            keys = [set(c["keys"]) for _, c in alone]
            shared = sorted(keys[0] & keys[1])
            for r in range(rounds):
                cold = r == 0
                if cold:
                    ba.release_programs()
                meet = threading.Barrier(2, timeout=60)
                ba_kernel.assemble_streams.launches = 0
                _trial_launches(reset=True)
                t0 = time.perf_counter()
                with ThreadPoolExecutor(2) as ex:
                    futs = [ex.submit(run, x, meet) for x in inputs]
                    both = [f.result(timeout=600) for f in futs]
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                k3 = ba_kernel.assemble_streams.launches
                launches += k3
                executed = sum(c["trials_executed"] for _, c in both)
                _check_trial_path(f"threads {part} round {r + 1}",
                                  _trial_launches(), executed,
                                  sum(c["fused_trials"] for _, c in both))
                graphs = sum(c["graphs"] for _, c in both)
                equal = [same(b[0], a[0]) for a, b in zip(alone, both)]
                want_graphs = len(keys[0] | keys[1]) if cold else 0
                _line("threads", part=part, round=r + 1, cold=cold,
                      equal_to_alone_bits=equal, shared_keys=shared,
                      keys=[sorted(k) for k in keys], graphs=graphs,
                      capture_s=[c["capture_s"] for _, c in both],
                      trials_executed=[c["trials_executed"]
                                       for _, c in both],
                      lm_trials=[c["lm_trials"] for _, c in both],
                      assemble_streams_launches=k3, wall_s=wall,
                      alone_wall_s=alone_wall,
                      alone_lm_error=[a[0][2] for a in alone],
                      device=card)
                if not all(equal) or not shared or graphs != want_graphs \
                        or k3 != executed or min(
                            c["lm_trials"] for _, c in both) < 1:
                    raise RuntimeError(
                        f"threads {part} round {r + 1}: equal {equal}, "
                        f"shared keys {shared}, {graphs} graphs (wanted "
                        f"{want_graphs}), kernel 3 {k3} for {executed} "
                        "trials executed")
    finally:
        stitch._lm_chunk = chunk
    return launches


def _fresh_phase(torch, card, views3, loop700, tmp):
    """What a fresh process pays, in processes of their own (fresh_trace.py;
    the kernels built earlier in this run, nothing else on disk cleared):
    the CLI as a user runs it on slice 3's 1400-px views (python -X
    importtime -m simplepanorama_tpu_torch.cli DIR --fast --timing
    --save-state S -o P), twice in turn, each process's wall from launch
    to exit, its imports and its --timing stage walls; then two cut=True
    stitches of slice 1's 700-px views in turn in one fresh process, with
    SPT_SYNC_STAGES=1. Gates: the two CLI processes' preview files equal
    byte for byte; the second stitch captures no graph; both stitches
    give equal cameras and preview bytes; kernel 1 launches 11 times a
    stitch and kernel 3 once per trial executed; neither CLI process
    (its -X importtime report) nor the fresh process's first stitch
    imported torch._dynamo (the BA's pair Jacobian is written out, no
    forward-mode AD; fresh_trace.py names the importer if one does).
    Prints one line per
    process and one per stitch; returns the stitches' launches of
    kernels 1 and 3. A line first says whether Python may write bytecode
    and whether torch's is cached."""
    import importlib.util
    import fresh_trace
    here = os.path.dirname(os.path.abspath(__file__))
    # whether Python may cache torch's bytecode here: without a cache, a
    # fresh process compiles torch's modules from source
    torch_pyc = importlib.util.cache_from_source(
        importlib.util.find_spec("torch").origin)
    _line("fresh", command="python",
          dont_write_bytecode=sys.dont_write_bytecode,
          torch_bytecode_cached=os.path.exists(torch_pyc), device=card)
    cli = []
    for run in (1, 2):
        cli.append(fresh_trace.run_cli(here, views3, tmp, f"fresh{run}"))
        _line("fresh", command="cli --fast --timing --save-state", run=run,
              **cli[-1], device=card)
    if cli[0]["preview_file"] != cli[1]["preview_file"]:
        raise RuntimeError("fresh: two CLI processes wrote different "
                           "previews")
    if any(c["dynamo_imported"] for c in cli):
        raise RuntimeError("fresh: a CLI process imported torch._dynamo")
    wall, imports, (first, second) = fresh_trace.run_stitches(here, loop700)
    for row in (first, second):
        _line("fresh", command="fresh_trace.py (two cut=True stitches)",
              **row, **imports, process_wall_s=wall, device=card)
    ok = (first["dynamo_imported"] is False
          and second["lm"]["graphs"] == 0
          and first["cameras"] == second["cameras"]
          and first["preview"] == second["preview"]
          and all(r["launches"]["grid_mincut"] == 11
                  and r["launches"]["assemble_streams"]
                  == r["launches"]["trial_streams"]
                  == r["launches"]["solve_accept"] == r["lm"]["fused"]
                  == r["lm"]["executed"] for r in (first, second)))
    for k, row in enumerate((first, second)):
        _TRIAL_PATHS[f"fresh stitch {k + 1}"] = (
            row["launches"]["trial_streams"],
            row["launches"]["solve_accept"], row["lm"]["executed"])
    if not ok:
        raise RuntimeError(f"fresh: the first and second stitch of a fresh "
                           f"process: {first} / {second}")
    return tuple(sum(r["launches"][k] for r in (first, second))
                 for k in ("grid_mincut", "assemble_streams"))


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "simplepanorama_tpu_torch")):
        # run alone, without the program beside it: nothing to smoke
        raise SystemExit("chip_smoke: simplepanorama_tpu_torch/ is not "
                         f"beside {os.path.abspath(__file__)}; run this "
                         "script from the root of a checkout of the "
                         "repository")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs a CUDA GPU")
    import cv2
    from simplepanorama_tpu_torch import Config, Panorama, cli, stitcher
    from simplepanorama_tpu_torch import ba, stitch as tstitch
    from simplepanorama_tpu_torch.fixtures import (cut_grid, fkh360_views,
                                                   maze_grid)
    from simplepanorama_tpu_torch.ops import ba_kernel, ba_trial, maxflow
    from simplepanorama_tpu_torch.utils.checkpoint import load_stitch_state
    from simplepanorama_tpu_torch.pipeline import full_precision
    from simplepanorama_tpu_torch.utils.timing import global_timer

    full_precision()
    smi = _nvidia_smi()
    print(smi, flush=True)
    card = torch.cuda.get_device_name(0)
    _line("env", nvidia_smi=smi, torch=torch.__version__,
          cuda=torch.version.cuda, nvcc=_nvcc_version(), device=card)

    # the four sources compiled at once, one nvcc each
    from concurrent.futures import ThreadPoolExecutor
    sources = {k: "simplepanorama_tpu_torch/csrc/" + maxflow._KERNELS[k][1]
               for k in ("grid_mincut", "grid_mincut_tiled")}
    sources["assemble_streams"] = \
        "simplepanorama_tpu_torch/csrc/ba_assemble.cu"
    sources["trial"] = "simplepanorama_tpu_torch/csrc/ba_trial.cu"
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as ex:
        futs = {k: ex.submit(maxflow.build, k, True)
                for k in ("grid_mincut", "grid_mincut_tiled")}
        futs["assemble_streams"] = ex.submit(ba_kernel.build, True)
        futs["trial"] = ex.submit(ba_trial.build, True)
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
        # the plain version at the seam block is timed on its one
        # checking run, as kernel 2's is (five repeats took 14 s)
        for name, graph, plain_reps in (
                ("grid48x160", grid, 5),
                ("seam700", _seam_graph(torch, tmp, 700), 0)):
            err, ms_k, ms_r, stats, _ = _solve_pair(
                torch, maxflow, name, graph, maxflow.grid_mincut,
                maxflow.grid_mincut_ref, 5, plain_reps, card, "kernel")
            errs1.append(err)
        # the seam graph's times and bound, beside those of slice 2's
        # crops (added there)
        timing1 = (ms_k, ms_r, _mincut_bound(graph[3], stats))
        timings1 = {"seam700_640x640": timing1}
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
            err, ms_k, ms_r, stats, plain_side = _solve_pair(
                torch, maxflow, name, graph, maxflow.grid_mincut_tiled,
                maxflow.grid_mincut_tiled_ref, 3, plain_reps, card,
                "kernel2", tile_rows=tile_rows)
            errs2.append(err)
        timing2 = (ms_k, ms_r, _mincut_bound(graph[3], stats))
        # kernel 1 at seam1400 takes kernel 2's tiled route (its tiles do
        # not fit), so this line is the crossover, not a second solver
        _kernel_pair(torch, maxflow, "seam1400", seam, 3, card, "kernel2")
        # the seam dispatch at slice 2's block shape: a one-sided overlap
        # band, solved on its node box, against the uncropped kernel 2 in
        # turns; then the middle of three views against both neighbours,
        # a box over 0.9 of the grid, so grid_mincut_auto sends it whole
        # to kernel 2 (its first solve is a path of kernel 2: counts set
        # to 0 before it and read after)
        crop = _auto_pair(torch, maxflow, "seam1400_crop", seam, 4, card,
                          plain_side=plain_side)
        if crop["box_share"] is None or crop["box_share"] > 0.9:
            raise RuntimeError(f"seam1400_crop: node box {crop['box']} is "
                               "not at most 0.9 of the grid")
        closing = _cut_graph(torch, _views_state(torch, tmp, 1400, 3),
                             (0, 2), 1)
        if closing[0].numel() <= maxflow.WHOLE_GRID_MAX_CELLS:
            raise RuntimeError(f"seam1400_closing block "
                               f"{tuple(closing[0].shape)} is not over 1.2M "
                               "cells")
        _reset_launches(maxflow)
        closing_out = _auto_pair(torch, maxflow, "seam1400_closing",
                                 closing, 2, card, plain=True)
        launches_closing = closing_out["launches"]
        if (closing_out["box_share"] or 1.0) <= 0.9 or \
                launches_closing != [0, 1]:
            raise RuntimeError(f"seam1400_closing: box {closing_out['box']}"
                               f", launches {launches_closing}: wanted a "
                               "box over 0.9 of the grid and one kernel-2 "
                               "launch")
        del seam, closing, plain_side

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
        ba_kernel.assemble_streams.launches = 0
        _trial_launches(reset=True)
        problems = {}    # the BA problems the ba phase runs again
        bundle_adjust = tstitch.bundle_adjust_stitching

        def recording(name):
            def run(comp, adjres, sizes, focal, cfg, *a, **kw):
                problems[name] = (comp, adjres, sizes, focal, cfg)
                return bundle_adjust(comp, adjres, sizes, focal, cfg, *a,
                                     **kw)
            return run
        t0 = time.perf_counter()
        tstitch.bundle_adjust_stitching = recording("slice1_relaxed")
        try:
            with _count_lm(tstitch) as lm1:
                pano = Panorama(paths, device="cuda").stitch(
                    Config(cut=True))
        finally:
            tstitch.bundle_adjust_stitching = bundle_adjust
        preview = pano.get_preview()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches1 = _launches(maxflow)
        launches1_k3 = ba_kernel.assemble_streams.launches
        k45_1 = _trial_launches()
        focals = pano.result.K[:, 0, 0]
        cov = _coverage(preview)
        _line("slice", connected=list(pano.connected),
              launches={"grid_mincut": launches1[0],
                        "grid_mincut_tiled": launches1[1]},
              focal_true=f_true, focals=[float(x) for x in focals],
              blocks=list(pano.stitch_params.state.masks.shape),
              preview_shape=list(preview.shape), coverage=cov, wall_s=wall,
              stages_s=dict(timer.durations), **lm1,
              assemble_streams_launches=launches1_k3, device=card)
        if tuple(pano.connected) != (12, 12):
            raise RuntimeError(f"slice connected {pano.connected}")
        _check_kernel3_path("slice", launches1_k3, lm1, k45_1)
        if launches1[0] < 11:
            raise RuntimeError(f"only {launches1[0]} kernel-1 launches")
        if np.max(np.abs(focals / f_true - 1.0)) > 0.02:
            raise RuntimeError(f"focals {focals} vs true {f_true}")
        if not np.isfinite(preview).all() or cov <= 0.9:
            raise RuntimeError(f"preview coverage {cov}")
        pano1 = pano     # for the dist and hostcut phases
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
        ba_kernel.assemble_streams.launches = 0
        _trial_launches(reset=True)
        t0 = time.perf_counter()
        with _count_lm(tstitch) as lm2, _cut_log(torch, maxflow) as log2:
            pano = Panorama(paths, device="cuda").stitch(
                Config(cut=True, init_size=1400, gain_compensation=True))
            preview = pano.get_preview()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches2 = _launches(maxflow)
        # each cut's node box, route and ms, each checked against the
        # crop rule
        cuts2 = _cut_table(torch, maxflow, "slice2", log2)
        launches2_k3 = ba_kernel.assemble_streams.launches
        k45_2 = _trial_launches()
        # get_panorama joins the prefetch that stitch() started (the
        # full-res decode and upload ran under get_preview) and renders
        t0 = time.perf_counter()
        full = pano.get_panorama()
        torch.cuda.synchronize()
        full_wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        stages2 = dict(timer.durations)
        prefetch2 = dict(pano.prefetch_stats)
        # the same render through the synchronous path (the images
        # decoded on get_panorama's critical path) and through a fresh
        # prefetch under a second preview, in turns, with the bits held
        full_turns = {"prefetched": [full_wall], "synchronous": []}
        same_bits = []
        for turn in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = stitcher.render_full_from_imageset(
                pano.stitch_params, pano.config, pano.images)
            torch.cuda.synchronize()
            full_turns["synchronous"].append(time.perf_counter() - t0)
            same_bits.append(bool(np.array_equal(out, full)))
            if turn == 0:
                pano._start_full_prefetch()      # as stitch() starts it
                pano.get_preview()
                pano._full_pano = None
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = pano.get_panorama()
                torch.cuda.synchronize()
                full_turns["prefetched"].append(time.perf_counter() - t0)
                full_turns["prefetch_2"] = dict(pano.prefetch_stats)
                same_bits.append(bool(np.array_equal(out, full)))
        del out
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
              full_wall_s=full_wall, prefetch=prefetch2,
              full_turns_s=full_turns,
              prefetched_equals_synchronous_bits=all(same_bits),
              stages_s=stages2, cuts=cuts2,
              max_memory_allocated=peak, **lm2,
              assemble_streams_launches=launches2_k3, device=card)
        if tuple(pano.connected) != (12, 12):
            raise RuntimeError(f"slice2 connected {pano.connected}")
        _check_kernel3_path("slice2", launches2_k3, lm2, k45_2)
        if np.max(np.abs(focals / f_true - 1.0)) > 0.02:
            raise RuntimeError(f"slice2 focals {focals} vs true {f_true}")
        if blocks[1] * blocks[2] <= maxflow.WHOLE_GRID_MAX_CELLS:
            raise RuntimeError(f"slice2 blocks {blocks} not over 1.2M cells")
        if launches2[0] + launches2[1] != 11 or len(cuts2) != 11:
            raise RuntimeError(f"slice2 launches {launches2} in "
                               f"{len(cuts2)} cuts: wanted 11 cuts, one "
                               "launch of kernel 1 or 2 each")
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
        if not all(same_bits) or not prefetch2.get("decode_s"):
            raise RuntimeError(f"slice2: the prefetched full-res render "
                               f"({prefetch2}) differs from the "
                               f"synchronous one: {same_bits}")
        # kernel 1 against its plain version on the crops it was handed
        # above (after the launches were read): the first cut of each of
        # its routes; the resident crop's times and bound are kernel 1's
        # in the kernels line
        crops2 = _check_crops(torch, maxflow, "slice2", log2, card)
        del log2
        if "kernel1_resident" not in crops2:
            raise RuntimeError("slice2: no cut kept kernel 1's tiles "
                               f"resident ({[c['route'] for c in cuts2]})")
        for label, err, ms_k, ms_r, bound in crops2.values():
            errs1.append(err)
            timings1[label] = (ms_k, ms_r, bound)
        timing1 = timings1[crops2["kernel1_resident"][0]]
        # ---- the same get_panorama() with the prefetch's upload out of
        # device memory: the chunked route on the same card ----
        _prefetch_oom_phase(torch, card, pano)
        pano2 = pano     # for the dist phase
        slice2_single = (tuple(pano.connected), focals, preview, full)
        paths2 = list(paths)
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
        runs = {}
        stitched = {}    # run -> (cameras K, rotations, preview bytes)
        tstitch.bundle_adjust_stitching = recording("slice3_lowe")
        try:
            for run in ("cold", "warm"):
                with _count_lm(tstitch) as lm3:
                    runs["stitch_" + run] = _cli_run(
                        torch, cli, timer, maxflow, ba_kernel, [
                            views3, "--fast", "--timing", "--save-state",
                            state, "-o", prev_p])
                runs["stitch_" + run].update(lm3)
                saved = load_stitch_state(state)
                with open(prev_p, "rb") as fh:
                    stitched[run] = (np.asarray(saved.K),
                                     np.asarray(saved.rot), fh.read())
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
        # the warm stitch replays the programs the cold one captured
        warm_same = {
            "cameras_bits": bool(
                np.array_equal(stitched["cold"][0], stitched["warm"][0])
                and np.array_equal(stitched["cold"][1],
                                   stitched["warm"][1])),
            "preview_bytes": stitched["cold"][2] == stitched["warm"][2]}
        _line("slice3", connected=list(connected3), focal_true=f_true,
              focals=[float(x) for x in focals], focal_gate=focal_gate,
              preview_shape=list(preview.shape), coverage=cov,
              full_shape=list(full.shape), full_vs_preview_ncc=ncc_full,
              warm_equals_cold=warm_same,
              graphs={r: runs["stitch_" + r]["graphs"]
                      for r in ("cold", "warm")},
              capture_s={r: runs["stitch_" + r]["capture_s"]
                         for r in ("cold", "warm")},
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
        if runs["stitch_cold"]["graphs"] < 1 or \
                runs["stitch_warm"]["graphs"] != 0 or \
                runs["stitch_warm"]["capture_s"] != 0.0 or \
                not all(warm_same.values()):
            raise RuntimeError(
                "slice3: the warm stitch captured "
                f"{runs['stitch_warm']['graphs']} graphs in "
                f"{runs['stitch_warm']['capture_s']} s (the cold one "
                f"{runs['stitch_cold']['graphs']}), equal to the cold "
                f"stitch: {warm_same}")
        for run in ("cold", "warm"):
            _check_kernel3_path("slice3 " + run, runs["stitch_" + run][
                "assemble_streams_launches"], runs["stitch_" + run],
                runs["stitch_" + run]["trial_launches"])
            if runs["full_" + run]["assemble_streams_launches"] or any(
                    runs["full_" + run]["trial_launches"]):
                raise RuntimeError("slice3: the resumed full-res render "
                                   "launched kernel 3, 4 or 5")
        launches3_path = sum(r["assemble_streams_launches"]
                             for r in runs.values())
        os.environ.pop("SPT_SYNC_STAGES")

        # ---- kernel 3 on slice 3's own BA problem: the Lowe system and
        # the relaxed one (b = t), against the plain version and the
        # port's own assembly ----
        cams, data, active, active_m = _slice3_ba_problem(
            torch, *problems["slice3_lowe"][:2], res3)
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
            streams = ba.streams_from_problem(
                cams, data, active_m, lam, active, n_pad, fast)
            ms_streams = _time_ms(torch, ba.streams_from_problem, (
                cams, data, active_m, lam, active, n_pad, fast))
            cache, (S_ref, rhs_ref, _) = assembly()
            ms_dense = _time_ms(torch, assembly, ())
            sums, err, ms_k, ms_r, bound, n = _kernel3_pair(
                torch, ba_kernel, name, streams, n_pad, not fast, card,
                streams_ms=ms_streams, ba_assembly_ms=ms_dense,
                active_matches=int(active_m.sum()))
            probe3 += n
            errs3.append(err)
            S, rhs = ba._system(sums, cache.aug, lam, active, fast)
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
        if probe3 != 2:
            raise RuntimeError(f"kernel 3 launched {probe3} times checking "
                               "slice 3's BA problem, wanted 2")
        del preview, full, small, cams, data, streams, sums

        # ---- the multi-device layer at world 1 over NCCL, and the host
        # graph-cut loop on the card ----
        dist_problems = {}
        for name, res in (("slice1_relaxed", pano1.result),
                          ("slice3_lowe", res3)):
            comp, adjres, _, _, cfg_p = problems[name]
            cams, data, active, _ = _slice3_ba_problem(torch, comp, adjres,
                                                       res)
            dist_problems[name] = (cams, data, active, bool(cfg_p.fast),
                                   float(cfg_p.lambda_))
        seam1 = _first_cut_graph(torch, pano1.stitch_params.state,
                                 [n for n, _ in pano1.result.order])
        t0 = time.perf_counter()
        launches_dist = _dist_phase(torch, card, tmp, dist_problems, pano2,
                                    seam1)
        _line("dist", summary=True, wall_s=time.perf_counter() - t0,
              launches=launches_dist, device=card)
        launches_cache = _ba_cache_phase(torch, card, dist_problems)
        launches_hostcut = _hostcut_phase(torch, card, pano1)
        # ---- two stitches at once in two threads, and what a fresh
        # process pays ----
        launches_threads = _threads_phase(
            torch, card, problems, (os.path.join(tmp, "loop"), views3))
        launches_fresh = _fresh_phase(torch, card, views3,
                                      os.path.join(tmp, "loop"), tmp)
        del pano1, pano2, dist_problems, seam1
        _two_card_phase(torch, card, tmp, paths2, slice2_single)
        del slice2_single

        # ---- the bundle adjustment alone: slice 1's problem (relaxed)
        # and slice 3's (Lowe), eager trials against CUDA graphs ----
        ba_runs = _ba_phase(torch, problems, card)
        for r in ba_runs.values():
            errs3.append(r["largest"][1])
        timing3 = ba_runs["slice1_relaxed"]["largest"][2:5]
        trial = _trial_phase(torch, problems, card)

        launches5, err5, launches5_k3, res5 = _slice5(torch, paths, f_true,
                                                      tmp, card)
        errs1.append(err5)

        # ---- the compositing options on slice 3's loop ----
        launches_opt, launches_opt_k3 = _options_phase(torch, paths, f_true,
                                                       card, res5)
        del res5

        _stream_phase(torch, (("slice", os.path.join(tmp, "loop"), 700),
                              ("slice2", os.path.join(tmp, "loop2800"),
                               1400),
                              ("slice3", views3, 700)), card)

        # ---- SIFT chunks that halve under a memory cap ----
        _sift_oom_phase(torch, os.path.join(tmp, "loop2800"), card)

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

    # no single PyTorch call computes a min cut, the block-sparse
    # normal-equation sums or an LM trial, so library_ms is null for all
    print(json.dumps({"kernels": [
        {"name": "grid_mincut",
         "route": "cuda",
         "source": sources["grid_mincut"],
         "replaces": "simplepanorama_tpu/ops/maxflow.py:366",
         "launches": launches1[0] + launches2[0] + launches_opt[0],
         # its launches on each path that runs it (slice 2: the cuts
         # whose node box is at most 0.9 of the block and 1.2M cells;
         # slice 5: the cut=True re-composite of the little planet;
         # options: the cut=True cylindrical stitch)
         "launches_by_path": {"slice": launches1[0], "slice2": launches2[0],
                              "seam1400_closing": launches_closing[0],
                              "slice5": launches5[0],
                              "options": launches_opt[0],
                              "hostcut": launches_hostcut[0],
                              "dist": launches_dist["mincut"][0],
                              # the two stitches of a fresh process
                              "fresh": launches_fresh[0]},
         # largest |cut value (kernel) - cut value (plain)| over its inputs
         "max_abs_err": max(errs1),
         # times and bound at slice 2's first crop that kept its tiles
         # resident, as grid_mincut_auto hands it over; every input's
         # below
         "ms": timing1[0],
         "plain_ms": timing1[1],
         "bound_ms": timing1[2][0],
         "bound_by": timing1[2][1],
         "library_ms": None,
         "by_input": {k: {"ms": t[0], "plain_ms": t[1],
                          "bound_ms": t[2][0], "bound_by": t[2][1]}
                      for k, t in timings1.items()}},
        {"name": "grid_mincut_tiled",
         "route": "cuda",
         "source": sources["grid_mincut_tiled"],
         "replaces": "simplepanorama_tpu/ops/maxflow.py:666",
         # slice 2's cuts whose node box is over 0.9 of the block or
         # over 1.2M cells, and the closing cut's solve through
         # grid_mincut_auto
         "launches": launches2[1] + launches_closing[1],
         "launches_by_path": {"slice": launches1[1], "slice2": launches2[1],
                              "seam1400_closing": launches_closing[1],
                              "slice5": launches5[1],
                              "options": launches_opt[1],
                              "hostcut": launches_hostcut[1],
                              "dist": launches_dist["mincut"][1]},
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
         # once per LM trial executed: its launches in the stitches of
         # slices 1, 2 and 5 and of the options phase, in slice 3's four
         # CLI commands and in the graphed sharded LM of the dist phase
         # (counted on the replays, of kept programs too)
         "launches": launches1_k3 + launches2_k3 + launches3_path
         + launches5_k3 + launches_opt_k3
         + launches_dist["assemble_streams"],
         "launches_by_path": {"slice": launches1_k3, "slice2": launches2_k3,
                              "slice3": launches3_path,
                              "slice5": launches5_k3,
                              "options": launches_opt_k3,
                              "dist": launches_dist["assemble_streams"],
                              "ba_cache": launches_cache,
                              "hostcut": launches_hostcut[2],
                              "threads": launches_threads,
                              "fresh": launches_fresh[1],
                              "ba_phase": {k: v["launches"]
                                           for k, v in ba_runs.items()}},
         # its checking calls on slice 3's own BA problem, kernel3 phase
         "probe_launches": probe3,
         # largest |kernel - plain| over every output of every input
         "max_abs_err": max(errs3),
         # times and bound at the largest capacity bucket of slice 1's
         # schedule (relaxed objective), as the LM trial calls it
         "ms": timing3[0],
         "plain_ms": timing3[1],
         "bound_ms": timing3[2][0],
         "bound_by": timing3[2][1],
         "library_ms": None},
        # kernels 4 and 5 replace no TPU kernel: the JAX package's LM
        # trial body; launches on each path of the run (replays counted,
        # each path checked against its trials executed:
        # _check_trial_path), times (CUDA events) and bounds at the
        # largest bucket of slice 1's schedule (the benchmark cell's),
        # from the trial phase
        *({"name": k,
           "route": "cuda",
           "source": sources["trial"],
           "replaces": None,
           "launches": sum(v[i] for v in _TRIAL_PATHS.values()),
           "launches_by_path": {p: v[i] for p, v in _TRIAL_PATHS.items()},
           "max_rel_err": trial[pre + "_max_rel"],
           "ms": trial[pre + "_ms"],
           "plain_ms": trial[pre + "_plain_ms"],
           "bound_ms": trial[pre + "_bound_ms"],
           "bound_by": trial[pre + "_bound_by"],
           "library_ms": None}
          for i, k, pre in ((0, "trial_streams", "k4"),
                            (1, "solve_accept", "k5"))),
        {"name": "lm_trial",
         "route": "cuda graph",
         "graph_ops": trial["fused"]["graph_ops"],
         "us_per_trial": trial["fused"]["us_per_trial"],
         "device_ms_per_trial": trial["fused"]["device_ms_per_trial"],
         "lm_trial_graph_ops": trial["lm_trial"]["graph_ops"],
         "lm_trial_us_per_trial": trial["lm_trial"]["us_per_trial"],
         "lm_trial_device_ms_per_trial":
             trial["lm_trial"]["device_ms_per_trial"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
