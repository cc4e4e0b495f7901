#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (simplepanorama_tpu_torch).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases, each printing one line per input:
  env     the card (nvidia-smi name and power limit), torch/CUDA/nvcc;
  build   nvcc builds of csrc/mincut.cu and csrc/mincut_tiled.cu from
          the checkout's sources;
  kernel  grid_mincut (kernel 1, CUDA) against grid_mincut_ref (plain
          PyTorch) on the card: a 48x160 random grid with a hole, and a
          seam graph built by render/graphcut._build_cut_graph from two
          overlapping 700-px views at the packed block shape of slice 1;
  kernel2 grid_mincut_tiled (kernel 2) against grid_mincut_tiled_ref on
          the 48x160 grid and on a seam graph from two 1400-px views at
          the block shape of slice 2 (over 1.2M cells), with kernel 1 on
          the same seam graph beside it;
  slice   a 12-view 360-degree loop of 700-px views through
          Panorama(paths, device="cuda").stitch(Config(cut=True))
          .get_preview(), with both kernels' launches counted;
  slice2  a 12-view loop of 2800-px views through
          Panorama(paths, device="cuda").stitch(Config(cut=True,
          init_size=1400, gain_compensation=True)), then get_preview()
          and get_panorama() (the full-res render), launches counted;
  cpu_vs_card  4 views of 640 px (preview 320 px) through the port on
          "cpu" and "cuda": previews and full-res panoramas.

Then one JSON line with the kernels' numbers and, last, the result line.
Any failure raises: the exit code is then non-zero and no result line
is printed. It needs no network and starts no process of its own except
nvidia-smi and nvcc.
"""

import json
import os
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
    (|cut difference|, kernel ms, plain ms). The plain time is the median
    of ``plain_reps`` repeats, or with 0 its checking run."""
    side_k = kernel(*graph)
    stats = dict(kernel.last_stats)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    side_r = plain(*graph, **plain_kw)
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
          plain_ms=ms_r, solver_stats=stats, device=card)
    if not (abs(vk - vr) <= 1e-3 * max(1.0, abs(vr)) and agree >= 0.999):
        raise RuntimeError(f"{kernel.__name__} disagrees with its plain "
                           f"version on {name}: cut {vk} vs {vr}, "
                           f"agreement {agree}")
    return abs(vk - vr), ms_k, ms_r


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


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs a CUDA GPU")
    import cv2
    from simplepanorama_tpu_torch import Config, Panorama
    from simplepanorama_tpu_torch.fixtures import cut_grid, fkh360_views
    from simplepanorama_tpu_torch.ops import maxflow
    from simplepanorama_tpu_torch.pipeline import full_precision
    from simplepanorama_tpu_torch.utils.timing import global_timer

    full_precision()
    smi = _nvidia_smi()
    print(smi, flush=True)
    card = torch.cuda.get_device_name(0)
    _line("env", nvidia_smi=smi, torch=torch.__version__,
          cuda=torch.version.cuda, nvcc=_nvcc_version(), device=card)

    # both sources compiled at once, one nvcc each
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:
        futs = {k: ex.submit(maxflow.build, k, True)
                for k in ("grid_mincut", "grid_mincut_tiled")}
        build_s = {k: f.result() for k, f in futs.items()}
    _line("build", sources={k: "simplepanorama_tpu_torch/csrc/"
                            + maxflow._KERNELS[k][1] for k in build_s},
          nvcc_seconds=build_s, wall_seconds=time.perf_counter() - t0)
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
            err, ms_k, ms_r = _solve_pair(
                torch, maxflow, name, graph, maxflow.grid_mincut,
                maxflow.grid_mincut_ref, 5, 5, card, "kernel")
            errs1.append(err)
        timing1 = (ms_k, ms_r)      # the seam graph's times are reported

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
            err, ms_k, ms_r = _solve_pair(
                torch, maxflow, name, graph, maxflow.grid_mincut_tiled,
                maxflow.grid_mincut_tiled_ref, 3, plain_reps, card,
                "kernel2", tile_rows=tile_rows)
            errs2.append(err)
        timing2 = (ms_k, ms_r)
        side_1 = maxflow.grid_mincut(*seam)
        host = [t.cpu().numpy() for t in seam]
        v1 = maxflow.cut_value(*host, side_1)
        v2 = maxflow.cut_value(*host, maxflow.grid_mincut_tiled(*seam))
        ms_1 = _time_ms(torch, maxflow.grid_mincut, seam, 3)
        _line("kernel2", input="seam1400", solver="grid_mincut (kernel 1)",
              cut_kernel1=v1, cut_kernel2=v2, kernel1_ms=ms_1,
              kernel2_ms=timing2[0],
              kernel1_stats=dict(maxflow.grid_mincut.last_stats),
              device=card)
        if abs(v1 - v2) > 1e-3 * max(1.0, abs(v1)):
            raise RuntimeError(f"kernels 1 and 2 disagree: {v1} vs {v2}")

        timer = global_timer()
        os.environ["SPT_SYNC_STAGES"] = "1"

        # ---- slice 1: 12 views, 360 degrees, graph-cut seams ----
        paths, yaws, f_true = fkh360_views(
            12, 700, out_dir=os.path.join(tmp, "loop"))
        timer.durations.clear()
        timer.counts.clear()
        _reset_launches(maxflow)
        t0 = time.perf_counter()
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
              stages_s=dict(timer.durations), device=card)
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
        os.environ.pop("SPT_SYNC_STAGES")
        del pano, preview, full, small

        # ---- the same 4 views through the port on the CPU and the card ----
        paths4, _, _ = fkh360_views(4, 640, yaw_step_deg=20.0, hfov_deg=45.0,
                                    roll_deg=3.0,
                                    out_dir=os.path.join(tmp, "four"))
        cfg = Config(cut=True, init_size=320, RANSAC_iterations=300)
        out = {}
        for dev in ("cpu", "cuda"):
            p = Panorama(paths4, device=dev).stitch(cfg)
            out[dev] = (tuple(p.connected), p.get_preview(),
                        p.result.K[:, 0, 0], p.get_panorama())
        ncc, shift = _ncc_aligned(out["cpu"][1], out["cuda"][1])
        ncc_f, shift_f = _ncc_aligned(out["cpu"][3], out["cuda"][3])
        _line("cpu_vs_card", connected_cpu=list(out["cpu"][0]),
              connected_cuda=list(out["cuda"][0]),
              shapes=[list(out["cpu"][1].shape), list(out["cuda"][1].shape)],
              full_shapes=[list(out["cpu"][3].shape),
                           list(out["cuda"][3].shape)],
              focal_rel_diff=float(np.max(np.abs(
                  out["cuda"][2] / out["cpu"][2] - 1.0))),
              ncc=ncc, shift=list(shift), full_ncc=ncc_f,
              full_shift=list(shift_f), device=card)
        if out["cpu"][0] != out["cuda"][0] or ncc < 0.98 or ncc_f < 0.98:
            raise RuntimeError("CPU and card panoramas disagree")

    print(json.dumps({"kernels": [
        {"name": "grid_mincut",
         "route": "cuda",
         "source": "simplepanorama_tpu_torch/csrc/mincut.cu",
         "replaces": "simplepanorama_tpu/ops/maxflow.py:366",
         "launches": launches1[0],
         # largest |cut value (kernel) - cut value (plain)| over its inputs
         "max_abs_err": max(errs1),
         "ms": timing1[0],
         "plain_ms": timing1[1]},
        {"name": "grid_mincut_tiled",
         "route": "cuda",
         "source": "simplepanorama_tpu_torch/csrc/mincut_tiled.cu",
         "replaces": "simplepanorama_tpu/ops/maxflow.py:666",
         "launches": launches2[1],
         "max_abs_err": max(errs2),
         "ms": timing2[0],
         "plain_ms": timing2[1]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
