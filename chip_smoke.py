#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (simplepanorama_tpu_torch).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases, each printing one line:
  env     the card (nvidia-smi name and power limit), torch/CUDA/nvcc;
  build   nvcc build of csrc/mincut.cu from the checkout's sources;
  kernel  grid_mincut (CUDA) against grid_mincut_ref (plain PyTorch) on
          the card: a 48x160 random grid with a hole, and a seam graph
          built by render/graphcut._build_cut_graph from two overlapping
          700-px views at the packed block shape of the slice;
  slice   a 12-view 360-degree loop of 700-px views through
          Panorama(paths, device="cuda").stitch(Config(cut=True))
          .get_preview(), with the kernel's launches counted;
  cpu_vs_card  4 views of 320 px through the port on "cpu" and "cuda".

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
    """Median of ``reps`` warm runs, CUDA events."""
    fn(*args)
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


def _seam_graph(torch, tmp):
    """Seam graph of the second of two overlapping 700-px views against
    the first, warped with their true spherical geometry at the slice's
    block shape (what render/graphcut._cut_step hands the solver)."""
    import cv2
    from simplepanorama_tpu_torch.fixtures import fkh360_views
    from simplepanorama_tpu_torch.render import compose, graphcut
    paths, yaws, f = fkh360_views(2, 700, out_dir=os.path.join(tmp, "pair"))
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


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs a CUDA GPU")
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

    t0 = time.perf_counter()
    build_s = maxflow.build(rebuild=True)
    _line("build", source="simplepanorama_tpu_torch/csrc/mincut.cu",
          nvcc_seconds=build_s, load_seconds=time.perf_counter() - t0)
    if build_s <= 0.0:
        raise RuntimeError("mincut.cu was not built from source in this run")

    with tempfile.TemporaryDirectory() as tmp:
        # ---- kernel vs plain version, same card, same inputs ----
        errs = []
        grid = cut_grid(48, 160, 7, (10, 20, 40, 70))
        for name, graph in (("grid48x160", [torch.from_numpy(a).cuda()
                                            for a in grid]),
                            ("seam", [t.contiguous()
                                      for t in _seam_graph(torch, tmp)])):
            side_k = maxflow.grid_mincut(*graph)
            stats = dict(maxflow.grid_mincut.last_stats)
            side_r = maxflow.grid_mincut_ref(*graph)
            torch.cuda.synchronize()
            host = [t.cpu().numpy() for t in graph]
            node = host[3]
            sk, sr = side_k.cpu().numpy(), side_r.cpu().numpy()
            vk = maxflow.cut_value(*host, sk)
            vr = maxflow.cut_value(*host, sr)
            agree = float((sk == sr)[node].mean()) if node.any() else 1.0
            ms_k = _time_ms(torch, maxflow.grid_mincut, graph)
            ms_r = _time_ms(torch, maxflow.grid_mincut_ref, graph)
            _line("kernel", input=name, shape=list(graph[0].shape),
                  nodes=int(node.sum()), cut_kernel=vk, cut_plain=vr,
                  side_agreement=agree, kernel_ms=ms_k, plain_ms=ms_r,
                  solver_stats=stats, device=card)
            if not (abs(vk - vr) <= 1e-3 * max(1.0, abs(vr))
                    and agree >= 0.999):
                raise RuntimeError(f"kernel disagrees with plain on {name}: "
                                   f"cut {vk} vs {vr}, agreement {agree}")
            errs.append(abs(vk - vr))
            timing = (ms_k, ms_r)      # the seam graph's times are reported

        # ---- the slice: 12 views, 360 degrees, graph-cut seams ----
        paths, yaws, f_true = fkh360_views(
            12, 700, out_dir=os.path.join(tmp, "loop"))
        timer = global_timer()
        timer.durations.clear()
        timer.counts.clear()
        os.environ["SPT_SYNC_STAGES"] = "1"
        maxflow.grid_mincut.launches = 0
        t0 = time.perf_counter()
        pano = Panorama(paths, device="cuda").stitch(Config(cut=True))
        preview = pano.get_preview()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = maxflow.grid_mincut.launches
        os.environ.pop("SPT_SYNC_STAGES")
        focals = pano.result.K[:, 0, 0]
        cov = _coverage(preview)
        _line("slice", connected=list(pano.connected), launches=launches,
              focal_true=f_true, focals=[float(x) for x in focals],
              blocks=list(pano.stitch_params.state.masks.shape),
              preview_shape=list(preview.shape), coverage=cov, wall_s=wall,
              stages_s={k: v for k, v in timer.durations.items()},
              device=card)
        if tuple(pano.connected) != (12, 12):
            raise RuntimeError(f"slice connected {pano.connected}")
        if launches < 11:
            raise RuntimeError(f"only {launches} min-cut kernel launches")
        if np.max(np.abs(focals / f_true - 1.0)) > 0.02:
            raise RuntimeError(f"focals {focals} vs true {f_true}")
        if not np.isfinite(preview).all() or cov <= 0.9:
            raise RuntimeError(f"preview coverage {cov}")

        # ---- the same 4 views through the port on the CPU and the card ----
        paths4, _, _ = fkh360_views(4, 320, yaw_step_deg=20.0, hfov_deg=45.0,
                                    roll_deg=3.0,
                                    out_dir=os.path.join(tmp, "four"))
        cfg = Config(cut=True, init_size=320, RANSAC_iterations=300)
        out = {}
        for dev in ("cpu", "cuda"):
            p = Panorama(paths4, device=dev).stitch(cfg)
            out[dev] = (tuple(p.connected), p.get_preview(),
                        p.result.K[:, 0, 0])
        ncc, shift = _ncc_aligned(out["cpu"][1], out["cuda"][1])
        _line("cpu_vs_card", connected_cpu=list(out["cpu"][0]),
              connected_cuda=list(out["cuda"][0]),
              shapes=[list(out["cpu"][1].shape), list(out["cuda"][1].shape)],
              focal_rel_diff=float(np.max(np.abs(
                  out["cuda"][2] / out["cpu"][2] - 1.0))),
              ncc=ncc, shift=list(shift), device=card)
        if out["cpu"][0] != out["cuda"][0] or ncc < 0.98:
            raise RuntimeError("CPU and card previews disagree")

    print(json.dumps({"kernels": [{
        "name": "grid_mincut",
        "route": "cuda",
        "source": "simplepanorama_tpu_torch/csrc/mincut.cu",
        "replaces": "simplepanorama_tpu/ops/maxflow.py:298",
        "launches": launches,
        # largest |cut value (kernel) - cut value (plain)| over both inputs
        "max_abs_err": max(errs),
        "ms": timing[0],
        "plain_ms": timing[1]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
