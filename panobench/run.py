"""panobench: the benchmark of the stitcher's PyTorch and CUDA port.

    python3 panobench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout. The cell (``<config>.<traffic>`` of
``BENCHMARK.json``) names its files under ``panobench/`` (``cell.py``).

Set-up (``setup_s``): import the port, start CUDA, load the port's kernels
(built into ``build/kernels/`` of the checkout on its first run there),
draw the cell's pool of P photo sets and write them as JPEG under
``TMPDIR``, then one cold panorama through every request kind of the
traffic, on the first set of the order the seed draws. The window then
runs panoramas one after another (a closed loop, one user) on the
order's other sets, then its first, and round again, for
``--seconds``: each a new ``Panorama`` on its set's files, through the
traffic's request kinds, each request timed on the host clock to a
``torch.cuda.synchronize()``. The panorama under way when the window
closes runs to its end and counts. With ``--trace 1`` the stages are
drained at their boundaries (``SPT_SYNC_STAGES=1``), marked as profiler
ranges, and the window's first ``trace_panoramas`` panoramas run under
``torch.profiler``; the run prints the cell's per-layer metrics instead
of its end-to-end ones.

After the window the panoramas are judged against the true geometry
(``reference/judge.py``): the cheap numbers for every panorama, the
images for a sample drawn from the seed, and the last seam cut of the
first panorama of that sample against a plain max-flow. The last stderr
lines and the last key of the result give each number beside its limit.
The result is the last stdout line; earlier lines (prefixed ``panobench``) give the
card, the set-up's parts and the requests' walls.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse          # noqa: E402
import dataclasses       # noqa: E402
import enum              # noqa: E402
import json              # noqa: E402
import math              # noqa: E402
import os                # noqa: E402
import pathlib           # noqa: E402
import shutil            # noqa: E402
import statistics        # noqa: E402
import subprocess        # noqa: E402
import sys               # noqa: E402
import tempfile          # noqa: E402
import traceback         # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "simplepanorama_tpu")
STAGES = ("load", "keypoints", "matching", "bundle_adjust", "compositing",
          "warp", "equalize", "gain", "graph_cut", "dist_cut",
          "render_preview", "render_full")


def info(tag: str, **kw) -> None:
    print(f"panobench {tag} " + json.dumps(kw, default=float), flush=True)


def fixed_caches(root: pathlib.Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the port builds its own kernels into ``build/kernels``)."""
    build = root / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"


def stitcher_config(cfg_file: dict):
    """The port's ``Config`` from the config file's ``stitcher`` fields
    (enum members by name)."""
    from simplepanorama_tpu_torch.config import Config
    defaults = Config()
    kw = {}
    for k, v in cfg_file["stitcher"].items():
        d = getattr(defaults, k)
        kw[k] = type(d)[v] if isinstance(d, enum.Enum) else v
    return Config(**kw)


@dataclasses.dataclass
class Request:
    """One panorama: its set, the port's objects, and its outputs."""
    index: int
    set_index: int
    views: object
    config: object
    device: object
    pano: object = None
    preview: object = None
    full: object = None
    walls: Dict[str, float] = dataclasses.field(default_factory=dict)
    error: Optional[str] = None


def smi() -> dict:
    """The card's name, power limit and clocks, from nvidia-smi."""
    q = "name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return {"nvidia_smi": out.stdout.strip()}
    except (OSError, subprocess.SubprocessError) as e:
        return {"nvidia_smi": f"unavailable: {e}"}


def run_panorama(req: Request, kinds, sync, trace_on: bool) -> None:
    import torch
    for kind, fn in kinds.items():
        rf = (torch.profiler.record_function("panobench." + kind)
              if trace_on else None)
        t0 = time.perf_counter()
        try:
            if rf is not None:
                with rf:
                    fn(req)
                    sync()
            else:
                fn(req)
                sync()
        except Exception:           # a request that fails counts as failed
            req.error = traceback.format_exc()
            req.walls[kind] = time.perf_counter() - t0
            return
        req.walls[kind] = time.perf_counter() - t0


def outputs(req: Request, keep_images: bool) -> dict:
    """What the judge reads of one panorama, copied to the host."""
    p = req.pano
    out = {"nodes": list(p.result.nodes), "rot": p.stitch_params.rot,
           "K": p.result.K, "sizes": list(p.result.sizes)}
    if keep_images:
        st = p.stitch_params.state
        out.update(preview=req.preview, full=req.full,
                   scale=float(p.stitch_params.scale),
                   min_xy=tuple(float(v) for v in st.min_xy),
                   canvas_hw=tuple(st.canvas_hw))
        if st.seam_masks is not None:
            out.update(seams=st.seam_masks.cpu().numpy(),
                       masks=st.masks.cpu().numpy(),
                       offs=st.offs.cpu().numpy(),
                       imgs=st.imgs.cpu().numpy(),
                       seq=[n for n, _ in p.result.order])
    return out


class Reservoir:
    """A uniform sample of ``k`` panoramas of the window, drawn from the
    seed as they come (which ones does not depend on their timing beyond
    how many there are)."""

    def __init__(self, k: int, seed: int) -> None:
        import numpy as np
        self.k = k
        self.rng = np.random.default_rng([seed % 2 ** 63, 7])
        self.n = 0

    def offer(self) -> Optional[int]:
        """The slot of the next panorama, or None if it is not kept."""
        i = self.n
        self.n += 1
        if i < self.k:
            return i
        j = int(self.rng.integers(0, i + 1))
        return j if j < self.k else None


def main(argv=None, device: str = "cuda", root: pathlib.Path = ROOT) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from panobench import cell as cellmod
    cell = cellmod.load_cell(root, args.workload)
    fixed_caches(root)
    trace_on = bool(args.trace)
    tmp = tempfile.mkdtemp(prefix="panobench-")
    if trace_on:
        os.environ["SPT_SYNC_STAGES"] = "1"
        os.environ["SPT_TRACE_DIR"] = os.path.join(tmp, "trace")
    try:
        return _run(args, cell, device, tmp, trace_on)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(args, cell, device, tmp, trace_on) -> int:
    parts = {}
    import torch
    on_card = device == "cuda"
    if on_card and (not torch.cuda.is_available()
                    or torch.cuda.device_count() < cell.chips):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"panobench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{n} found", file=sys.stderr)
        return 2
    import numpy as np
    import simplepanorama_tpu_torch.pipeline  # noqa: F401
    from simplepanorama_tpu_torch.ops import ba_kernel, maxflow
    from simplepanorama_tpu_torch.utils.timing import global_timer
    from panobench import devtrace, views as viewmod
    from panobench.reference import judge
    parts["import_s"] = time.perf_counter() - T_START

    t0 = time.perf_counter()
    dev = torch.device(device)
    if on_card:
        torch.cuda.init()
        torch.empty(1, device=dev)
        torch.cuda.synchronize()
        sync = torch.cuda.synchronize
    else:
        def sync():
            return None
    parts["cuda_init_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if on_card:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(3) as ex:
            futs = [ex.submit(maxflow.build, "grid_mincut"),
                    ex.submit(maxflow.build, "grid_mincut_tiled"),
                    ex.submit(ba_kernel.build)]
            parts["nvcc_s"] = sum(f.result() for f in futs)
    parts["kernels_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    sets = viewmod.make_sets(cell.traffic, os.path.join(tmp, "views"), dev)
    sync()
    parts["views_s"] = time.perf_counter() - t0

    config = stitcher_config(cell.config)
    kinds = cell.requests()
    t0 = time.perf_counter()
    order = viewmod.visit_order(args.seed, len(sets))
    cold = Request(index=-1, set_index=order[0], views=sets[order[0]],
                   config=config, device=dev)
    run_panorama(cold, kinds, sync, False)
    parts["cold_s"] = time.perf_counter() - t0
    parts["cold_walls"] = cold.walls
    setup_s = time.perf_counter() - T_START
    info("card", device=(torch.cuda.get_device_name(0) if on_card
                         else "cpu"), torch=torch.__version__,
         cuda=torch.version.cuda, **(smi() if on_card else {}))
    info("setup", setup_s=setup_s, **parts)
    cold_failed = cold.error is not None
    if cold_failed:
        print(cold.error, file=sys.stderr)

    # ---- the window ----
    P = len(sets)
    timer = global_timer()
    kept_outputs: Dict[int, dict] = {}
    cheap: List[dict] = []
    reservoir = Reservoir(int(cell.traffic["check_panoramas"]), args.seed)
    if not cold_failed:
        cheap.append(dict(outputs(cold, False), set_index=order[0]))
    cold = None
    window: List[Request] = []
    rec0 = ba_kernel.assemble_streams.recorded
    cuts0 = (maxflow.grid_mincut.launches, maxflow.grid_mincut_tiled.launches)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    stage0 = dict(timer.durations)
    # the profiler covers the window's first panoramas: reading the
    # hundreds of thousands of kernels a stitch replays takes several
    # times the stitch's own time
    n_traced = int(cell.traffic["trace_panoramas"])
    tracer = devtrace.DeviceTrace() if (trace_on and on_card) else None
    if tracer is not None:
        tracer.__enter__()
    stop_s = 0.0           # the profiler's stop, not window time

    def stop_tracer():
        nonlocal tracer, stop_s
        t = time.perf_counter()
        tracer.__exit__(None, None, None)
        stop_s = time.perf_counter() - t
        traced.append(tracer)
        tracer = None

    traced: List[object] = []
    w0 = time.perf_counter()
    i = 0
    while time.perf_counter() - w0 - stop_s < args.seconds:
        if tracer is not None and i == n_traced:
            stop_tracer()
        s = order[(i + 1) % P]
        req = Request(index=i, set_index=s, views=sets[s], config=config,
                      device=dev)
        run_panorama(req, kinds, sync, tracer is not None)
        if req.error is None:
            slot = reservoir.offer()
            cheap.append(dict(outputs(req, False), set_index=s))
            if slot is not None:
                kept_outputs[slot] = dict(outputs(req, True), set_index=s)
        req.pano = req.preview = req.full = None
        window.append(req)
        i += 1
    window_s = time.perf_counter() - w0 - stop_s
    if tracer is not None:
        stop_tracer()
    peak = torch.cuda.max_memory_allocated() if on_card else None
    stage_s = {k: timer.durations.get(k, 0.0) - stage0.get(k, 0.0)
               for k in STAGES}

    counts: Dict[str, int] = {}
    walls: Dict[str, List[float]] = {}
    failed = 0
    for r in window:
        if r.error is not None:
            failed += 1
            print(r.error, file=sys.stderr)
            continue
        for k, v in r.walls.items():
            walls.setdefault(k, []).append(v)
            counts[k] = counts.get(k, 0) + 1
    attempted = sum(len(r.walls) for r in window)
    info("window", seconds=window_s, panoramas=len(window),
         sets=[r.set_index for r in window],
         walls={k: {"n": len(v), "median": statistics.median(v),
                    "max": max(v), "all": v} for k, v in walls.items()},
         ba_captures=ba_kernel.assemble_streams.recorded - rec0,
         mincut_launches=[maxflow.grid_mincut.launches - cuts0[0],
                          maxflow.grid_mincut_tiled.launches - cuts0[1]])

    summary = None
    t0 = time.perf_counter()
    if traced:
        summary = devtrace.summarize(traced.pop().events(), STAGES)
        info("trace", stop_s=stop_s, read_s=time.perf_counter() - t0,
             panoramas=min(i, n_traced),
             device_ops=len(summary.kernel_s), busy_intervals=len(
                 summary.busy))

    ctx = Context(counts=counts, walls=walls, stage_s=stage_s,
                  setup_s=setup_s, peak_bytes=peak, trace=summary,
                  window_s=window_s)
    metric_defs = cell.per_layer if trace_on else cell.end_to_end
    metrics = {}
    readers = cell.readers(metric_defs)
    for m in metric_defs:
        v = readers[m["name"]](ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    # ---- the judge, after the window, with the program's state freed --
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    src = viewmod.load_source(dev)
    readings = []
    for o in cheap:
        r = judge.judge_cameras(o, sets[o["set_index"]])
        readings.append(r)
    for o in kept_outputs.values():
        readings.append(judge.judge_images(o, sets[o["set_index"]], src))
    # one seam cut a run: the last cut of the first panorama kept, the
    # part of its overlap drawn from the seed
    first = kept_outputs.get(0)
    if first is not None and first.get("seams") is not None:
        rng = np.random.default_rng([args.seed % 2 ** 63, 5])
        readings.append(judge.judge_seam_cut(first, float(rng.random())))
    kept_outputs = None
    checks = judge.verdict(readings, cell.limits)
    info("judge", seconds=time.perf_counter() - t0, judged=len(cheap),
         images_judged=len(readings) - len(cheap), readings=readings)

    correct = (failed == 0 and not cold_failed and bool(window)
               and bool(checks)
               and all(c["ok"] for c in checks.values())
               and set(checks) >= set(cell.limits))
    device_out = {"platform": "gpu" if on_card else "cpu",
                  "kind": torch.cuda.get_device_name(0) if on_card
                  else "cpu", "count": cell.chips if on_card else 0,
                  "memory_peak_bytes": int(peak) if peak is not None else 0}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_out}
    if summary is not None:
        device_out["busy_s"] = sum(b - a for a, b in summary.busy)
        device_out["window_s"] = summary.window[1] - summary.window[0]
        result["breakdown"] = {"device_ops": devtrace.top_ops(summary),
                               "idle_gaps": devtrace.idle_gaps(summary)}
    # a number that could not be formed (a view missing from a pair) is
    # null in the JSON line, and fails its limit
    result["checks"] = {k: {"value": c["value"] if math.isfinite(c["value"])
                            else None, "limit": c["limit"]}
                        for k, c in checks.items()}

    bad = sorted({m.split(".")[0] for m in list(sys.modules)}
                 & set(FORBIDDEN))
    if bad:
        print(f"panobench: the process loaded {bad}; the benchmark "
              "measures the PyTorch port alone", file=sys.stderr)
        return 3
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


@dataclasses.dataclass
class Context:
    """What a metric reader reads (``metrics/<name>.py``)."""
    counts: Dict[str, int]          # completed requests by kind
    walls: Dict[str, List[float]]   # their walls, s
    stage_s: Dict[str, float]       # the program's stage walls in the window
    setup_s: float
    peak_bytes: Optional[int]
    trace: object                   # devtrace.Summary, or None
    window_s: float                 # the window's length, s


if __name__ == "__main__":
    sys.exit(main())
