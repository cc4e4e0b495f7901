#!/usr/bin/env python3
"""What a fresh process pays: its first stitches, stage by stage, on one
CUDA card.

    python3 fresh_trace.py VIEWS [--profile | --cprofile] [--trial-kernels]
    python3 fresh_trace.py VIEWS --cli-views DIR --trees A B

The first form is the fresh process, as every command of the port's CLI
is: run it as a process of its own. It stitches the images in VIEWS
(every image file, sorted) twice in turn through
Panorama(paths, device="cuda").stitch(Config(cut=True)).get_preview(),
with SPT_SYNC_STAGES=1 (asynchronous work charged to the stage that
queued it). It prints the card's name and power limit, one JSON line
with the seconds its imports took, then one JSON line per stitch: its
wall, the stage walls, the LM's runs, trials, trials executed and those
through kernels 4 and 5, the CUDA graphs captured and the seconds spent
capturing them, the launches of kernel 1 (the min-cut), kernel 3 (the BA
assembly) and kernels 4 and 5 (the LM trial's), and sha256
digests of the cameras (K, rotations) and of the preview's bytes, so
that two stitches, two processes or two commits can be held equal. With
--profile each stitch runs under torch.profiler (CPU and CUDA
activities): its line adds the device time of its kernels, the host's
self CPU time over all operations, and the 30 operations (CUDA runtime
calls among them) on which it spent the most host time beyond the next
stitch. With --cprofile each stitch runs under cProfile instead (the
host's Python and the C functions it calls, imports among them): its
line adds the 25 functions of the most cumulative time and the 15 of
the most own time. Either profiler adds its own costs; take the walls
from a run without one. Each stitch's line also says whether
torch._dynamo was imported by the stitch's end (``dynamo_imported``)
and, if the process imported it at all, from where
(``dynamo_importer``: the innermost file:line frames of the first
import). torch.profiler imports torch._dynamo itself when it starts, so
under --profile ``dynamo_imported`` is null and the first stitch looks
seconds cheaper than a user's wherever a stitch would import it.
With --trial-kernels a third stitch follows, its BA chunks each under
torch.profiler (device activity only): one more line gives the kernels
the card ran and their device time per LM trial executed (no wall: the
profiler's first start imports torch._dynamo).

The second form compares two checkouts (A and B, each the root of one)
in turns, A B B A: in each turn, the first form (with
--trial-kernels) in a fresh process from that checkout's root, then the
CLI as a user runs it
(python -X importtime -m simplepanorama_tpu_torch.cli DIR --fast
--timing --save-state S -o P) in another. One JSON line per process:
its wall from launch to exit, its imports (-X importtime) and whether
they name torch._dynamo, its stage walls, and the digests of its
results.
"""

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

# the first and the second stitch of a process; the turns A B and B A
STITCHES = 2
ROUNDS = 2


def _digest(*chunks):
    h = hashlib.sha256()
    for c in chunks:
        h.update(c if isinstance(c, bytes) else c.tobytes())
    return h.hexdigest()[:16]


def _device_us(event):
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


def _ops(prof):
    """{op name: (self CPU us, calls, self device us)} of a profile."""
    return {e.key: (e.self_cpu_time_total, e.count, _device_us(e))
            for e in prof.key_averages()}


def _smi():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def imports_s(stderr):
    """Seconds of a process's imports from its -X importtime report: the
    cumulative time of each top-level import, summed."""
    return sum(int(m.group(1)) for m in re.finditer(
        r"^import time:\s+\d+ \|\s+(\d+) \| \S", stderr, re.M)) / 1e6


def dynamo_in_importtime(stderr):
    """Whether a -X importtime report names torch._dynamo."""
    return re.search(r"^import time:.*\|\s*torch\._dynamo\s*$", stderr,
                     re.M) is not None


class _ImportWatch:
    """A meta path finder that finds nothing and notes where ``name`` is
    first imported from: the innermost frames outside importlib, as
    file:line."""

    def __init__(self, name):
        self.name, self.where = name, None

    def find_spec(self, fullname, path=None, target=None):
        if fullname == self.name and self.where is None:
            import traceback
            self.where = [f"{f.filename}:{f.lineno}"
                          for f in traceback.extract_stack()[:-1]
                          if not f.filename.startswith("<frozen")
                          and "importlib" not in f.filename][-8:]
        return None


def _env():
    """The caller's environment without SPT_SYNC_STAGES: a user's."""
    return {k: v for k, v in os.environ.items() if k != "SPT_SYNC_STAGES"}


def run_cli(tree, views, out_dir, tag):
    """The CLI as a user runs it on ``views`` with --fast --timing
    --save-state, in a process of its own from ``tree``'s root. Returns
    its wall from launch to exit, its imports, its --timing report and
    the digests of its preview file and of the saved cameras."""
    import numpy as np
    prev_p = os.path.join(out_dir, f"preview_{tag}.jpg")
    state_p = os.path.join(out_dir, f"state_{tag}.npz")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m",
         "simplepanorama_tpu_torch.cli", views, "--fast", "--timing",
         "--save-state", state_p, "-o", prev_p], cwd=tree, env=_env(),
        capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"the CLI in {tree} exited {proc.returncode}:\n"
                           + proc.stderr[-3000:])
    with open(prev_p, "rb") as fh:
        preview = fh.read()
    state = np.load(state_p, allow_pickle=False)
    return {"process_wall_s": wall, "imports_s": imports_s(proc.stderr),
            "dynamo_imported": dynamo_in_importtime(proc.stderr),
            "timing_report_s": {m.group(1): float(m.group(2)) for m in
                                re.finditer(r"^(\w+): ([0-9.]+)s x\d+$",
                                            proc.stdout, re.M)},
            "preview_file": _digest(preview),
            "cameras": _digest(state["K"], state["rot"])}


def run_stitches(tree, views, flags=()):
    """The first form, with ``flags``, in a process of its own from
    ``tree``'s root (this script, with the package of ``tree``). Returns
    its wall from launch to exit, its imports row and its other rows."""
    code = ("import runpy, sys; sys.argv = sys.argv[1:]; "
            f"runpy.run_path({os.path.abspath(__file__)!r}, "
            "run_name='__main__')")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", code, "fresh_trace.py", views, *flags],
        cwd=tree,
        env=_env(),
        capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"fresh_trace.py in {tree} exited "
                           f"{proc.returncode}:\n" + proc.stderr[-3000:])
    rows = [json.loads(x) for x in proc.stdout.splitlines()
            if x.startswith("{")]
    return wall, rows[0], rows[1:]


def _functions(prof, key, n):
    """The ``n`` functions of a cProfile run with the most ``key`` time
    ("cum" or "own"): (function, cumulative s, own s, calls)."""
    import pstats
    rows = [(f"{os.path.basename(f)}:{line}({name})", ct, tt, nc)
            for (f, line, name), (_, nc, tt, ct, _) in
            pstats.Stats(prof).stats.items()]
    return sorted(rows, key=lambda r: -(r[1] if key == "cum" else r[2]))[:n]


def _trial_kernels(torch, stitch, run):
    """Kernels and their device time per LM trial executed over the BA
    chunks of ``run()``, each chunk under torch.profiler (device
    activity only; copies and memsets not counted as kernels)."""
    from torch.profiler import ProfilerActivity, profile
    chunk = stitch._lm_chunk
    tally = {"kernels": 0, "device_us": 0.0, "executed": 0}

    def profiled(*a, **kw):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = chunk(*a, **kw)
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if _device_us(e) > 0 and not e.key.startswith(("Memcpy",
                                                           "Memset")):
                tally["kernels"] += e.count
                tally["device_us"] += _device_us(e)
        tally["executed"] += out[1].executed
        return out
    stitch._lm_chunk = profiled
    try:
        run()
    finally:
        stitch._lm_chunk = chunk
    n = max(1, tally["executed"])
    return {"trials_executed": tally["executed"],
            "kernels_per_trial": tally["kernels"] / n,
            "device_ms_per_trial": tally["device_us"] / 1e3 / n}


def stitch_in_process(views, profile, cprofile=False, trial_kernels=False):
    """The first form: STITCHES stitches of ``views`` in this process
    (and the --trial-kernels stitch); prints what the module docstring
    says."""
    os.environ["SPT_SYNC_STAGES"] = "1"
    watch = _ImportWatch("torch._dynamo")
    sys.meta_path.insert(0, watch)
    t0 = time.perf_counter()
    import numpy as np
    import torch
    t_torch = time.perf_counter() - t0
    t0 = time.perf_counter()
    from simplepanorama_tpu_torch import Config, Panorama
    from simplepanorama_tpu_torch import stitch
    from simplepanorama_tpu_torch.ops import ba_kernel, ba_trial, maxflow
    from simplepanorama_tpu_torch.utils.timing import global_timer
    t_pkg = time.perf_counter() - t0
    if not torch.cuda.is_available():
        raise SystemExit("fresh_trace: no CUDA device")
    print(_smi(), flush=True)
    print(json.dumps({"imports_s": {"torch": t_torch, "package": t_pkg}}),
          flush=True)
    paths = sorted(os.path.join(views, f) for f in os.listdir(views)
                   if f.lower().endswith((".jpg", ".png")))
    timer = global_timer()
    lm = {}
    chunk = stitch._lm_chunk

    def counted(*a, **kw):
        cams, c = chunk(*a, **kw)
        for k in ("runs", "executed", "fused", "graphs", "capture_s"):
            lm[k] = lm.get(k, 0) + getattr(c, k)
        lm["trials"] = lm.get("trials", 0) + int(c.trials)
        return cams, c
    stitch._lm_chunk = counted
    last_ops = None
    rows = []
    for k in range(STITCHES):
        timer.durations.clear()
        timer.counts.clear()
        lm.clear()
        maxflow.grid_mincut.launches = 0
        ba_kernel.assemble_streams.launches = 0
        ba_trial.trial_streams.launches = 0
        ba_trial.solve_accept.launches = 0
        prof = None
        if profile:
            from torch.profiler import ProfilerActivity
            prof = torch.profiler.profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
        if cprofile:
            import cProfile
            cprof = cProfile.Profile()
            cprof.enable()
        t0 = time.perf_counter()
        pano = Panorama(paths, device="cuda").stitch(Config(cut=True))
        preview = pano.get_preview()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        row = {"stitch": k + 1, "wall_s": wall,
               "stages_s": dict(timer.durations),
               "lm": dict(lm),
               "launches": {"grid_mincut": maxflow.grid_mincut.launches,
                            "assemble_streams":
                                ba_kernel.assemble_streams.launches,
                            "trial_streams": ba_trial.trial_streams.launches,
                            "solve_accept": ba_trial.solve_accept.launches},
               "cameras": _digest(np.asarray(pano.result.K),
                                  np.asarray(pano.result.rot)),
               "preview": _digest(np.ascontiguousarray(preview)),
               "connected": list(pano.connected),
               "dynamo_imported": (None if profile else
                                   "torch._dynamo" in sys.modules),
               "dynamo_importer": watch.where}
        if cprofile:
            cprof.disable()
            row["host_functions_cum"] = _functions(cprof, "cum", 25)
            row["host_functions_own"] = _functions(cprof, "own", 15)
        if prof is not None:
            prof.__exit__(None, None, None)
            ops = _ops(prof)
            row["device_s"] = sum(v[2] for v in ops.values()) / 1e6
            row["host_self_s"] = sum(v[0] for v in ops.values()) / 1e6
            if last_ops is not None:
                rows[-1]["beyond_next_stitch"] = sorted((
                    (name, (v[0] - ops.get(name, (0, 0, 0))[0]) / 1e6,
                     v[1], ops.get(name, (0, 0, 0))[1])
                    for name, v in last_ops.items()),
                    key=lambda r: -r[1])[:30]
            last_ops = ops
        rows.append(row)
        pano._stop_full_prefetch()
        del pano, preview
    stitch._lm_chunk = chunk
    sys.meta_path.remove(watch)
    for row in rows:
        print(json.dumps(row), flush=True)
    if trial_kernels:
        def run():
            pano = Panorama(paths, device="cuda").stitch(Config(cut=True))
            pano._stop_full_prefetch()
        print(json.dumps({"trial_kernels": _trial_kernels(torch, stitch,
                                                          run)}), flush=True)


def in_turns(views, cli_views, trees):
    """The second form."""
    print(_smi(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for r in range(ROUNDS):
            for tree in (trees if r % 2 == 0 else trees[::-1]):
                wall, imports, rows = run_stitches(tree, views,
                                                   ["--trial-kernels"])
                print(json.dumps({"tree": tree, "round": r + 1,
                                  "command": "fresh_trace.py (stitches)",
                                  "process_wall_s": wall, **imports,
                                  "stitches": rows[:-1], **rows[-1]}),
                      flush=True)
                print(json.dumps({"tree": tree, "round": r + 1,
                                  "command": "cli", **run_cli(
                                      tree, cli_views, tmp, f"{r}")}),
                      flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("views")
    p.add_argument("--profile", action="store_true")
    p.add_argument("--cprofile", action="store_true")
    p.add_argument("--trial-kernels", action="store_true")
    p.add_argument("--cli-views")
    p.add_argument("--trees", nargs=2)
    args = p.parse_args(argv)
    if args.trees:
        in_turns(args.views, args.cli_views, args.trees)
    else:
        stitch_in_process(args.views, args.profile, args.cprofile,
                          args.trial_kernels)


if __name__ == "__main__":
    main()
