"""A copy of the benchmark with one tiny cell added, for the CPU tests:
four 480-px views of a 90-degree arc, stitched at 320 px with graph-cut
seams, then exported. Only files are added to the copy."""

from __future__ import annotations

import json
import pathlib
import shutil

REPO = pathlib.Path(__file__).resolve().parents[2]
CELL = "tiny.arc4"

# limits of the tiny cell: its sound readings on the CPU (reg_px 1-3.2,
# reg_px_median 1.3-1.5, focal_err 0.03-0.1, preview_gap and full_gap
# under 0.08, seam_defect 0, seam_cut_excess under 1e-9) with room
LIMITS = {"missing_views": 0, "reg_px": 8.0, "reg_px_median": 4.0,
          "focal_err": 0.25, "preview_gap": 0.15, "full_gap": 0.15,
          "seam_defect": 0, "seam_cut_excess": 0.01}


def tiny_root(tmp: pathlib.Path, metric_file: str = None) -> pathlib.Path:
    """A checkout of BENCHMARK.json and panobench/ under ``tmp`` with the
    tiny cell's config, traffic and limits added (and ``metric_file``,
    the source of a per-layer metric ``probe_s``, where given)."""
    root = tmp / "checkout"
    shutil.copytree(REPO / "panobench", root / "panobench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "tiny", "source": "test", "reduced": ["init_size"],
        "file": "panobench/configs/tiny.json", "why": "CPU test"})
    bench["workloads"].append({"name": CELL, "config": "tiny",
                               "traffic": "arc4", "chips": 1,
                               "why": "CPU test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(CELL)
    # the tiny cell exports: its metrics, which no cell of the benchmark
    # reports yet
    bench["end_to_end"].append({
        "name": "export_s", "unit": "s", "better": "lower", "bound": 0.05,
        "source": "host_clock", "workloads": [CELL]})
    bench["per_layer"].append({
        "name": "render_full_s", "unit": "s", "better": "lower",
        "source": "program_span", "layer": "full-res", "moves": "export_s",
        "workloads": [CELL]})
    pb = root / "panobench"
    cfg = json.loads((pb / "configs" / "sp700-cut.json").read_text())
    cfg["name"] = "tiny"
    cfg["stitcher"].update(init_size=320, threads=2)
    (pb / "configs" / "tiny.json").write_text(json.dumps(cfg))
    t = json.loads((pb / "traffic" / "export12.json").read_text())
    t.update(views=4, size=480, pool=2, check_panoramas=1)
    (pb / "traffic" / "arc4.json").write_text(json.dumps(t))
    (pb / "limits" / f"{CELL}.json").write_text(json.dumps(LIMITS))
    if metric_file is not None:
        bench["per_layer"].append({
            "name": "probe_s", "unit": "s", "better": "lower",
            "source": "program_span", "layer": "test", "moves": "stitch_s",
            "workloads": [CELL]})
        (pb / "metrics" / "probe_s.py").write_text(metric_file)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run_cpu(root: pathlib.Path, capsys, seed: int = 3000000007,
            trace: int = 0) -> dict:
    """One run of the harness on the CPU (the look for a card skipped);
    returns the result line, parsed."""
    from panobench import run
    rc = run.main(["--workload", CELL, "--seed", str(seed), "--seconds",
                   "0.01", "--trace", str(trace)], device="cpu", root=root)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0, out[-5:]
    return json.loads(out[-1])
