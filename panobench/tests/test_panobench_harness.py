"""The harness on the CPU at a tiny size: the result line's shape, a
config, traffic, limits and metric found by name in a copy that only
gained files, and the faults a cell can have turning ``correct`` false.

Run from the root of the repository: ``python -m pytest panobench/tests``.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

from _tiny import CELL, run_cpu, tiny_root

PROBE = '''"""Test metric: the stitch requests' decode and features."""


def read(ctx):
    n = ctx.counts.get("stitch")
    return (ctx.stage_s["load"] + ctx.stage_s["keypoints"]) / n if n else None
'''


@pytest.fixture
def env(monkeypatch):
    """The harness sets cache and tracing variables for its process:
    give them back after each test."""
    for k in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR", "CUDA_CACHE_PATH",
              "USE_FLAX", "SPT_SYNC_STAGES", "SPT_TRACE_DIR"):
        monkeypatch.setenv(k, "")
        monkeypatch.delenv(k)
    return monkeypatch


def test_added_files_are_found(tmp_path):
    from panobench import cell as cellmod
    root = tiny_root(tmp_path, metric_file=PROBE)
    cell = cellmod.load_cell(root, CELL)
    assert cell.config["name"] == "tiny"
    assert cell.traffic["views"] == 4
    assert set(cell.requests()) == {"stitch", "export"}
    names = [m["name"] for m in cell.per_layer]
    assert "probe_s" in names and "render_full_s" in names
    assert cell.readers([m for m in cell.per_layer
                         if m["name"] == "probe_s"])["probe_s"]
    with pytest.raises(KeyError):
        cellmod.load_cell(root, "no-such.cell")


def test_result_line(tmp_path, capsys, env):
    root = tiny_root(tmp_path, metric_file=PROBE)
    res = run_cpu(root, capsys)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] >= 2 and res["failed"] == 0
    assert set(res["metrics"]) == {"stitch_s", "export_s", "setup_s"}
    for m in res["metrics"].values():
        assert m["value"] > 0 and m["unit"] == "s"
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert set(res["checks"]) == {"missing_views", "reg_px", "reg_px_median",
                                  "focal_err", "preview_gap", "full_gap",
                                  "seam_defect", "seam_cut_excess"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}


def test_traced_line_has_layer_metrics(tmp_path, capsys, env):
    root = tiny_root(tmp_path, metric_file=PROBE)
    res = run_cpu(root, capsys, trace=1)
    m = res["metrics"]
    # the stage metrics and the added one; the device's need a card
    assert {"features_s", "matching_s", "bundle_adjust_s", "graph_cut_s",
            "compose_s", "driver_other_s", "render_full_s",
            "probe_s"} <= set(m)
    assert "mincut_device_ms" not in m and "device_idle_pct" not in m
    assert m["probe_s"]["value"] == pytest.approx(m["features_s"]["value"])


def _ba_unchanged(mp):
    """The BA's LM takes no step: each camera keeps the estimate it is
    added with (chained from the pairwise homographies)."""
    import simplepanorama_tpu_torch.stitch as stitch

    def no_step(cams_c, active_c, data_c, lo, hi, order_conns, H_pair,
                *a, **kw):
        for l in range(lo, hi):
            cams_c = stitch._add_camera(cams_c, l, order_conns[l], H_pair[l])
            active_c[l] = True
        return cams_c, None
    mp.setattr(stitch, "_lm_chunk", no_step)


def _half_views(mp):
    import simplepanorama_tpu_torch.pipeline as pipeline
    orig = pipeline.Panorama.__init__

    def half(self, paths, *a, **kw):
        orig(self, list(paths)[:len(paths) // 2], *a, **kw)
    mp.setattr(pipeline.Panorama, "__init__", half)


def _preview_altered(mp):
    import simplepanorama_tpu_torch.stitcher as stitcher
    orig = stitcher.render_preview

    def altered(*a, **kw):
        out = orig(*a, **kw).copy()
        w = out.shape[1]
        out[:, w // 3: 2 * w // 3] = np.roll(out[:, w // 3: 2 * w // 3],
                                             32, axis=1)
        return out
    mp.setattr(stitcher, "render_preview", altered)


def _full_altered(mp):
    import simplepanorama_tpu_torch.stitcher as stitcher
    orig = stitcher.render_full

    def altered(*a, **kw):
        out = orig(*a, **kw).copy()
        out[: out.shape[0] // 2] = 0
        return out
    mp.setattr(stitcher, "render_full", altered)


def _seams_altered(mp):
    import simplepanorama_tpu_torch.render.graphcut as graphcut
    orig = graphcut.graph_cut

    def altered(*a, **kw):
        seams = orig(*a, **kw)
        seams[1] = seams[1] * 0
        return seams
    mp.setattr(graphcut, "graph_cut", altered)


def _seam_side_false(mp):
    """The min-cut gives the new image none of its overlap."""
    import torch
    import simplepanorama_tpu_torch.render.graphcut as graphcut

    def none(wh, wv, excess, obj, mask2):
        return torch.where(obj, torch.zeros_like(obj), mask2 > 0)
    mp.setattr(graphcut, "_solve_cut", none)


@pytest.mark.parametrize("fault, number", [
    (_ba_unchanged, "reg_px"),
    (_half_views, "missing_views"),
    (_preview_altered, "preview_gap"),
    (_full_altered, "full_gap"),
    (_seams_altered, "seam_defect"),
    (_seam_side_false, "seam_cut_excess"),
], ids=["ba_unchanged", "half_views", "preview_altered", "full_altered",
        "seams_altered", "seam_side_false"])
def test_fault_is_not_correct(tmp_path, capsys, env, fault, number):
    root = tiny_root(tmp_path)
    fault(env)
    res = run_cpu(root, capsys)
    assert res["correct"] is False
    c = res["checks"][number]
    assert c["value"] > c["limit"], json.dumps(res["checks"])
