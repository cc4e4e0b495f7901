"""On the card: the benchmark's own cell, one short window, sound and
with faults planted: the control (the BA's LM takes no step, so every
camera keeps the estimate it was added with, which breaks the
registration its configuration states) and a min-cut that gives each new
image none of its overlap. Marked ``cuda``; skipped without a card. On
the card, from the root of the repository:
``python -m pytest -m cuda panobench/tests/test_panobench_card.py``."""

from __future__ import annotations

import contextlib
import io
import json

import pytest

CELL = "sp700-cut.loop12"


@pytest.fixture
def card(monkeypatch):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for k in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR", "CUDA_CACHE_PATH",
              "USE_FLAX", "SPT_SYNC_STAGES", "SPT_TRACE_DIR"):
        monkeypatch.setenv(k, "")
        monkeypatch.delenv(k)
    return monkeypatch


def _run(seed: int) -> dict:
    from panobench import run
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run.main(["--workload", CELL, "--seed", str(seed),
                       "--seconds", "1", "--trace", "0"])
    assert rc == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.cuda
def test_cell_is_correct(card):
    res = _run(3700000001)
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert {"stitch_s", "peak_mem_gb", "setup_s"} == set(res["metrics"])
    assert set(res["checks"]) == {"missing_views", "reg_px", "reg_px_median",
                                  "focal_err", "preview_gap", "seam_defect",
                                  "seam_cut_excess"}


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [3700000011, 3700000012, 3700000013])
def test_control_is_not_correct(card, seed):
    import simplepanorama_tpu_torch.stitch as stitch

    def no_step(cams_c, active_c, data_c, lo, hi, order_conns, H_pair,
                *a, **kw):
        for l in range(lo, hi):
            cams_c = stitch._add_camera(cams_c, l, order_conns[l], H_pair[l])
            active_c[l] = True
        return cams_c, None
    card.setattr(stitch, "_lm_chunk", no_step)
    res = _run(seed)
    assert res["correct"] is False
    assert res["checks"]["reg_px"]["value"] > res["checks"]["reg_px"]["limit"]


@pytest.mark.cuda
def test_seam_fault_is_not_correct(card):
    import torch
    import simplepanorama_tpu_torch.render.graphcut as graphcut
    card.setattr(graphcut, "grid_mincut_auto",
                 lambda wh, wv, excess, node, **kw: torch.zeros_like(node))
    res = _run(3700000021)
    assert res["correct"] is False
    c = res["checks"]["seam_cut_excess"]
    assert c["value"] > c["limit"]
