"""The reader of kernel 1's BFS tile runs on the CPU:
``mincut_bfs_tile_runs`` from the program's Timer, per stitch, and
nothing (no error) where a program keeps no such counter, as one whose
BFS runs in rounds does not.

Run from the root of the repository: ``python -m pytest panobench/tests``.
"""

from __future__ import annotations

import pathlib

import pytest

from panobench import cell as cellmod
from simplepanorama_tpu_torch.utils import timing

REPO = pathlib.Path(__file__).resolve().parents[2]
CELL = "sp700-cut.loop12"


def _read():
    cell = cellmod.load_cell(REPO, CELL)
    defs = [m for m in cell.per_layer if m["name"] == "mincut_bfs_tile_runs"]
    assert len(defs) == 1
    assert defs[0]["workloads"] == [CELL]
    return cell.readers(defs)["mincut_bfs_tile_runs"]


@pytest.mark.parametrize("runs,stitches,want", [
    (12_480, 2, 6_240.0), (0, 3, 0.0), (None, 2, None), (500, 0, None)])
def test_tile_runs_per_stitch(monkeypatch, runs, stitches, want):
    timer = timing.Timer()
    for _ in range(stitches):
        timer.record("bundle_adjust", 0.1)
    timer.add("mincut.outer", 1_100)
    if runs is not None:
        timer.add("mincut.bfs_tile_runs", runs)
    monkeypatch.setattr(timing, "_GLOBAL", timer)
    assert _read()(None) == want
