"""The readers of the program's counters on the CPU: what each reads of
the program's Timer, and nothing (no error) from a program that keeps
no counters, as one before them kept none.

Run from the root of the repository: ``python -m pytest panobench/tests``.
"""

from __future__ import annotations

import pathlib

import pytest

from panobench import cell as cellmod
from simplepanorama_tpu_torch.utils import timing

REPO = pathlib.Path(__file__).resolve().parents[2]
CELL = "sp700-cut.loop12"
READERS = ("ba_trials_executed", "ba_useful_trial_pct",
           "mincut_outer_rounds", "mincut_push_ms", "mincut_bfs_ms")


class _OldTimer:
    """A Timer as it was before counters: stage walls and counts only."""

    def __init__(self) -> None:
        self.durations = {"bundle_adjust": 3.0}
        self.counts = {"bundle_adjust": 4}


def _read(mp, timer) -> dict:
    mp.setattr(timing, "_GLOBAL", timer)
    cell = cellmod.load_cell(REPO, CELL)
    defs = [m for m in cell.per_layer if m["name"] in READERS]
    assert sorted(m["name"] for m in defs) == sorted(READERS)
    readers = cell.readers(defs)
    return {k: readers[k](None) for k in READERS}


def test_counters_per_stitch_of_the_process(monkeypatch):
    timer = timing.Timer()
    for _ in range(4):
        with timing.stage("bundle_adjust", timer):
            pass
    timer.add("ba.trials_executed", 2000)
    timer.add("ba.lm_trials", 1800)
    timer.add("mincut.outer", 2200)
    timer.add("mincut.push_ns", 1_160_000_000)
    timer.add("mincut.bfs_ns", 1_460_000_000)
    got = _read(monkeypatch, timer)
    assert got == pytest.approx({
        "ba_trials_executed": 500.0, "ba_useful_trial_pct": 90.0,
        "mincut_outer_rounds": 550.0, "mincut_push_ms": 290.0,
        "mincut_bfs_ms": 365.0})


def test_cpu_run_reads_no_mincut(monkeypatch):
    """The CPU's cuts take the native solver: the min-cut readers find
    no counter and leave their metrics out."""
    timer = timing.Timer()
    with timing.stage("bundle_adjust", timer):
        timer.add("ba.trials_executed", 48)
        timer.add("ba.lm_trials", 41)
    got = _read(monkeypatch, timer)
    assert got["ba_trials_executed"] == 48
    assert got["ba_useful_trial_pct"] == pytest.approx(100 * 41 / 48)
    assert got["mincut_outer_rounds"] is None
    assert got["mincut_push_ms"] is None and got["mincut_bfs_ms"] is None


@pytest.mark.parametrize("timer", [_OldTimer(), timing.Timer()],
                         ids=["no_counters", "nothing_counted"])
def test_nothing_to_read_is_none(monkeypatch, timer):
    assert _read(monkeypatch, timer) == {k: None for k in READERS}
