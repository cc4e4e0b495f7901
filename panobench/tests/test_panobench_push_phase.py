"""The readers of kernel 1's resident push phases on the CPU:
``mincut_push_phase_us`` and ``mincut_push_wait_pct`` from the
program's Timer, and nothing (no error) where a program keeps no such
counters, as one whose push phases meet at grid barriers does not, or
where nothing was solved.

Run from the root of the repository: ``python -m pytest panobench/tests``.
"""

from __future__ import annotations

import pathlib

import pytest

from panobench import cell as cellmod
from simplepanorama_tpu_torch.utils import timing

REPO = pathlib.Path(__file__).resolve().parents[2]
CELL = "sp700-cut.loop12"
NAMES = ("mincut_push_phase_us", "mincut_push_wait_pct")


def _readers():
    cell = cellmod.load_cell(REPO, CELL)
    defs = [m for m in cell.per_layer if m["name"] in NAMES]
    assert len(defs) == 2
    for m in defs:
        assert m["workloads"] == [CELL]
        assert (m["layer"], m["source"], m["moves"], m["better"]) == (
            "kernels", "program_counter", "stitch_s", "lower")
    return cell.readers(defs)


def _timer(monkeypatch, counters):
    timer = timing.Timer()
    timer.record("bundle_adjust", 0.1)
    timer.add("mincut.outer", 47)
    for k, v in counters.items():
        timer.add("mincut." + k, v)
    monkeypatch.setattr(timing, "_GLOBAL", timer)


@pytest.mark.parametrize("counters,want", [
    ({"push_ns": 12_690_000, "push_phases": 1_410}, 9.0),
    ({"push_ns": 0, "push_phases": 1_410}, 0.0),
    ({"push_ns": 22_000_000}, None),          # no phase counter
    ({"push_ns": 5_000, "push_phases": 0}, None),   # no phase run
    ({}, None)])                              # nothing solved
def test_push_phase_us(monkeypatch, counters, want):
    _timer(monkeypatch, counters)
    got = _readers()["mincut_push_phase_us"](None)
    assert got == pytest.approx(want) if want is not None else got is None


@pytest.mark.parametrize("counters,want", [
    ({"push_checks": 1_314_402, "push_waits": 657_201}, 50.0),
    ({"push_checks": 800, "push_waits": 0}, 0.0),
    ({"push_checks": 800}, None),             # no wait counter
    ({"push_checks": 0, "push_waits": 0}, None),   # no check made
    ({}, None)])                              # nothing solved
def test_push_wait_pct(monkeypatch, counters, want):
    _timer(monkeypatch, counters)
    got = _readers()["mincut_push_wait_pct"](None)
    assert got == pytest.approx(want) if want is not None else got is None
