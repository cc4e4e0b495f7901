"""The readers of the LM trial's kernels on the CPU: ``ba_fused_trial_pct``
from the program's Timer, ``ba_trial_device_ms`` from a device trace,
and nothing (no error) where a program has neither, as one without the
trial's kernels has not.

Run from the root of the repository: ``python -m pytest panobench/tests``.
"""

from __future__ import annotations

import pathlib

import pytest

from panobench import cell as cellmod
from panobench import devtrace
from simplepanorama_tpu_torch.utils import timing

REPO = pathlib.Path(__file__).resolve().parents[2]
CELL = "sp700-cut.loop12"


def _readers():
    cell = cellmod.load_cell(REPO, CELL)
    defs = [m for m in cell.per_layer
            if m["name"] in ("ba_fused_trial_pct", "ba_trial_device_ms")]
    assert len(defs) == 2
    return cell.readers(defs)


@pytest.mark.parametrize("fused,want", [(590, 100.0), (0, 0.0),
                                        (None, None)])
def test_fused_trial_share(monkeypatch, fused, want):
    timer = timing.Timer()
    timer.add("ba.trials_executed", 590)
    if fused is not None:
        timer.add("ba.fused_trials", fused)
    monkeypatch.setattr(timing, "_GLOBAL", timer)
    assert _readers()["ba_fused_trial_pct"](None) == want


class _Ctx:
    def __init__(self, trace):
        self.trace = trace


def _summary(kernels):
    events = [("panobench.stitch", False, 0.0, 10.0),
              ("panobench.stitch", False, 10.0, 20.0)]
    t = 1.0
    for name, s in kernels:
        events.append((name, True, t, t + s))
        t += s + 0.1
    return devtrace.summarize(events, ())


def test_trial_device_ms_by_kernel_name():
    read = _readers()["ba_trial_device_ms"]
    k4 = ("(anonymous namespace)::trial_streams_kernel((anonymous "
          "namespace)::State, (anonymous namespace)::Problem)")
    k5 = "(anonymous namespace)::solve_accept_kernel(State, Problem)"
    k3 = "(anonymous namespace)::assemble_kernel(float const*)"
    got = read(_Ctx(_summary([(k4, 0.002), (k5, 0.004), (k3, 0.5)])))
    assert got == pytest.approx(3.0)     # 6 ms over two stitches
    assert read(_Ctx(_summary([(k3, 0.5)]))) is None
    assert read(_Ctx(None)) is None
