"""devtrace.summarize on synthetic profiler events: given the names of
the program's spans (dotted names inside its stages) beside ``STAGES``,
the summary names the idle gaps they hold by its existing rule, and
everything else it held reads the same. ``run.py`` passes ``STAGES``
alone, so the benchmark's idle gaps do not name spans yet: handing it
the span names is the whole of what that takes."""

from __future__ import annotations

import pytest

from panobench import devtrace
from panobench.run import STAGES

# (name, on_device, start_s, end_s), as DeviceTrace.events gives them
EVENTS = [
    ("panobench.stitch", False, 0.0, 10.0),
    ("bundle_adjust", False, 1.0, 6.0),
    ("ba.add_camera", False, 2.0, 3.0),
    ("ba.flag_read", False, 3.2, 4.9),
    ("keypoints", False, 6.2, 9.0),
    ("features.decode_wait", False, 6.3, 6.45),
    # a profiler range's twin on the device's timeline: not device work
    ("bundle_adjust", True, 1.0, 6.0),
    ("ba.add_camera", True, 2.0, 3.0),
    ("resident_round_kernel(State)", True, 0.5, 2.2),
    ("assemble_kernel(Args)", True, 3.1, 5.0),
    ("resident_round_kernel(State)", True, 6.5, 9.9),
]

# the program's Timer.durations over the same stitch: stages and spans
TIMER = {"bundle_adjust": 5.0, "ba.add_camera": 1.0, "ba.flag_read": 1.7,
         "keypoints": 2.8, "features.decode_wait": 0.15}


def spans(durations) -> tuple:
    """The program's spans among a Timer's names: the dotted ones."""
    return tuple(sorted(k for k in durations if "." in k))


def test_spans_name_the_gaps_and_leave_the_rest():
    before = devtrace.summarize(EVENTS, STAGES)
    after = devtrace.summarize(EVENTS, STAGES + spans(TIMER))
    assert after.window == before.window == (0.0, 10.0)
    assert after.busy == before.busy == [(0.5, 2.2), (3.1, 5.0), (6.5, 9.9)]
    assert after.kernel_s == before.kernel_s
    assert after.kernel_s["resident_round_kernel(State)"] == \
        pytest.approx(1.7 + 3.4)
    assert after.requests == before.requests
    assert [s for s in after.stages if s[0] in STAGES] == before.stages
    assert {s[0] for s in after.stages} - set(STAGES) == {
        "ba.add_camera", "ba.flag_read", "features.decode_wait"}
    gaps_before = dict((round(g, 6), n) for n, g in
                       devtrace.idle_gaps(before))
    gaps_after = dict((round(g, 6), n) for n, g in devtrace.idle_gaps(after))
    # 2.2-3.1 inside ba.add_camera; 5.0-6.5 in bundle_adjust alone (its
    # middle, 5.75, is in no span); 0-0.5 and 9.9-10 in no stage
    assert gaps_before == {0.9: "bundle_adjust", 1.5: "bundle_adjust",
                           0.5: "request stitch, no stage",
                           0.1: "request stitch, no stage"}
    assert gaps_after == {**gaps_before, 0.9: "ba.add_camera"}
