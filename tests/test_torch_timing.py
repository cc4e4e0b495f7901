"""utils/timing: stages, spans and counters in one Timer.

A span records as a stage does but never drains the stream; counters
sum under the Timer's lock and show in ``report()``; two threads timing
one name each keep their own start.
"""

from __future__ import annotations

import sys
import threading
import time

import pytest
import torch

from simplepanorama_tpu_torch.utils import timing


@pytest.fixture
def syncs(monkeypatch):
    """Stage boundaries drained (SPT_SYNC_STAGES=1); every drain and
    every torch.cuda.synchronize recorded instead of run."""
    calls = []
    monkeypatch.setenv("SPT_SYNC_STAGES", "1")
    monkeypatch.delenv("SPT_TRACE_DIR", raising=False)
    monkeypatch.setattr(timing, "_sync_device", lambda: calls.append("drain"))
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **kw: calls.append("synchronize"))
    return calls


def test_span_records_and_never_syncs(syncs):
    t = timing.Timer()
    for _ in range(3):
        with timing.span("ba.flag_read", t):
            time.sleep(0.002)
    assert t.counts["ba.flag_read"] == 3
    assert t.durations["ba.flag_read"] >= 0.006
    assert syncs == []
    with timing.stage("bundle_adjust", t):     # the stage still drains
        pass
    assert syncs == ["drain"]
    assert t.counts["bundle_adjust"] == 1


def test_span_as_decorator_records_each_call(syncs):
    t = timing.Timer()

    @timing.span("ba.add_camera", t)
    def add(x):
        return x + 1

    assert [add(i) for i in range(4)] == [1, 2, 3, 4]
    assert t.counts["ba.add_camera"] == 4
    assert syncs == []


def test_span_records_when_the_work_raises(syncs):
    t = timing.Timer()
    with pytest.raises(ValueError):
        with timing.span("seams.solve", t):
            raise ValueError("solver failed")
    assert t.counts["seams.solve"] == 1


def test_add_and_report_show_counters():
    t = timing.Timer()
    t.add("mincut.outer", 47)
    t.add("mincut.outer", 50)
    t.add("ba.trials_executed", 584)
    t.record("graph_cut", 0.5)
    assert t.counters == {"mincut.outer": 97, "ba.trials_executed": 584}
    lines = t.report().splitlines()
    assert lines[0].startswith("graph_cut: 0.500s x1")
    # counters after the durations, by name
    assert lines[1:] == ["ba.trials_executed: 584", "mincut.outer: 97"]


def test_record_adds_each_timed_run():
    t = timing.Timer()
    t.record("load", 0.25)
    t.record("load", 0.5)
    assert t.durations["load"] == 0.75
    assert t.counts["load"] == 2
    assert t.report() == "load: 0.750s x2"


@pytest.mark.parametrize("timed", [timing.stage, timing.span],
                         ids=["stage", "span"])
def test_two_threads_timing_one_name_both_record(monkeypatch, timed):
    """Both threads are inside the same name at once: each records its
    own full duration (a start keyed by name lost one and cut the
    other)."""
    monkeypatch.delenv("SPT_SYNC_STAGES", raising=False)
    monkeypatch.delenv("SPT_TRACE_DIR", raising=False)
    t = timing.Timer()
    inside = threading.Barrier(2, timeout=10)
    hold = 0.05

    def work():
        with timed("bundle_adjust", t):
            inside.wait()
            time.sleep(hold)

    threads = [threading.Thread(target=work) for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=10)
    assert not any(th.is_alive() for th in threads)
    assert t.counts["bundle_adjust"] == 2
    assert t.durations["bundle_adjust"] >= 2 * hold


def test_counters_lose_no_add_across_threads():
    t = timing.Timer()
    n, per = 8, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [t.add("mincut.push_ns", 3) for _ in range(per)])
            for _ in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert t.counters["mincut.push_ns"] == 3 * n * per


def test_span_is_a_profiler_range_under_trace_dir(monkeypatch, tmp_path):
    """With SPT_TRACE_DIR set a span is also a record_function range of
    its name, which the benchmark's device trace reads."""
    monkeypatch.setenv("SPT_TRACE_DIR", str(tmp_path))
    monkeypatch.delenv("SPT_SYNC_STAGES", raising=False)
    t = timing.Timer()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with timing.stage("keypoints", t):
            with timing.span("features.decode_wait", t):
                torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert {"keypoints", "features.decode_wait"} <= names
    assert t.counts["features.decode_wait"] == 1


def test_timer_lies_inside_the_profiler_range(monkeypatch, tmp_path):
    """The Timer's interval and the range share their boundaries: a
    stage's drain is inside both, the range's own cost outside the
    Timer."""
    monkeypatch.setenv("SPT_TRACE_DIR", str(tmp_path))
    monkeypatch.setenv("SPT_SYNC_STAGES", "1")
    monkeypatch.setattr(timing, "_sync_device", lambda: time.sleep(0.02))
    t = timing.Timer()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with timing.stage("bundle_adjust", t):
            pass
    ranges = [e.time_range.elapsed_us() * 1e-6 for e in prof.events()
              if e.name == "bundle_adjust"]
    assert len(ranges) == 1
    assert 0.02 <= t.durations["bundle_adjust"] <= ranges[0]
