"""On the card: one traced window of the benchmark's cell, whose readers
of the program's counters are held against the program's Timer, and the
Timer's counters and spans over the profiled panorama against the
device trace and the launch counters of the same panorama. The test
takes the Timer's state where the profiler starts and stops and where
the readers are called, and keeps the trace's raw events. Marked
``cuda``; skipped without a card. On the card, from the root of the
repository:
``python -m pytest -m cuda panobench/tests/test_panobench_card_counters.py``.
"""

from __future__ import annotations

import contextlib
import io
import json

import pytest

CELL = "sp700-cut.loop12"
COUNTER_METRICS = {"ba_trials_executed", "ba_useful_trial_pct",
                   "mincut_outer_rounds", "mincut_push_ms", "mincut_bfs_ms"}
STAGE_METRICS = {"features_s", "matching_s", "bundle_adjust_s",
                 "graph_cut_s", "compose_s", "driver_other_s",
                 "mincut_device_ms", "ba_assemble_device_ms",
                 "device_idle_pct"}


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


def _snap() -> dict:
    """The program's Timer and kernel 3's launch counters now."""
    from simplepanorama_tpu_torch.ops import ba_kernel
    from simplepanorama_tpu_torch.utils.timing import global_timer
    t = global_timer()
    return {"durations": dict(t.durations), "counts": dict(t.counts),
            "counters": dict(t.counters),
            "launches": ba_kernel.assemble_streams.launches,
            "recorded": ba_kernel.assemble_streams.recorded}


def _delta(a: dict, b: dict) -> dict:
    return {k: ({n: v - a[k].get(n, 0) for n, v in b[k].items()}
                if isinstance(b[k], dict) else b[k] - a[k]) for k in b}


@pytest.mark.cuda
def test_traced_line_reads_the_programs_counters(card):
    """A 6 s traced window whose profiler covers its first panorama."""
    import simplepanorama_tpu_torch.ba as ba
    from panobench import cell as cellmod, devtrace, run
    marks, events = {}, []
    trace_cls = devtrace.DeviceTrace
    enter, leave, raw = trace_cls.__enter__, trace_cls.__exit__, \
        trace_cls.events
    load_cell, readers = cellmod.load_cell, cellmod.Cell.readers

    def entering(self):
        marks["start"] = _snap()
        return enter(self)

    def leaving(self, *exc):
        marks["stop"] = _snap()
        return leave(self, *exc)

    def kept(self):
        events.extend(raw(self))
        return events

    def one_traced(*a, **kw):
        c = load_cell(*a, **kw)
        c.traffic["trace_panoramas"] = 1
        return c

    def reading(self, defs):
        marks["read"] = _snap()
        return readers(self, defs)
    card.setattr(trace_cls, "__enter__", entering)
    card.setattr(trace_cls, "__exit__", leaving)
    card.setattr(trace_cls, "events", kept)
    card.setattr(cellmod, "load_cell", one_traced)
    card.setattr(cellmod.Cell, "readers", reading)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run.main(["--workload", CELL, "--seed", "3700000031",
                       "--seconds", "6", "--trace", "1"])
    assert rc == 0
    res = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert COUNTER_METRICS | STAGE_METRICS <= set(m), set(m)

    # the readers: the Timer's counters over every stitch of the process
    read = marks["read"]
    n = read["counts"]["bundle_adjust"]
    c = read["counters"]
    assert n >= 3          # the cold panorama and a window of two or more
    assert m["ba_trials_executed"] == pytest.approx(
        c["ba.trials_executed"] / n)
    assert m["ba_useful_trial_pct"] == pytest.approx(
        100 * c["ba.lm_trials"] / c["ba.trials_executed"])
    assert 0 < m["ba_useful_trial_pct"] <= 100
    assert m["mincut_outer_rounds"] == pytest.approx(c["mincut.outer"] / n)
    assert m["mincut_push_ms"] == pytest.approx(c["mincut.push_ns"] / n * 1e-6)
    assert m["mincut_bfs_ms"] == pytest.approx(c["mincut.bfs_ns"] / n * 1e-6)

    # the profiled panorama: the kernels' device clock against the
    # profiler's kernel time, and every trial executed launching kernel 3
    # as its captured graph does
    prof = _delta(marks["start"], marks["stop"])
    assert prof["counts"]["bundle_adjust"] == 1
    pc = prof["counters"]
    device_ms = (pc["mincut.push_ns"] + pc["mincut.bfs_ns"]) * 1e-6
    assert 0.8 * m["mincut_device_ms"] <= device_ms \
        <= 1.02 * m["mincut_device_ms"]
    assert prof["recorded"] == 0
    per_trial = {p.launches_per_trial for p in ba._PROGRAMS.values()}
    assert len(per_trial) == 1
    assert pc["ba.trials_executed"] * per_trial.pop() == prof["launches"]

    # the spans on the Timer's clock and as profiler ranges: one range a
    # flag read (one read every read_every trials), the Timer's time
    # inside the ranges, and the two within 5% where a range is long
    # against the profiler's own cost of one (0.04-0.15 ms on the H100's
    # host; a flag read is 0.3-0.6 ms, a solve ~60 ms)
    spans = tuple(k for k in marks["stop"]["durations"] if "." in k)
    summary = devtrace.summarize(events, run.STAGES + spans)
    ranges = {}
    for name, b, e in summary.stages:
        ranges.setdefault(name, []).append(e - b)
    rest = _delta(marks["stop"], read)
    print(json.dumps({"metrics": m, "profiled": prof, "rest": rest,
                      "ranges": {k: [len(v), sum(v)]
                                 for k, v in ranges.items()}}))
    flag = ranges["ba.flag_read"]
    read_every = {p.read_every for p in ba._PROGRAMS.values()}
    assert len(read_every) == 1
    assert len(flag) * read_every.pop() == pc["ba.trials_executed"]
    assert 0.999 * prof["durations"]["ba.flag_read"] <= sum(flag)
    for name in ("seams.solve", "bundle_adjust"):
        assert sum(ranges[name]) == pytest.approx(prof["durations"][name],
                                                  rel=0.05)

    # the spans inside their stages, over the panoramas after the profiler
    d = rest["durations"]
    assert rest["counts"]["bundle_adjust"] >= 1
    assert 0 < d["ba.flag_read"] <= d["bundle_adjust"]
    assert 0 <= d["features.decode_wait"] <= d["load"] + d["keypoints"]
