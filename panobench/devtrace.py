"""The device's timeline over a traced window, from ``torch.profiler``.

``DeviceTrace`` profiles the CPU and the card over the window; the
benchmark marks each request as a ``record_function`` range named
``panobench.<kind>``, and the program marks each stage as a range of the
stage's name when ``SPT_TRACE_DIR`` is set (``utils/timing.stage``).
``summarize`` turns the trace into what the metric readers need: the
device's busy intervals, each kernel's total time, the requests' and
stages' spans. The profiler's raw events are read directly, not through
``key_averages``, which builds a Python object per event (a stitch
replays some hundreds of thousands of kernels in its BA graphs).
"""

from __future__ import annotations

import bisect
import dataclasses
import re
from typing import Dict, List, Tuple

REQUEST_PREFIX = "panobench."


@dataclasses.dataclass
class Summary:
    window: Tuple[float, float]            # seconds, the profiler's clock
    busy: List[Tuple[float, float]]        # merged device intervals
    kernel_s: Dict[str, float]             # device seconds by op name
    requests: List[Tuple[str, float, float]]   # (kind, start, end)
    stages: List[Tuple[str, float, float]]     # (name, start, end)

    def busy_in(self, spans: List[Tuple[float, float]]) -> float:
        """Device-busy seconds inside ``spans``."""
        starts = [b0 for b0, _ in self.busy]
        total = 0.0
        for s0, s1 in spans:
            k = max(bisect.bisect_right(starts, s0) - 1, 0)
            while k < len(self.busy) and self.busy[k][0] < s1:
                lo, hi = max(s0, self.busy[k][0]), min(s1, self.busy[k][1])
                if hi > lo:
                    total += hi - lo
                k += 1
        return total

    def kernels_matching(self, names) -> float:
        """Device seconds of the ops named after one of the functions
        ``names`` (the demangled name, any namespace, then its
        arguments)."""
        pats = [re.compile(r"(?:^|[:\s])" + re.escape(k) + r"\(")
                for k in names]
        return sum(s for n, s in self.kernel_s.items()
                   if any(p.search(n) for p in pats))


class DeviceTrace:
    def __init__(self) -> None:
        import torch
        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA])

    def __enter__(self) -> "DeviceTrace":
        self._prof.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._prof.__exit__(*exc)

    def events(self):
        """(name, on_device, start_s, end_s) of every raw event."""
        import torch
        res = self._prof.profiler.kineto_results
        cuda = torch.autograd.DeviceType.CUDA
        out = []
        for e in res.events():
            t0 = e.start_ns() * 1e-9
            out.append((e.name(), e.device_type() == cuda, t0,
                        t0 + e.duration_ns() * 1e-9))
        return out


def summarize(events, stage_names) -> Summary:
    """The window is the span of the requests traced."""
    dev = []
    kernel_s: Dict[str, float] = {}
    requests, stages = [], []
    stage_names = set(stage_names)
    # a profiler range also shows on the device's timeline under its
    # name (a "gpu user annotation"): only the card's own operations,
    # whose names no host event has, count as device work
    host_names = {name for name, on_device, _, _ in events if not on_device}
    for name, on_device, t0, t1 in events:
        if on_device and name in host_names:
            continue
        if on_device:
            if t1 > t0:
                dev.append((t0, t1))
                kernel_s[name] = kernel_s.get(name, 0.0) + (t1 - t0)
        elif name.startswith(REQUEST_PREFIX):
            requests.append((name[len(REQUEST_PREFIX):], t0, t1))
        elif name in stage_names:
            stages.append((name, t0, t1))
    requests.sort(key=lambda r: r[1])
    window = ((requests[0][1], requests[-1][2]) if requests else (0.0, 0.0))
    dev.sort()
    busy: List[Tuple[float, float]] = []
    for t0, t1 in dev:
        t0, t1 = max(t0, window[0]), min(t1, window[1])
        if t1 <= t0:
            continue
        if busy and t0 <= busy[-1][1]:
            busy[-1] = (busy[-1][0], max(busy[-1][1], t1))
        else:
            busy.append((t0, t1))
    return Summary(window=window, busy=busy, kernel_s=kernel_s,
                   requests=requests, stages=stages)


def idle_gaps(s: Summary, top: int = 10) -> List[list]:
    """The longest gaps between device work inside the window, each
    named by the innermost stage (else the request) the host was in at
    the gap's middle."""
    gaps = []
    edges = [(s.window[0], s.window[0])] + s.busy + \
        [(s.window[1], s.window[1])]
    for (_, a), (b, _) in zip(edges, edges[1:]):
        if b > a:
            gaps.append((b - a, (a + b) / 2))
    gaps.sort(reverse=True)
    out = []
    for length, mid in gaps[:top]:
        where = [(e - b, n) for n, b, e in s.stages if b <= mid <= e]
        if where:
            name = min(where)[1]
        else:
            reqs = [k for k, b, e in s.requests if b <= mid <= e]
            name = f"request {reqs[0]}, no stage" if reqs \
                else "between requests"
        out.append([name, length])
    return out


def top_ops(s: Summary, top: int = 10) -> List[list]:
    ops = sorted(s.kernel_s.items(), key=lambda kv: -kv[1])[:top]
    return [[n[:160], v] for n, v in ops]
