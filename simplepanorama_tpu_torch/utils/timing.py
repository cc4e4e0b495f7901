"""Named accumulating timers and counters: stages, spans and counts.

Port of simplepanorama_tpu/utils/timing.py (util::Timer semantics plus a
``stage`` context manager), with spans and counters added. One ``Timer``
holds all three, under one lock, so threads stitching at once neither
lose nor mix their records:

* a **stage** (``stage(name)``) is a pipeline step (``load``,
  ``keypoints``, ``bundle_adjust``, ...). With SPT_SYNC_STAGES set, the
  CUDA stream is drained at its end, so asynchronous device work is
  charged to the stage that queued it (it adds sync points, so
  throughput runs leave it off);
* a **span** (``span(name)``, dotted names such as ``ba.flag_read``) is
  a piece of work inside a stage: the same record as a stage, never
  drained, so a span adds no sync to the code it times;
* a **counter** (``Timer.add(name, n)``) sums numbers the program
  already has at hand: the LM trials a BA ran, a min-cut solve's rounds
  and device nanoseconds.

Stages and spans are timed once, by ``time.perf_counter`` into
``Timer.durations`` and ``Timer.counts``. With SPT_TRACE_DIR set, each
is also a ``torch.profiler.record_function`` range of its name at the
same boundaries (the range opens just before the Timer's start and
closes just after its stop, a stage's drain inside both), so under the
profiler it lies on the timeline that the device's work is read from. ``Timer.report()`` lists durations, then
counters.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional


class Timer:
    """Named accumulating timings (util::Timer semantics) and counters;
    ``record`` is the one way a timing is added."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.durations: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.counters: Dict[str, int] = defaultdict(int)

    def record(self, name: str, seconds: float) -> None:
        """Add one timed run of ``name``."""
        with self._lock:
            self.durations[name] += seconds
            self.counts[name] += 1

    def add(self, name: str, n) -> None:
        """Add ``n`` to the counter ``name``."""
        with self._lock:
            self.counters[name] += n

    def report(self) -> str:
        with self._lock:
            durations = sorted(self.durations.items(), key=lambda kv: -kv[1])
            counts = dict(self.counts)
            counters = sorted(self.counters.items())
        lines = [f"{k}: {v:.3f}s x{counts[k]}" for k, v in durations]
        lines += [f"{k}: {v}" for k, v in counters]
        return "\n".join(lines)


_GLOBAL = Timer()


def global_timer() -> Timer:
    return _GLOBAL


def _sync_device() -> None:
    """Wait for all work queued on the current CUDA device."""
    import torch
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def _timed(name: str, timer: Optional[Timer], drain: bool) -> Iterator[None]:
    t = timer or _GLOBAL
    ctx = contextlib.nullcontext()
    if os.environ.get("SPT_TRACE_DIR"):
        import torch
        ctx = torch.profiler.record_function(name)
    with ctx:   # the Timer's interval inside the range's, drain included
        t0 = time.perf_counter()   # in this frame: threads share no start
        try:
            yield
        finally:
            if drain and os.environ.get("SPT_SYNC_STAGES"):
                _sync_device()
            t.record(name, time.perf_counter() - t0)


def stage(name: str, timer: Optional[Timer] = None):
    """Time a pipeline stage (see module docstring for the env knobs)."""
    return _timed(name, timer, drain=True)


def span(name: str, timer: Optional[Timer] = None):
    """Time a piece of work inside a stage; never drains the stream."""
    return _timed(name, timer, drain=False)
