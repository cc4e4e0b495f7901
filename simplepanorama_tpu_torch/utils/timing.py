"""Named accumulating timers for pipeline stages.

Port of simplepanorama_tpu/utils/timing.py: util::Timer semantics plus a
``stage`` context manager. With SPT_SYNC_STAGES set, the CUDA stream is
drained at each stage boundary so asynchronous device work is charged to
the stage that launched it (it adds sync points, so throughput runs leave
it off). With SPT_TRACE_DIR set, each stage is a
``torch.profiler.record_function`` range.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional


class Timer:
    """Named accumulating stopwatch (util::Timer semantics)."""

    def __init__(self) -> None:
        self._start: Dict[str, float] = {}
        self.durations: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    def start(self, name: str) -> None:
        self._start[name] = time.perf_counter()

    def stop(self, name: str) -> float:
        t0 = self._start.pop(name, None)
        if t0 is None:
            return 0.0
        dt = time.perf_counter() - t0
        self.durations[name] += dt
        self.counts[name] += 1
        return dt

    def report(self) -> str:
        lines = [f"{k}: {v:.3f}s x{self.counts[k]}"
                 for k, v in sorted(self.durations.items(),
                                    key=lambda kv: -kv[1])]
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
def stage(name: str, timer: Optional[Timer] = None) -> Iterator[None]:
    """Time a pipeline stage (see module docstring for the env knobs)."""
    t = timer or _GLOBAL
    ctx = contextlib.nullcontext()
    if os.environ.get("SPT_TRACE_DIR"):
        import torch
        ctx = torch.profiler.record_function(name)
    t.start(name)
    try:
        with ctx:
            yield
    finally:
        if os.environ.get("SPT_SYNC_STAGES"):
            _sync_device()
        t.stop(name)
