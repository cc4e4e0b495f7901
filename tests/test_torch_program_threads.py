"""Kept LM programs shared by threads (ba.program), on the CPU.

A kept ba.LMProgram holds one problem's match tables at a time: load_data
copies them in, run replays on them. Stitches in several threads take
it through ba.program, whose lock spans the chunk (stitch._lm_chunk)
from the load to the last run. LMProgram is replaced here by a stub that
notes which thread loaded it and sleeps between the load and each run,
so a load of another thread in between would be seen by the run.
"""

import concurrent.futures
import sys
import threading
import time

import numpy as np
import torch

from simplepanorama_tpu_torch import ba as tba
from simplepanorama_tpu_torch import stitch as tstitch

from test_torch_program_cache import _problem

torch.set_num_threads(2)

L = 4             # cameras added in a chunk: three runs (additions 1-3)


class _Stub:
    """An LMProgram that only notes its loads and runs: a run raises if a
    thread other than its own loaded the program since its load. With
    ``meet``, each program's first run waits there for the other
    threads' first runs."""

    meet = None
    trial_kernels = True   # a single-card program: kernels 4, 3 and 5

    def __init__(self, data, n_cams, fast, max_iter=50, read_every=8):
        self.graph, self.capture_s = None, 0.0
        self.loaded_by = threading.get_ident()
        self.runs = 0

    def load_data(self, data):
        self.loaded_by = threading.get_ident()
        time.sleep(0.002)

    def run(self, cams, cam_active, lambda0, vaug_idx=None):
        if self.runs == 0 and self.meet is not None:
            self.meet.wait()
        self.runs += 1
        time.sleep(0.002)
        if self.loaded_by != threading.get_ident():
            raise AssertionError("another thread loaded the program "
                                 "between this thread's load and run")
        z = torch.zeros((), dtype=torch.int64)
        return tba.LMResult(cams=cams, error=torch.zeros(()),
                            lam=torch.zeros(()), n_accepted=z,
                            n_iter=z + 1), 1, 1


def _chunks(data, cams, n):
    """``n`` chunks of additions 1..L-1 on one kept program, each as
    bundle_adjust_stitching runs a chunk on the card."""
    H_pair = torch.eye(3).expand(L, 3, 3).contiguous()
    for _ in range(n):
        active = torch.zeros(4, dtype=torch.bool)
        active[0] = True
        with tba.program(data, 4, False) as prog:
            tstitch._lm_chunk(cams, active, data, 1, L, [0, 0, 1, 2],
                              H_pair, np.arange(L), 0.05, False, prog)
    return n


def _in_threads(monkeypatch, problems, chunks):
    """Each problem's chunks in a thread of its own, all at once, with the
    switch interval shortened; returns the chunks each thread ran."""
    monkeypatch.setattr(tba, "_PROGRAMS", {})
    monkeypatch.setattr(tba, "_PROGRAM_LOCKS", {})
    monkeypatch.setattr(tba, "LMProgram", _Stub)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with concurrent.futures.ThreadPoolExecutor(len(problems)) as ex:
            futs = [ex.submit(_chunks, data, cams, chunks)
                    for data, cams in problems]
            return [f.result(timeout=60) for f in futs]
    finally:
        sys.setswitchinterval(interval)


def test_threads_on_one_key_never_interleave(monkeypatch):
    """Six threads, each with its own problem of one bucket (one key),
    eight chunks each: every run finds the program loaded by its own
    thread, and one program served them all."""
    problems = [_problem(5 + k % 2) for k in range(6)]
    assert len({tba._program_key(d, 4, False, 50, 8)
                for d, _ in problems}) == 1
    assert _in_threads(monkeypatch, problems, 8) == [8] * 6
    assert len(tba._PROGRAMS) == 1


def test_threads_on_two_keys_run_at_once(monkeypatch):
    """Two threads on problems of two buckets (512 and 1024 match slots):
    each program's first run waits at a barrier for the other's, which a
    lock shared by the two keys would never let it reach."""
    problems = [_problem(5), _problem(6, cap=1024)]
    monkeypatch.setattr(_Stub, "meet", threading.Barrier(2, timeout=30))
    assert _in_threads(monkeypatch, problems, 2) == [2, 2]
    assert len(tba._PROGRAMS) == 2


def test_eager_runs_in_two_threads_equal_alone():
    """Two LM runs at once in two threads, as two stitches on the CPU run
    them (ba.lm_run_eager: the chain rule and the hand-written pair
    Jacobian in every trial, no AD and no lock between the threads):
    each equals its run alone, bit for bit."""
    problems = [_problem(5), _problem(6)]
    active = torch.ones(4, dtype=torch.bool)

    def run(k, meet=None):
        data, cams = problems[k]
        if meet is not None:
            meet.wait()
        return tba.lm_run_eager(cams, data, active, 0.05, max_iter=12)[0]
    alone = [run(k) for k in (0, 1)]
    meet = threading.Barrier(2, timeout=30)
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        both = [f.result(timeout=120) for f in
                [ex.submit(run, k, meet) for k in (0, 1)]]
    for a, b in zip(alone, both):
        assert int(a.n_iter) == int(b.n_iter) == 12
        for x, y in zip((*a.cams, a.error), (*b.cams, b.error)):
            assert torch.equal(x, y)
