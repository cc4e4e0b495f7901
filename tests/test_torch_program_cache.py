"""The process's cache of LM programs (ba.program, ba.release_programs)
and LMProgram.load_data, on the CPU.

On the CPU a program runs its trial (ba.lm_step, with ops/ba_kernel's
plain sums) between reads of the flag, with no graph. CUDA graphs exist
only on the card, so where a test counts captures, the kept programs'
capture is replaced by one that runs the warm-up trial eagerly and binds
the program's buffers as they stand, as a captured graph binds their
addresses: its replay runs the trial on those tensor objects, so a
program that swapped a buffer instead of copying into it would replay
on stale tables (tests/test_torch_lm.py holds the trial against the JAX
package; tests/test_torch_cuda.py holds the cache's real graphs on the
card).
"""

import numpy as np
import pytest
import torch

from simplepanorama_tpu_torch import ba as tba
from simplepanorama_tpu_torch import stitch as tstitch

from test_torch_lm import _start, _to_torch
from test_torch_modules import _ba_problem

torch.set_num_threads(2)

CAP = 512      # match slots of every problem here: one bucket


class _BoundGraph:
    """The CPU stand-in of a captured trial: the state, problem and flag
    tensors of the program at capture time, and the trial run on them."""

    def __init__(self, prog):
        self.st, self.pb, self.live = prog.st, prog.pb, prog.live
        self.fast, self.tensors = prog.fast, prog._tensors
        self.replays = 0
        self.closed = False

    def replay(self):
        new = tba.lm_trial(self.st, self.pb, self.fast)
        for dst, src in zip(self.tensors(self.st), self.tensors(new)):
            dst.copy_(src)
        self.live.copy_(tba._live(new, self.pb.max_iter))
        self.replays += 1

    def reset(self):
        self.closed = True


@pytest.fixture
def cache(monkeypatch):
    """An empty program cache, released after the test."""
    monkeypatch.setattr(tba, "_PROGRAMS", {})
    yield
    tba.release_programs()


@pytest.fixture
def captures(cache, monkeypatch):
    """An empty program cache whose programs capture, as on the card:
    the kept programs' (ba.program) capture replaced by the eager warm-up
    trial and a _BoundGraph; a program made apart runs the CPU's loop.
    Yields the programs captured."""
    made = []

    def capture(self):
        self._store(tba.lm_trial(self.st, self.pb, self.fast))
        self.graph = _BoundGraph(self)
        self.capture_s = 0.0
        made.append(self)

    monkeypatch.setattr(tba.LMProgram, "_capture", capture)
    monkeypatch.setattr(tba.LMProgram, "graphed", property(
        lambda self: any(self is p for p in tba._PROGRAMS.values())))
    yield made


def _problem(seed, cap=CAP):
    """_ba_problem's tables of ``seed`` padded to ``cap`` match slots, with
    their pair tables (64 rows), and its start: focal 10% high, the
    rotations 0.02 rad off."""
    data, rot0, f = _ba_problem(seed=seed)
    data_t = _to_torch(data)
    M = data_t.mi.shape[0]
    pad = lambda t: torch.cat([t, t.new_zeros((cap - M, *t.shape[1:]))])
    data_t = tba.with_pair_tables(tba.BAData(
        mi=pad(data_t.mi), mj=pad(data_t.mj), q=pad(data_t.q),
        t=pad(data_t.t), m_valid=pad(data_t.m_valid), pi=None, pj=None,
        mp=None))
    return data_t, _start(4, f, rot0, data_t)


def _run(prog, cams):
    res, executed, _ = prog.run(cams, torch.ones(4, dtype=torch.bool), 0.05)
    return res, executed


def _kept(**kw):
    """ba.program's program for ``kw``, its lock let go."""
    with tba.program(**kw) as prog:
        return prog


def _same(a, b):
    """Two LMResults equal bit for bit."""
    assert int(a.n_iter) == int(b.n_iter)
    assert int(a.n_accepted) == int(b.n_accepted)
    for x, y in zip((*a.cams, a.error, a.lam), (*b.cams, b.error, b.lam)):
        assert torch.equal(x, y)


def test_problems_share_a_bucket_and_differ():
    """The two problems below have the same shapes (one program key) and
    other matches."""
    (a, _), (b, _) = _problem(5), _problem(6)
    assert tba._program_key(a, 4, False, 50) == \
        tba._program_key(b, 4, False, 50)
    assert int(a.m_valid.sum()) != int(b.m_valid.sum())
    assert not torch.equal(a.q, b.q)


@pytest.mark.parametrize("fast", [False, True])
def test_kept_program_replays_on_loaded_tables(captures, fast):
    """Problem A, then B, then A again through ba.program: one capture,
    and every run equal bit for bit to the CPU's run of that problem on
    a fresh LMProgram (its trial between reads, no capture) and to
    ba.lm_run on it: trials, accepted steps, cameras, error and
    lambda."""
    runs = {}
    for k, seed in enumerate((5, 6, 5)):
        data, cams = _problem(seed)
        with tba.program(data, 4, fast) as prog:
            got, executed = _run(prog, cams)
        fresh = tba.LMProgram(data, 4, fast)
        want, want_executed = _run(fresh, cams)
        _same(got, want)
        _same(got, tba.lm_run(cams, data, torch.ones(4, dtype=torch.bool),
                              0.05, fast=fast))
        # the kept program's warm-up trial ran in the first run only
        assert executed >= int(got.n_iter) and want_executed % 8 == 0
        assert executed == want_executed + (k == 0)
        if seed in runs:
            _same(got, runs[seed])
        runs[seed] = got
    assert len(captures) == 1          # the kept one
    assert len(tba._PROGRAMS) == 1
    assert int(runs[5].n_iter) != int(runs[6].n_iter) or \
        not torch.equal(runs[5].cams.focal, runs[6].cams.focal)


def test_program_owns_its_tables(cache):
    """The program copies the caller's tables: writing over them after
    ba.program returns changes nothing in its next run."""
    data, cams = _problem(5)
    with tba.program(data, 4, False) as prog:
        want, _ = _run(prog, cams)
        for t in data:
            t.zero_()
        got, _ = _run(prog, cams)
    _same(got, want)
    assert all(t.data_ptr() != u.data_ptr() for t, u in
               zip(prog.pb.data, data))
    assert prog.pb.mi.dtype == torch.int32
    assert prog.pb.mi.data_ptr() != prog.pb.data.mi.data_ptr()


def test_load_data_copies_in_place_and_refuses_other_shapes(cache):
    """load_data writes the new tables, and the int32 ids derived from
    them, into the tensors the graph was captured on; tables of another
    shape or type raise."""
    a, cams = _problem(5)
    b, _ = _problem(6)
    with tba.program(a, 4, False) as prog:
        _run(prog, cams)
    ptrs = [t.data_ptr() for t in (*prog.pb.data, prog.pb.mi, prog.pb.mj)]
    prog.load_data(b)
    assert ptrs == [t.data_ptr() for t in (*prog.pb.data, prog.pb.mi,
                                           prog.pb.mj)]
    for name, got, want in zip(tba.BAData._fields, prog.pb.data, b):
        assert torch.equal(got, want), name
    assert torch.equal(prog.pb.mi, b.mi.to(torch.int32))
    assert torch.equal(prog.pb.mj, b.mj.to(torch.int32))
    with pytest.raises(ValueError, match="mi"):
        prog.load_data(_problem(5, cap=1024)[0])
    with pytest.raises(ValueError, match="q"):
        prog.load_data(b._replace(q=b.q.double()))


def test_cache_key_takes_every_baked_shape(captures):
    """One kept program per device, objective, camera slots, match slots,
    pair rows and max_iter; the same key returns the same
    program, and release_programs() closes every graph and empties the
    cache."""
    data, cams = _problem(5)
    wide, _ = _problem(5, cap=1024)
    more_pairs = data._replace(pi=torch.cat([data.pi, data.pi]),
                               pj=torch.cat([data.pj, data.pj]))
    keys = [dict(data=data, n_cams=4, fast=False),
            dict(data=data, n_cams=4, fast=True),
            dict(data=data, n_cams=8, fast=False),
            dict(data=wide, n_cams=4, fast=False),
            dict(data=more_pairs, n_cams=4, fast=False),
            dict(data=data, n_cams=4, fast=False, max_iter=20)]
    progs = [_kept(**kw) for kw in keys]
    assert len({id(p) for p in progs}) == len(keys) == len(tba._PROGRAMS)
    assert _kept(**keys[0]) is progs[0]
    _run(progs[0], cams)
    _run(progs[0], cams)
    assert len(captures) == 1
    graph = progs[0].graph
    tba.release_programs()
    assert graph.closed and progs[0].graph is None and not tba._PROGRAMS


def test_lm_chunk_counts_only_its_own_captures(captures):
    """stitch._lm_chunk through a program: the chunk that captures counts
    one graph, a chunk on the kept program none and 0.0 s; both give the
    same cameras, and the error of their last run."""
    data, cams = _problem(5)
    L = 4
    H_pair = torch.eye(3).expand(L, 3, 3).contiguous()
    out = []
    for _ in range(2):
        active = torch.zeros(4, dtype=torch.bool)
        active[0] = True
        with tba.program(data, 4, False) as prog:
            cams_c, counts = tstitch._lm_chunk(
                cams, active, prog, 1, L, [0, 0, 1, 2], H_pair,
                np.arange(L), 0.05)
        out.append((cams_c, counts))
    (c1, n1), (c2, n2) = out
    assert (n1.graphs, n2.graphs) == (1, 0) and n2.capture_s == 0.0
    assert n1.runs == n2.runs == 3
    assert int(n1.trials) == int(n2.trials) >= 3
    for a, b in zip(c1, c2):
        assert torch.equal(a, b)
    assert torch.equal(n1.error, n2.error) and float(n1.error) > 0
