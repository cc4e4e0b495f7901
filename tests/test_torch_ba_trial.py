"""The single-card LM trial (ba.fused_trial: kernels 4, 3 and 5 on the
card) through its plain versions on the CPU, against ba.lm_step, and the
counter of trials it runs.

On the CPU ops/ba_trial's wrappers take ba.trial_streams_ref and
ba.solve_accept_ref and ops/ba_kernel's takes assemble_streams_ref, so
the chain is the plain version of the card's three kernels;
tests/test_torch_cuda.py holds the kernels against it on the card.
"""

import numpy as np
import pytest
import torch

from simplepanorama_tpu_torch import ba
from simplepanorama_tpu_torch import stitch as tstitch
from simplepanorama_tpu_torch.fixtures import lm_trial_problem
from simplepanorama_tpu_torch.utils.timing import global_timer

torch.set_num_threads(2)

# (fixture arguments, what the trial must do): every problem has camera 0
# at the identity rotation, which the trial keeps frozen
PROBLEMS = {
    "plain": (dict(), "accept"),
    "inactive_cameras": (dict(inactive=2), "accept"),
    "id_outside_table": (dict(outside=True), None),
    "singular": (dict(idle_camera=True), "reject"),
    "after_the_end": (dict(), "no-op"),
}


def _state(kind, fast, n_cams=8, M=1024):
    kw, _ = PROBLEMS[kind]
    cams, data, active = lm_trial_problem(n_cams, M, seed=3, **kw)
    pb = ba.lm_problem(data, active, max_iter=20)
    st = ba.lm_init(cams, pb, 0.05, fast)
    if kind == "after_the_end":
        st = st._replace(it=pb.max_iter.clone())
    return st, pb


def _fields(st):
    return (*st.cams, st.err, st.lam, st.it, st.strikes, st.n_acc)


def _copy(st):
    return ba.LMState(ba.CamState(*(t.clone() for t in st.cams)),
                      *(t.clone() for t in st[1:]))


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("kind", sorted(PROBLEMS))
def test_fused_trial_equals_lm_step(kind, fast):
    """The plain versions of kernels 4 and 5 chained with
    assemble_streams_ref (ba.fused_trial on CPU tensors, in place) give
    ba.lm_step's state bit for bit, and the termination flag of that
    state, on problems with inactive cameras, a camera id outside the
    table, a singular system (rejected: the state keeps its cameras and
    error) and a trial after the run's end (a no-op), in both
    objectives. Camera 0, at the identity, keeps its rotation."""
    st, pb = _state(kind, fast)
    want, err_new = ba.lm_step(st, pb, fast)
    got = _copy(st)
    live = torch.ones((), dtype=torch.bool)
    ba.fused_trial(got, pb, fast, live)
    for a, b in zip(_fields(got), _fields(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert bool(live) == bool(ba._live(want, pb.max_iter))
    assert torch.equal(got.cams.rotvec[0], st.cams.rotvec[0])
    accepted = int(got.n_acc) == 1
    expect = PROBLEMS[kind][1]
    if expect == "accept":
        assert accepted and float(got.err) < float(st.err)
        assert int(got.it) == 1 and float(got.lam) < float(st.lam)
    elif expect == "reject":
        assert not accepted and not torch.isfinite(err_new)
        for a, b in zip(_fields(got)[:5], _fields(st)[:5]):
            assert torch.equal(a, b)
        assert int(got.strikes) == 1
    elif expect == "no-op":
        for a, b in zip(_fields(got), _fields(st)):
            assert torch.equal(a, b)
        assert not bool(live)


@pytest.mark.parametrize("fast", [False, True])
def test_fused_trials_run_as_eager_trials(fast):
    """Twelve trials through ba.fused_trial equal twelve ba.lm_trial
    calls bit for bit, accepted and rejected ones alike."""
    st, pb = _state("inactive_cameras", fast)
    got = _copy(st)
    live = torch.ones((), dtype=torch.bool)
    for _ in range(12):
        st = ba.lm_trial(st, pb, fast)
        ba.fused_trial(got, pb, fast, live)
        for a, b in zip(_fields(got), _fields(st)):
            assert torch.equal(a, b)
    assert 0 < int(st.n_acc) < 12


class _Replay:
    """The CPU stand-in of a captured trial: the program's own trial on
    its buffers (tests/test_torch_program_cache.py)."""

    def __init__(self, prog):
        self.prog = prog

    def replay(self):
        self.prog.trial()

    def reset(self):
        pass


@pytest.mark.parametrize("fast", [False, True])
def test_program_counts_fused_trials(fast, monkeypatch):
    """A single-card LMProgram with its capture replaced by one that
    replays the program's own trial: a chunk through it counts every
    trial executed (the warm-up included) as fused, and ba.fused_trials
    in the timer's counters rises with ba.trials_executed; an eager
    chunk counts none. The program's runs equal the eager LM's."""

    def capture(self):
        self.trial()
        self.graph = _Replay(self)
        self.capture_s = 0.0
    monkeypatch.setattr(ba.LMProgram, "_capture", capture)
    cams, data, active = lm_trial_problem(8, 1024, seed=4)
    prog = ba.LMProgram(data, 8, fast)
    assert prog.trial_kernels and prog.tw is None

    def chunk(program):
        act = active.clone()
        act[3:] = False
        H = torch.eye(3).expand(8, 3, 3)
        return tstitch._lm_chunk(cams, act, data, 3, 5, [2] * 8, H,
                                 np.arange(8), 0.05, fast, program)
    counters = global_timer().counters
    before = dict(counters)
    (c_p, k_p), (c_e, k_e) = chunk(prog), chunk(None)
    tstitch._count_trials([k_p, k_e])
    assert k_p.fused == k_p.executed > int(k_p.trials) > 0
    assert k_e.fused == 0 and k_e.executed > 0
    assert int(k_p.trials) == int(k_e.trials)
    for a, b in zip(c_p, c_e):
        assert torch.equal(a, b)
    delta = {k: counters.get(k, 0) - before.get(k, 0)
             for k in ("ba.trials_executed", "ba.fused_trials")}
    assert delta["ba.fused_trials"] == k_p.executed
    assert delta["ba.trials_executed"] == k_p.executed + k_e.executed


@pytest.mark.parametrize("with_schur", [True, False])
def test_plain_assembly_keeps_float64(with_schur):
    """ops/ba_kernel.assemble_streams_ref on float64 streams returns
    float64 sums (the float64 LM run the card's float32 runs are held
    to): the float32 sums of the same streams within 1e-5 of their
    largest entry (the Schur terms' float32 products), U and J^T r,
    float32 products of float32 streams either way, equal once
    rounded."""
    from simplepanorama_tpu_torch.ops import ba_kernel
    cams, data, active = lm_trial_problem(8, 1024, seed=4, inactive=1)
    pb = ba.lm_problem(data, active)
    st = ba.lm_init(cams, pb, 0.05, not with_schur)
    ts = ba.trial_streams_ref(st, pb, not with_schur)
    f32 = ba_kernel.assemble_streams_ref(*ts[:9], pb.mi, pb.mj, 8,
                                         with_schur=with_schur)
    f64 = ba_kernel.assemble_streams_ref(*(t.double() for t in ts[:9]),
                                         pb.mi, pb.mj, 8,
                                         with_schur=with_schur)
    for a, b in zip(f32, f64):
        assert b.dtype == torch.float64
        scale = max(float(b.abs().max()), 1.0)
        assert float((a.double() - b).abs().max()) <= 1e-5 * scale
    for a, b in zip(f32[:2], f64[:2]):
        assert torch.equal(a, b.float())


@pytest.mark.parametrize("reach", [2, 8])
def test_lm_trial_problem_reach(reach):
    """fixtures.lm_trial_problem matches each camera with its next
    ``reach``, both directions: 2 (n - 1) + 2 (n - 2) + ... pair rows,
    the card tests' tables beyond a CTA's shared memory at reach 8."""
    n = 40
    _, data, _ = lm_trial_problem(n, 20480, seed=1, reach=reach)
    pairs = {(int(i), int(j)) for i, j in zip(data.mi, data.mj)
             if i != j}
    want = {(i, j) for i in range(n) for j in range(n)
            if 0 < abs(i - j) <= reach}
    assert pairs == want
