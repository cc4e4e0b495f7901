"""The port's LM loop (ba.lm_trial, the predicated loop, the chunk driver
stitch.bundle_adjust_stitching) against the JAX package, on the CPU.

Inputs are made from numpy seeds and handed to both packages. On the CPU
the trial sums its camera system with ops/ba_kernel's plain version and
runs through an LMProgram's loop, as on the card; there the trial is
kernels 4, 3 and 5 replayed as a CUDA graph (tests/test_torch_cuda.py
holds it against a float64 run of this one).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from simplepanorama_tpu import Config as JConfig
from simplepanorama_tpu import ba as jba
from simplepanorama_tpu import stitch as jstitch
from simplepanorama_tpu.adjacency import Adjacency as JAdjacency
from simplepanorama_tpu.geometry import rotation as jrot
from simplepanorama_tpu.geometry.graph import Component as JComponent
from simplepanorama_tpu_torch import Config as TConfig
from simplepanorama_tpu_torch import ba as tba
from simplepanorama_tpu_torch import stitch as tstitch
from simplepanorama_tpu_torch.utils.timing import global_timer

from test_torch_modules import _ba_problem

torch.set_num_threads(2)


def _to_torch(data):
    T = lambda a, dt=None: torch.as_tensor(np.array(a), dtype=dt)
    return tba.BAData(
        mi=T(data.mi, torch.int64), mj=T(data.mj, torch.int64),
        q=T(data.q), t=T(data.t), m_valid=T(data.m_valid),
        pi=T(data.pi, torch.int64), pj=T(data.pj, torch.int64),
        mp=T(data.mp, torch.int64))


def _start(n, f, rot0, data_t):
    """The perturbed start of test_lm_run_matches_jax, ``n`` camera
    slots (slots past rot0 at the identity rotation)."""
    rot = np.zeros((n, 3), np.float32)
    rot[:len(rot0)] = rot0
    return tba.CamState(focal=torch.full((n,), f * 1.1),
                        ppal=torch.zeros((n, 2)),
                        rotvec=torch.from_numpy(rot), b=data_t.t.clone())


def test_singular_trial_is_rejected_as_in_jax():
    """A fifth camera that is active and touched by no match makes every
    trial's camera system singular. jnp.linalg.solve returns non-finite
    values there and the LM rejects the trial; the port's solve
    (solve_ex) does the same instead of raising: 6 trials, none
    accepted, cameras unchanged, the error of the start within 1e-5
    relative (measured 2.0e-7: the same start error in both packages to
    float32 rounding)."""
    data, rot0, f = _ba_problem()
    n = 5
    rot = np.zeros((n, 3), np.float32)
    rot[:4] = rot0
    rj = jba.lm_run(jba.CamState(focal=jnp.full((n,), f * 1.1, jnp.float32),
                                 ppal=jnp.zeros((n, 2), jnp.float32),
                                 rotvec=jnp.asarray(rot), b=data.t),
                    data, jnp.ones(n, bool), 0.05, max_iter=50)
    data_t = _to_torch(data)
    cams = _start(n, f, rot0, data_t)
    rt = tba.lm_run(cams, data_t, torch.ones(n, dtype=torch.bool), 0.05,
                    max_iter=50)
    assert int(rj.n_iter) == int(rt.n_iter) == 6
    assert int(rj.n_accepted) == int(rt.n_accepted) == 0
    for got, start in zip(rt.cams, cams):
        assert torch.equal(got, start)
    np.testing.assert_allclose(np.asarray(rj.cams.focal), 550.0)
    np.testing.assert_allclose(float(rt.error), float(rj.error), rtol=1e-5)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("read_every", [1, 7, 50])
def test_read_every_does_not_change_the_run(read_every, fast, monkeypatch):
    """A trial after the run has ended is an exact no-op, so a program
    made to read the termination flag every 1, 7 or 50 trials
    (ba.READ_EVERY set to that) gives the run of the default bit for bit:
    trials, accepted steps, lambda, error and cameras."""
    data, rot0, f = _ba_problem()
    data_t = _to_torch(data)
    act = torch.ones(4, dtype=torch.bool)
    want, _, _ = tba.LMProgram(data_t, 4, fast).run(
        _start(4, f, rot0, data_t), act, 0.05)
    monkeypatch.setattr(tba, "READ_EVERY", read_every)
    got, executed, reads = tba.LMProgram(data_t, 4, fast).run(
        _start(4, f, rot0, data_t), act, 0.05)
    assert executed == reads * read_every >= int(got.n_iter)
    assert int(got.n_iter) == int(want.n_iter)
    assert int(got.n_accepted) == int(want.n_accepted)
    for a, b in zip((*got.cams, got.lam, got.error),
                    (*want.cams, want.lam, want.error)):
        assert torch.equal(a, b)


def test_back_substitution_by_gathers_matches_dense_W():
    """db from W's two 6-row blocks and two gathers of da equals the dense
    form V^-1 (e_B - W^T da), W (M, 6N, 2) of ba._assemble_cache. W^T da
    within 1e-6 relative (measured 9.0e-8: the same products summed over
    12 rows instead of 6N); db within 1e-6 of max|V^-1 e_B| (measured
    1.2e-7), the scale of the two terms whose difference db is: e_B and
    W^T da cancel to a thousandth, so both forms sit 1.7e-6 of max|db|
    from a float64 evaluation, and 1.7e-6 of it from each other."""
    data, rot0, f = _ba_problem()
    data_t = _to_torch(data)
    n = 4
    cams = _start(n, f, rot0, data_t)
    act = torch.ones(n, dtype=torch.bool)
    am = tba._active_matches(data_t, act)
    lam = torch.tensor(0.05)
    cache = tba._assemble_cache(cams, data_t, am, act, n)
    S, rhs, Vinv = tba._schur_solve_system(cache, am, lam, act)
    da = tba._solve_preconditioned(S, rhs)
    wtd = (cache.W * da[None, :, None]).sum(1)
    want = (Vinv * (cache.eB - wtd)[:, None, :]).sum(2)
    r, Ai, Aj, B = tba._jacobian_streams(cams, data_t, am, False)
    # e_B = 0 gives -V^-1 W^T da: the gathered product alone
    zero = torch.zeros_like(cache.eB)
    eye = torch.eye(2).expand_as(Vinv)
    wtd_g = -tba._back_substitute(Ai, Aj, B[:, 2:], zero, eye, da, data_t)
    err = float((wtd_g - wtd).abs().max() / wtd.abs().max())
    assert err <= 1e-6, err
    got = tba._back_substitute(Ai, Aj, B[:, 2:], cache.eB, Vinv, da,
                               data_t)
    scale = float((Vinv * cache.eB[:, None, :]).sum(2).abs().max())
    err = float((got - want).abs().max()) / scale
    assert err <= 1e-6, err


def _component(seed=3, n=5, f=420.0, n_per_pair=90, noise=0.3):
    """A 5-view yaw arc as the matching stage would hand it over: the
    JAX package's Component and Adjacency, with the true pairwise
    homographies and noisy matches from the BA model (both packages read
    the same numpy tables)."""
    rng = np.random.default_rng(seed)
    rv = [np.array([0.01 * i, 0.25 * i, -0.01 * i]) for i in range(n)]
    R = [np.asarray(jrot.rodrigues(jnp.asarray(v, jnp.float32)), np.float64)
         for v in rv]
    K = np.diag([f, f, 1.0])
    adj = np.zeros((n, n))
    hom = np.tile(np.eye(3), (n, n, 1, 1))
    matches = {}
    for i in range(n):
        for j in range(n):
            if abs(i - j) != 1:
                continue
            H = K @ R[i].T @ R[j] @ np.linalg.inv(K)   # image j -> image i
            hom[i, j] = H / H[2, 2]
            t = rng.uniform(-160, 160, (n_per_pair, 2))
            th = np.concatenate([t, np.ones((n_per_pair, 1))], 1) @ H.T
            q = th[:, :2] / th[:, 2:3]
            keep = (np.abs(q) < 200).all(1)
            q = q[keep] + rng.normal(0, noise, (keep.sum(), 2))
            matches[i, j] = (q.astype(np.float32),
                             t[keep].astype(np.float32))
            if i < j:
                adj[i, j] = 40.0 - i
    adj_sym = adj + adj.T
    conn = adj_sym.sum(1) / (adj_sym == 0).sum(1)
    comp = JComponent(adj=adj, connectivity=conn, nodes=list(range(n)))
    adjres = JAdjacency(adj=adj, raw_counts=np.zeros((n, n)), hom_mat=hom,
                        matches=matches)
    return comp, adjres, [(320, 400)] * n, f * 1.08


@pytest.mark.parametrize("fast", [False, True])
def test_bundle_adjust_stitching_matches_jax(fast):
    """The incremental BA of one 5-view component through the port's
    chunk driver (a program a chunk on the CPU, ba.lm_step between
    reads) against the JAX package's
    fused program (one compiled program per chunk), relaxed and Lowe
    objectives, from the same component, matches and homographies (the
    matching stage's RANSAC is not run, so no draws need injecting).
    Focals within 1e-3 relative (measured 1.1e-6 relaxed, 2.8e-5 Lowe),
    rotations within 1e-3 (measured 3.2e-7, 1.4e-5), K's other entries
    within 1e-3 relative."""
    comp, adjres, sizes, focal = _component()
    rj = jstitch.bundle_adjust_stitching(comp, adjres, sizes, focal,
                                         JConfig(fast=fast), fused=True)
    calls = []
    chunk = tstitch._lm_chunk

    def counted(*a, **kw):
        out = chunk(*a, **kw)
        calls.append(out[1])
        return out
    tstitch._lm_chunk = counted
    counters = global_timer().counters
    before = dict(counters)
    try:
        rt = tstitch.bundle_adjust_stitching(comp, adjres, sizes, focal,
                                             TConfig(fast=fast),
                                             device="cpu")
    finally:
        tstitch._lm_chunk = chunk
    assert rt.order == rj.order and rt.nodes == rj.nodes
    assert sum(c.runs for c in calls) == len(comp.nodes) - 1
    assert all(c.graphs == 0 for c in calls)   # no graph on the CPU
    # the chunks' counts reach the timer's counters
    delta = {k: counters[k] - before.get(k, 0)
             for k in ("ba.trials_executed", "ba.lm_trials")}
    assert delta["ba.trials_executed"] == sum(c.executed for c in calls)
    assert delta["ba.lm_trials"] == sum(int(c.trials) for c in calls)
    assert 0 < delta["ba.lm_trials"] <= delta["ba.trials_executed"]
    fj, ft = np.asarray(rj.K)[:, 0, 0], rt.K[:, 0, 0]
    np.testing.assert_allclose(ft, fj, rtol=1e-3)
    np.testing.assert_allclose(rt.K, rj.K, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(rt.rot, np.asarray(rj.rot), atol=1e-3)
