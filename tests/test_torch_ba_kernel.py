"""The port's BA normal-equation streams (ops/ba_kernel.py) against the
JAX package, on the CPU.

The plain version is held against the JAX package's reference and its
Pallas kernel in interpret mode; the streams rebuilt from a BA state
against the port's own assembly (ba._assemble_cache and
_schur_solve_system) and the JAX package's ba._assemble, for the relaxed
objective and the Lowe one. The CUDA kernel itself runs only on the card
(tests/test_torch_cuda.py); on CPU tensors the wrapper is the plain
version.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from simplepanorama_tpu import ba as jba
from simplepanorama_tpu.ops import ba_kernel as jbk
from simplepanorama_tpu_torch import ba as tba
from simplepanorama_tpu_torch.ops import ba_kernel as tbk

torch.set_num_threads(2)


def _streams(M=1024, N=8, seed=0):
    """The synthetic streams of tests/test_ba_kernel.py, as numpy."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)
    ai, aj = f32(M, 2, 6), f32(M, 2, 6)
    bp, r2 = f32(M, 2, 2), f32(M, 2)
    l00 = rng.uniform(0.5, 1, (M,)).astype(np.float32)
    l10 = f32(M)
    l11 = rng.uniform(0.5, 1, (M,)).astype(np.float32)
    g0, g1 = f32(M), f32(M)
    mi = rng.integers(0, N - 1, M).astype(np.int32)
    mj = (mi + 1).astype(np.int32)
    return [ai, aj, bp, r2, l00, l10, l11, g0, g1, mi, mj]


def _close(a, b, name, rel=1e-3, floor=1e-4):
    """The TPU kernel's own test bound: max|a - b| <= rel * max|a| +
    floor (f32 sums taken in another order)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, name
    assert np.abs(a - b).max() <= rel * np.abs(a).max() + floor, name


@pytest.mark.parametrize("with_schur", [True, False])
def test_plain_version_matches_jax(with_schur):
    """assemble_streams_ref of the port against the JAX reference and
    the JAX Pallas kernel in interpret mode (N=8, M=1024). Tolerance:
    1e-5 of the output's max against the JAX reference (both are the
    same dense f32 products; measured under 1e-6) and the TPU kernel
    test's 1e-3 * max + 1e-4 against the kernel."""
    args = _streams()
    jargs = [jnp.asarray(a) for a in args]
    ref_j = jbk.assemble_streams_ref(*jargs, 8, with_schur=with_schur)
    ker_j = jbk.assemble_streams(*jargs, 8, with_schur=with_schur,
                                 interpret=True)
    out = tbk.assemble_streams_ref(*[torch.from_numpy(a) for a in args], 8,
                                   with_schur=with_schur)
    for name, o, rj, kj in zip(["U", "eA", "YW", "yeb"], out, ref_j, ker_j):
        _close(rj, o.numpy(), name, rel=1e-5, floor=0.0)
        _close(kj, o.numpy(), name)
    if not with_schur:
        assert not out[2].any() and not out[3].any()


@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_wrapper_on_cpu_is_the_plain_version(id_dtype):
    """On CPU tensors assemble_streams returns the plain version's
    outputs exactly, with int32 or int64 camera ids, and counts no
    launch."""
    args = [torch.from_numpy(a) for a in _streams(seed=3)]
    args[9], args[10] = args[9].to(id_dtype), args[10].to(id_dtype)
    before = tbk.assemble_streams.launches
    got = tbk.assemble_streams(*args, 8)
    want = tbk.assemble_streams_ref(*args, 8)
    assert tbk.assemble_streams.launches == before
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.equal(g, w)


def test_ids_outside_the_cameras_contribute_nothing():
    """A match whose camera id is >= N (or negative) adds nothing at that
    id, as the one-hot compare of the JAX kernel gives: the outputs equal
    those of the same streams with that side's Jacobian rows zeroed and
    its id moved into range. Tolerance: 1e-6 of the max (the same terms,
    summed in the same order)."""
    args = _streams(seed=4)
    ai, aj, mi, mj = args[0].copy(), args[1].copy(), args[9].copy(), \
        args[10].copy()
    out_i = np.arange(0, 1024, 7)
    out_j = np.arange(3, 1024, 11)
    mi[out_i] = 8 + (out_i % 3)
    mj[out_j] = -1
    bad = list(args)
    bad[9], bad[10] = mi, mj
    good = list(args)
    ai[out_i] = 0.0
    aj[out_j] = 0.0
    good[0], good[1] = ai, aj
    good[9] = np.where(mi >= 8, 0, mi).astype(np.int32)
    good[10] = np.where(mj < 0, 0, mj).astype(np.int32)
    for schur in (True, False):
        got = tbk.assemble_streams(*[torch.from_numpy(a) for a in bad], 8,
                                   with_schur=schur)
        want = tbk.assemble_streams_ref(*[torch.from_numpy(a)
                                          for a in good], 8,
                                        with_schur=schur)
        for name, g, w in zip(["U", "eA", "YW", "yeb"], got, want):
            _close(w.numpy(), g.numpy(), name, rel=1e-6, floor=0.0)


@pytest.mark.parametrize("M", [1000, 1536 + 100, 0])
def test_match_count_precondition_raises(M):
    """M must be a positive multiple of min(512, M), as the JAX kernel
    asserts; otherwise the wrapper raises ValueError before any work."""
    args = [torch.from_numpy(a[:M]) if M else torch.from_numpy(a[:0])
            for a in _streams(M=max(M, 1), N=8)]
    with pytest.raises(ValueError, match="multiple"):
        tbk.assemble_streams(*args, 8)


def test_wrapper_rejects_wrong_dtype():
    """A float64 stream is refused with TypeError, not converted."""
    args = [torch.from_numpy(a) for a in _streams()]
    args[3] = args[3].double()
    with pytest.raises(TypeError, match="r2"):
        tbk.assemble_streams(*args, 8)


def _problem(N=8, M=1024, seed=1):
    """The random BA problem of tests/test_ba_kernel.py, for both
    packages."""
    rng = np.random.default_rng(seed)
    mi = rng.integers(0, N - 1, M).astype(np.int32)
    jdata = jba.with_pair_tables(jba.BAData(
        mi=jnp.asarray(mi), mj=jnp.asarray((mi + 1).astype(np.int32)),
        q=jnp.asarray(rng.uniform(-300, 300, (M, 2)).astype(np.float32)),
        t=jnp.asarray(rng.uniform(-300, 300, (M, 2)).astype(np.float32)),
        m_valid=jnp.asarray(np.arange(M) < M - 40)))
    rot = rng.normal(0, 0.05, (N, 3)).astype(np.float32)
    jcams = jba.CamState(focal=jnp.full((N,), 700.0), ppal=jnp.zeros((N, 2)),
                         rotvec=jnp.asarray(rot), b=jdata.t)
    T = lambda a, dt=None: torch.as_tensor(np.array(a), dtype=dt)
    tdata = tba.BAData(
        mi=T(jdata.mi, torch.int64), mj=T(jdata.mj, torch.int64),
        q=T(jdata.q), t=T(jdata.t), m_valid=T(jdata.m_valid),
        pi=T(jdata.pi, torch.int64), pj=T(jdata.pj, torch.int64),
        mp=T(jdata.mp, torch.int64))
    tcams = tba.CamState(focal=torch.full((N,), 700.0),
                         ppal=torch.zeros((N, 2)), rotvec=T(rot),
                         b=tdata.t.clone())
    return jdata, jcams, tdata, tcams


def _jacobi(S, rhs, diag_of):
    """(S, rhs) in the Jacobi scaling of ba._solve_preconditioned, with
    D = |diag(diag_of)|: D^-1/2 S D^-1/2 and D^-1/2 rhs."""
    S, rhs = np.asarray(S, np.float64), np.asarray(rhs, np.float64)
    d = np.sqrt(np.maximum(np.abs(np.diag(diag_of)), 1e-12))
    return S / d[:, None] / d[None, :], rhs / d


@pytest.mark.parametrize("fast", [False, True])
def test_streams_reproduce_ba_assembly(fast):
    """streams_from_problem + assemble_streams rebuild the camera system
    of one LM step, with camera 7 inactive: relaxed, S = U* - YW and
    rhs = -eA - yeb; Lowe (fast), S = U* and rhs = -eA with the Schur
    terms off. Held against the port's _assemble_cache +
    _schur_solve_system and the JAX package's ba._assemble on the same
    problem, within 1e-3 of each one's max, the bound of
    tests/test_ba_kernel.py (measured: under 1e-5), both as computed and
    in the Jacobi scaling the solve applies: unscaled, the rotation
    entries set the max (their diagonal is ~5e6 times the focal one
    here), and the scaled comparison holds the focal and principal-point
    rows to the same 1e-3 of their own scale."""
    N, lam = 8, 0.05
    jdata, jcams, tdata, tcams = _problem()
    active = np.arange(N) < N - 1
    ja, ta = jnp.asarray(active), torch.from_numpy(active)
    jact_m = jdata.m_valid & ja[jdata.mi] & ja[jdata.mj]
    S_j, rhs_j, *_ = jax.jit(lambda c: jba._assemble(
        c, jdata, jact_m, lam, ja, fast, N))(jcams)
    tact_m = tdata.m_valid & ta[tdata.mi] & ta[tdata.mj]
    cache = tba._assemble_cache(tcams, tdata, tact_m, ta, N, fast=fast)
    S_t, rhs_t, _ = tba._schur_solve_system(cache, tact_m, lam, ta, fast)

    streams = tbk.streams_from_problem(tcams, tdata, tact_m, lam, ta, N,
                                       fast)
    U, eA, YW, yeb = tbk.assemble_streams(*streams, N, with_schur=not fast)
    U_aug = tba._augment(U, lam, cache.aug)
    S2, rhs2 = (U_aug, -eA) if fast else (U_aug - YW, -eA - yeb)
    S2, rhs2 = tba._mask_inactive(S2, rhs2, ta)
    for ref_S, ref_rhs in ((S_t.numpy(), rhs_t.numpy()),
                           (np.asarray(S_j), np.asarray(rhs_j))):
        _close(ref_S, S2.numpy(), "S", floor=0.0)
        _close(ref_rhs, rhs2.numpy(), "rhs", floor=0.0)
        jS_ref, jrhs_ref = _jacobi(ref_S, ref_rhs, ref_S)
        jS, jrhs = _jacobi(S2.numpy(), rhs2.numpy(), ref_S)
        _close(jS_ref, jS, "S (Jacobi)", floor=0.0)
        _close(jrhs_ref, jrhs, "rhs (Jacobi)", floor=0.0)
    if fast:
        _close(cache.U.numpy(), U.numpy(), "U", floor=0.0)
        _close(cache.eA.numpy(), (-eA).numpy(), "eA", floor=0.0)
