"""The BA's pair-H Jacobian written out by hand (ba._pair_H_jac_batch,
geometry/rotation.rodrigues_jac), on the CPU.

The same camera pairs, made from numpy seeds, go through the port's
hand-written Jacobian, through the forward-mode AD form it replaced
(torch.func's vmap(jacfwd(_pair_H)), built here as the plain reference)
and through the JAX package's jax.vmap(jax.jacfwd(_pair_H)). Tolerance:
2e-5 of each (3, 3, 6) block's largest entry against both. On the CPU
the hand-written form follows jacfwd's operations in jacfwd's order, so
it must also equal jacfwd's result bit for bit (torch.equal: a zero's
sign aside); the JAX package sums in its own float order.

A fresh interpreter then runs an eager LM and a 4-view stitch through
the port alone and must not have imported torch._dynamo, which PyTorch's
forward-mode AD imported in the BA's first trial.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

from simplepanorama_tpu import ba as jba
from simplepanorama_tpu.geometry import rotation as jrot
from simplepanorama_tpu_torch import ba as tba
from simplepanorama_tpu_torch.geometry import rotation as trot

torch.set_num_threads(2)

TOL = 2e-5
EPS = 1e-8        # rodrigues' small-angle threshold on theta^2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rotvecs(rng, P, case):
    """(P, 3) rotation vectors with uniform directions. ``random``:
    |w| up to pi - 0.1; ``small``: |w|^2 < 1e-8 (rodrigues' first-order
    branch); ``edge``: |w|^2 = 1e-8 (1 -+ 1e-3), alternating sides, the
    closest to the threshold that a float32 sum's rounding in the other
    package cannot move across it."""
    d = rng.normal(size=(P, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if case == "random":
        mag = rng.uniform(0.0, np.pi - 0.1, (P, 1))
    elif case == "small":
        mag = np.sqrt(EPS) * rng.uniform(0.0, 0.99, (P, 1))
    else:
        side = np.where(np.arange(P) % 2 == 0, 1.0 - 1e-3, 1.0 + 1e-3)
        mag = np.sqrt(EPS * side)[:, None]
    return (d * mag).astype(np.float32)


def _cams(rng, P, case):
    """(P, 6) cameras [f, px, py, rx, ry, rz]: f in 300-1800, principal
    point in 0-400."""
    c = np.empty((P, 6), np.float32)
    c[:, 0] = rng.uniform(300.0, 1800.0, P)
    c[:, 1:3] = rng.uniform(0.0, 400.0, (P, 2))
    c[:, 3:6] = _rotvecs(rng, P, case)
    return c


def _assert_blocks_close(got, want, what):
    """Each pair's (3, 3, 6) block within TOL of its largest entry."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max(axis=(1, 2, 3))
    err = np.abs(got - want).max(axis=(1, 2, 3)) / scale
    assert np.all(np.isfinite(got)), what
    assert err.max() <= TOL, f"{what}: {err.max():.3g} of a block's max"


@pytest.mark.parametrize("P", [1, 4096])
@pytest.mark.parametrize("case", ["random", "small", "edge"])
def test_pair_jacobian_matches_jacfwd_and_jax(case, P):
    """dH/dcam_i and dH/dcam_j, each (P, 3, 3, 6), against the port's
    former vmap(jacfwd) form (bit for bit) and the JAX package's, on
    pairs of ``case`` rotations (both cameras of a pair drawn alike)."""
    rng = np.random.default_rng({"random": 11, "small": 12, "edge": 13}[case]
                                + P)
    ci, cj = _cams(rng, P, case), _cams(rng, P, case)
    got = tba._pair_H_jac_batch(torch.from_numpy(ci), torch.from_numpy(cj))
    plain = vmap(jacfwd(tba._pair_H, argnums=(0, 1)))(
        torch.from_numpy(ci), torch.from_numpy(cj))
    ref = jax.vmap(jba._pair_H_jac)(jnp.asarray(ci), jnp.asarray(cj))
    for k, name in enumerate(("dH/dcam_i", "dH/dcam_j")):
        assert got[k].shape == (P, 3, 3, 6)
        assert got[k].dtype == torch.float32
        _assert_blocks_close(got[k].numpy(), plain[k].numpy(),
                             f"{name} vs jacfwd")
        assert torch.equal(got[k], plain[k]), f"{name}: bits vs jacfwd"
        _assert_blocks_close(got[k].numpy(), ref[k], f"{name} vs JAX")


@pytest.mark.parametrize("case", ["random", "small", "edge"])
def test_rodrigues_jac_matches_jacfwd_and_jax(case):
    """rodrigues_jac's R against rodrigues (vmapped) and its dR/dw
    (P, 3, 3, 3) against jacfwd of rodrigues (bit for bit) and the JAX
    package's, at the same tolerance; R within 1e-6 of the JAX
    package's."""
    rng = np.random.default_rng({"random": 21, "small": 22, "edge": 23}[case])
    v = _rotvecs(rng, 512, case)
    R, dR = trot.rodrigues_jac(torch.from_numpy(v))
    assert dR.shape == (512, 3, 3, 3)
    assert torch.equal(R, vmap(trot.rodrigues)(torch.from_numpy(v)))
    np.testing.assert_allclose(R.numpy(),
                               jax.vmap(jrot.rodrigues)(jnp.asarray(v)),
                               atol=1e-6)
    plain = vmap(jacfwd(trot.rodrigues))(torch.from_numpy(v))
    _assert_blocks_close(dR.numpy(), plain.numpy(), "dR vs jacfwd")
    assert torch.equal(dR, plain)
    _assert_blocks_close(dR.numpy(),
                         jax.vmap(jax.jacfwd(jrot.rodrigues))(jnp.asarray(v)),
                         "dR vs JAX")


_FRESH = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    torch.set_num_threads(2)
    from simplepanorama_tpu_torch import Config, Panorama, ba
    from simplepanorama_tpu_torch.fixtures import fkh360_views
    from simplepanorama_tpu_torch.stitch import _rodrigues_np

    calls = [0]
    jac = ba._pair_H_jac_batch
    def counted(ci, cj):
        calls[0] += 1
        return jac(ci, cj)
    ba._pair_H_jac_batch = counted

    # four cameras on a yaw arc, matches from the BA model plus noise
    rng = np.random.default_rng(5)
    f, n = 500.0, 4
    rot = np.array([[0.02 * i, 0.3 * i, 0.01 * i] for i in range(n)])
    K = np.diag([f, f, 1.0])
    mi, mj, q, t = [], [], [], []
    for i in range(n - 1):
        for a, b in ((i, i + 1), (i + 1, i)):
            H = K @ _rodrigues_np(rot[a]).T @ _rodrigues_np(rot[b]) \\
                @ np.linalg.inv(K)
            tt = rng.uniform(-150, 150, (40, 2))
            ph = np.c_[tt, np.ones(40)] @ H.T
            mi += [a] * 40
            mj += [b] * 40
            q.append(ph[:, :2] / ph[:, 2:] + rng.normal(0, 0.3, (40, 2)))
            t.append(tt)
    M = len(mi)
    T = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt)
    data = ba.with_pair_tables(ba.BAData(
        mi=T(mi, torch.int64), mj=T(mj, torch.int64),
        q=T(np.concatenate(q)), t=T(np.concatenate(t)),
        m_valid=torch.ones(M, dtype=torch.bool), pi=None, pj=None, mp=None))
    rot0 = rot + np.r_[[np.zeros(3)], rng.normal(0, 0.02, (n - 1, 3))]
    cams = ba.CamState(focal=torch.full((n,), f * 1.1),
                       ppal=torch.zeros((n, 2)), rotvec=T(rot0),
                       b=data.t.clone())
    res = ba.lm_run(cams, data, torch.ones(n, dtype=torch.bool), 0.05,
                    max_iter=20)
    lm = {"calls": calls[0], "trials": int(res.n_iter),
          "finite": bool(torch.isfinite(res.error)),
          "dynamo": "torch._dynamo" in sys.modules}

    paths, _, _ = fkh360_views(4, 320, yaw_step_deg=20.0, hfov_deg=45.0,
                               roll_deg=3.0, out_dir=sys.argv[1])
    calls[0] = 0
    prev = Panorama(paths, device="cpu").stitch(
        Config(init_size=320, RANSAC_iterations=300)).get_preview()
    print(json.dumps({"lm": lm, "stitch_calls": calls[0],
                      "preview": list(prev.shape),
                      "dynamo": "torch._dynamo" in sys.modules,
                      "jax": "jax" in sys.modules}))
""")


def test_fresh_process_never_imports_dynamo(tmp_path):
    """A fresh interpreter, with no JAX imported, runs one LM on the CPU
    (ba.lm_run, 20 trials) and one 4-view 320-px CPU stitch with
    its preview. Both take the pair Jacobian in every trial, and neither
    leaves torch._dynamo in sys.modules."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in [env.get("PYTHONPATH")] if p])
    out = subprocess.run([sys.executable, "-c", _FRESH, str(tmp_path)],
                         cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["lm"]["calls"] > 0 and got["lm"]["trials"] > 0
    assert got["lm"]["finite"]
    assert not got["lm"]["dynamo"]
    assert got["stitch_calls"] > 0
    assert len(got["preview"]) == 3 and min(got["preview"]) > 0
    assert not got["dynamo"]
    assert not got["jax"]
