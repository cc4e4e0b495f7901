"""Bundle adjustment: Levenberg-Marquardt with a Schur complement.

Port of simplepanorama_tpu/ba.py (the reference's bund/bundm): same
model, state, residual, LM schedule, augmentation and Schur reduction.

  * model:  H(i, j) = K_j R_i^T R_j K_i^{-1};
  * state:  per camera {focal, principal(2), rotvec(3)} plus, in the
    relaxed objective, a per-match source point b;
  * residual per directed match:  r = [t - b, q - dehom(H(i, j) b)];
  * LM: <= 50 trials, accept -> lambda/10, reject -> lambda*10, stop after
    6 consecutive rejections; error = sum over matches of ||r||;
  * Schur: (U* - sum Y W^T) da = e_A - sum Y e_B, db = V*^{-1}(e_B - W^T da).

The LM while_loop is a Python loop with one host sync per trial. The
per-pair H chain and its Jacobian come from torch.func.jacfwd + vmap over
the realized camera pairs; the per-match table expansion is an index
gather with an explicit clamp. Both objectives are ported: the relaxed
one (fast=False) and Lowe's (fast=True), which keeps b = t fixed and
solves U* da = e_A.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.func import jacfwd, vmap

from simplepanorama_tpu_torch.geometry.rotation import rodrigues

_AUG_FOCAL = 1e-3
_AUG_ANG = float(np.pi / 16.0)


class BAData(NamedTuple):
    """Static match tables (device tensors, fixed capacity M) plus the
    realized-pair tables: pair rows (pi, pj) and each match's row mp."""
    mi: torch.Tensor       # (M,) query-image index
    mj: torch.Tensor       # (M,) train-image index
    q: torch.Tensor        # (M, 2) query keypoint, center-origin
    t: torch.Tensor        # (M, 2) train keypoint, center-origin
    m_valid: torch.Tensor  # (M,) bool
    pi: torch.Tensor       # (P,) realized-pair query-camera ids
    pj: torch.Tensor       # (P,) realized-pair train-camera ids
    mp: torch.Tensor       # (M,) pair-table row of each match


class CamState(NamedTuple):
    focal: torch.Tensor    # (N,)
    ppal: torch.Tensor     # (N, 2)
    rotvec: torch.Tensor   # (N, 3)
    b: torch.Tensor        # (M, 2) estimated source points


def _K_of(focal, ppal):
    z = torch.zeros_like(focal)
    o = torch.ones_like(focal)
    return torch.stack([
        torch.stack([focal, z, ppal[..., 0]], -1),
        torch.stack([z, focal, ppal[..., 1]], -1),
        torch.stack([z, z, o], -1)], -2)


def _K_inv_of(focal, ppal):
    inv_f = torch.reciprocal(focal)   # 1.0 / x gives a float64 tangent under jacfwd
    z = torch.zeros_like(focal)
    o = torch.ones_like(focal)
    return torch.stack([
        torch.stack([inv_f, z, -ppal[..., 0] * inv_f], -1),
        torch.stack([z, inv_f, -ppal[..., 1] * inv_f], -1),
        torch.stack([z, z, o], -1)], -2)


def _pair_H(cam_i, cam_j):
    """H of one (i, j) camera pair; cam = (6,) [f, px, py, rx, ry, rz]."""
    K_j = _K_of(cam_j[0], cam_j[1:3])
    K_i_inv = _K_inv_of(cam_i[0], cam_i[1:3])
    R_i = rodrigues(cam_i[3:6])
    R_j = rodrigues(cam_j[3:6])
    return K_j @ R_i.T @ R_j @ K_i_inv


_pair_H_batch = vmap(_pair_H)
_pair_H_jac_batch = vmap(jacfwd(_pair_H, argnums=(0, 1)))


def _cam6(cams: CamState):
    return torch.cat([cams.focal[:, None], cams.ppal, cams.rotvec], -1)


def _match_geometry(Hm, b):
    """Per-match projective chain: (bh (M,3), p2 (M,2), Jp (M,2,3)), with
    the dehomogenization guard treated as a constant (zero tangent)."""
    bh = torch.cat([b, torch.ones_like(b[:, :1])], -1)
    p = (Hm * bh[:, None, :]).sum(-1)
    guard = torch.abs(p[:, 2]) < 1e-12
    w = torch.where(guard, torch.full_like(p[:, 2], 1e-12), p[:, 2])
    inv_w = 1.0 / w
    p2 = p[:, :2] * inv_w[:, None]
    zero = torch.zeros_like(inv_w)
    dw = torch.where(guard, zero, -inv_w * inv_w)
    Jp = torch.stack([
        torch.stack([inv_w, zero, p[:, 0] * dw], -1),
        torch.stack([zero, inv_w, p[:, 1] * dw], -1)], -2)
    return bh, p2, Jp


def _pair_tables(data: BAData, c6, with_jac: bool):
    """H table over the realized pairs, optional (dH/dcam_i, dH/dcam_j),
    and each match's table row clamped into range."""
    n_cam = c6.shape[0]
    ci = c6[torch.clamp(data.pi, max=n_cam - 1)]
    cj = c6[torch.clamp(data.pj, max=n_cam - 1)]
    Ht = _pair_H_batch(ci, cj)
    jac = _pair_H_jac_batch(ci, cj) if with_jac else None
    pid = torch.clamp(data.mp, 0, Ht.shape[0] - 1)
    return Ht, jac, pid


def residuals(cams: CamState, data: BAData, active_m,
              fast: bool = False) -> torch.Tensor:
    """(M, 4) residuals, zero on inactive slots; the Lowe objective
    (``fast``) projects the train keypoints, b = t."""
    b = data.t if fast else cams.b
    Ht, _, pid = _pair_tables(data, _cam6(cams), with_jac=False)
    _, p2, _ = _match_geometry(Ht[pid], b)
    r = torch.cat([data.t - b, data.q - p2], -1)
    return torch.where(active_m[:, None], r, torch.zeros_like(r))


def total_error(cams: CamState, data: BAData, active_m,
                fast: bool = False) -> torch.Tensor:
    """Sum over active matches of ||r_m|| (the reference's metric)."""
    return torch.linalg.norm(residuals(cams, data, active_m, fast),
                             dim=-1).sum()


class _JacCache(NamedTuple):
    """Lambda-independent normal-equation terms of one accepted state."""
    U: torch.Tensor           # (6N, 6N)
    eA: torch.Tensor          # (6N,)
    aug: torch.Tensor         # (6N,) diagonal augmentation scales
    focal_last: torch.Tensor  # scalar, V-augment reference quirk
    W: torch.Tensor           # (M, 6N, 2), or a placeholder in fast mode
    V: torch.Tensor           # (M, 2, 2), or a placeholder
    eB: torch.Tensor          # (M, 2), or a placeholder


def _jacobian_streams(cams: CamState, data: BAData, active_m, fast: bool):
    """Per-match chain rule, zero on inactive slots: residuals r (M, 4),
    the camera blocks of the projected rows Ai23, Aj23 (M, 2, 6) and the
    b-Jacobian B (M, 4, 2), whose rows 2:4 are the projected ones."""
    b = data.t if fast else cams.b
    Ht, (Dit, Djt), pid = _pair_tables(data, _cam6(cams), with_jac=True)
    Hm = Ht[pid]
    bh, p2, Jp = _match_geometry(Hm, b)
    r = torch.cat([data.t - b, data.q - p2], -1)
    r = torch.where(active_m[:, None], r, torch.zeros_like(r))

    dHb_i = (Dit[pid] * bh[:, None, :, None]).sum(2)          # (M,3,6)
    dHb_j = (Djt[pid] * bh[:, None, :, None]).sum(2)
    Ai23 = -(Jp[:, :, :, None] * dHb_i[:, None, :, :]).sum(2)  # (M,2,6)
    Aj23 = -(Jp[:, :, :, None] * dHb_j[:, None, :, :]).sum(2)
    B23 = -(Jp[:, :, :, None] * Hm[:, None, :, :2]).sum(2)     # (M,2,2)
    msk = active_m[:, None, None]
    Ai23 = torch.where(msk, Ai23, torch.zeros_like(Ai23))
    Aj23 = torch.where(msk, Aj23, torch.zeros_like(Aj23))
    m_eye = (-torch.eye(2, dtype=B23.dtype, device=B23.device)).expand(B23.shape)
    B = torch.cat([m_eye, B23], 1)                            # (M,4,2)
    B = torch.where(msk, B, torch.zeros_like(B))
    return r, Ai23, Aj23, B


def _assemble_cache(cams: CamState, data: BAData, active_m, cam_active,
                    n_cams: int, vaug_idx=None,
                    fast: bool = False) -> _JacCache:
    """Jacobian-dependent half of the assemble: dense block-sparse J
    (M, 2, 6N) from one-hot camera masks, then U = J^T J, e_A = -J^T r
    and, in the relaxed objective, V, e_B and W = J^T B."""
    N = n_cams
    r, Ai23, Aj23, B = _jacobian_streams(cams, data, active_m, fast)

    # camera masks; an id outside the (cropped) camera table gives a zero
    # row, as jax.nn.one_hot does
    cam_ids = torch.arange(N, device=cams.focal.device)
    Pi = (data.mi[:, None] == cam_ids).to(Ai23.dtype)
    Pj = (data.mj[:, None] == cam_ids).to(Aj23.dtype)
    Jd = (Pi[:, None, :, None] * Ai23[:, :, None, :]
          + Pj[:, None, :, None] * Aj23[:, :, None, :]).reshape(-1, 2, 6 * N)

    U = torch.einsum("mra,mrb->ab", Jd, Jd)
    # Gauss-Newton sign: the step solves (J^T J + lam D) d = -J^T r
    eA = -torch.einsum("mra,mr->a", Jd, r[:, 2:])

    aug = torch.cat([
        (cams.focal[:, None] * _AUG_FOCAL).repeat(1, 3),
        torch.full((N, 3), _AUG_ANG, dtype=U.dtype, device=U.device)],
        1).reshape(-1)
    focal_last = _focal_last(cams, cam_active, vaug_idx)
    if fast:
        z = U.new_zeros
        return _JacCache(U=U, eA=eA, aug=aug, focal_last=focal_last,
                         W=z((1, 1, 2)), V=z((1, 2, 2)), eB=z((1, 2)))

    V, eB = _v_and_eb(B, r)
    W = torch.stack(
        [Jd[:, 0, :] * B[:, 2, 0, None] + Jd[:, 1, :] * B[:, 3, 0, None],
         Jd[:, 0, :] * B[:, 2, 1, None] + Jd[:, 1, :] * B[:, 3, 1, None]],
        -1)                                                   # (M,6N,2)
    return _JacCache(U=U, eA=eA, aug=aug, focal_last=focal_last,
                     W=W, V=V, eB=eB)


def _focal_last(cams: CamState, cam_active, vaug_idx=None):
    """V augment focal: the reference uses the LAST active camera's focal
    (``vaug_idx`` when the caller renumbered the cameras)."""
    if vaug_idx is None:
        idx = torch.arange(cam_active.shape[0], device=cam_active.device)
        vaug_idx = torch.where(cam_active, idx, torch.zeros_like(idx)).max()
    return cams.focal[vaug_idx]


def _v_and_eb(B, r):
    """Per-match V = B^T B (M, 2, 2) and e_B = -B^T r (M, 2)."""
    return ((B[:, :, :, None] * B[:, :, None, :]).sum(1),
            -(B * r[:, :, None]).sum(1))


def _v_inverse(V, focal_last, lam, active_m):
    """(M, 2, 2) inverse of the augmented V, zero on inactive slots."""
    aug_l = 1.0 + lam * focal_last * _AUG_FOCAL
    v00, v01 = V[:, 0, 0] * aug_l, V[:, 0, 1]
    v10, v11 = V[:, 1, 0], V[:, 1, 1] * aug_l
    det = v00 * v11 - v01 * v10
    det = torch.where(torch.abs(det) < 1e-20, torch.full_like(det, 1e-20), det)
    Vinv = torch.stack([torch.stack([v11, -v01], -1),
                        torch.stack([-v10, v00], -1)], -2) / det[:, None, None]
    return torch.where(active_m[:, None, None], Vinv, torch.zeros_like(Vinv))


def _cholesky_streams(Vinv, eB):
    """(l00, l10, l11) of the 2x2 Cholesky L of V^-1 (YW = Z^T Z with
    Z = W L) and (g0, g1) = V^-1 e_B, each (M,)."""
    l00 = torch.sqrt(torch.clamp(Vinv[:, 0, 0], min=0.0))
    safe = torch.where(l00 > 0.0, l00, torch.ones_like(l00))
    l10 = Vinv[:, 1, 0] / safe
    l11 = torch.sqrt(torch.clamp(Vinv[:, 1, 1] - l10 * l10, min=0.0))
    g0 = Vinv[:, 0, 0] * eB[:, 0] + Vinv[:, 0, 1] * eB[:, 1]
    g1 = Vinv[:, 1, 0] * eB[:, 0] + Vinv[:, 1, 1] * eB[:, 1]
    return l00, l10, l11, g0, g1


def _schur_solve_system(cache: _JacCache, active_m, lam, cam_active,
                        fast: bool = False):
    """Lambda-dependent half: diagonal augmentation and, in the relaxed
    objective, V inverse and Schur reduction. Returns (S, rhs, Vinv);
    Vinv is None in fast mode, where S = U* and rhs = e_A."""
    U_aug = _augment(cache.U, lam, cache.aug)
    if fast:
        S, rhs, Vinv = U_aug, cache.eA, None
    else:
        W, eB = cache.W, cache.eB
        Vinv = _v_inverse(cache.V, cache.focal_last, lam, active_m)
        l00, l10, l11, g0, g1 = _cholesky_streams(Vinv, eB)
        Z0 = W[:, :, 0] * l00[:, None] + W[:, :, 1] * l10[:, None]
        Z1 = W[:, :, 1] * l11[:, None]
        YW = (torch.einsum("ma,mb->ab", Z0, Z0)
              + torch.einsum("ma,mb->ab", Z1, Z1))
        yeb = (torch.einsum("ma,m->a", W[:, :, 0], g0)
               + torch.einsum("ma,m->a", W[:, :, 1], g1))
        S = U_aug - YW
        rhs = cache.eA - yeb
    S, rhs = _mask_inactive(S, rhs, cam_active)
    return S, rhs, Vinv


def _augment(U, lam, aug):
    """U* = U with its diagonal scaled by (1 + lam * aug)."""
    return U + torch.diag(torch.diagonal(U) * lam * aug)


def _mask_inactive(S, rhs, cam_active):
    """Inactive cameras: identity diagonal block, zero rhs -> zero delta."""
    act6 = cam_active.repeat_interleave(6)
    S = torch.where(act6[:, None] & act6[None, :], S, torch.zeros_like(S))
    S = S + torch.diag(torch.where(act6, 0.0, 1.0).to(S.dtype))
    return S, torch.where(act6, rhs, torch.zeros_like(rhs))


def _solve_preconditioned(S, rhs):
    """Jacobi-preconditioned solve (f32-friendly conditioning)."""
    d = torch.sqrt(torch.clamp(torch.abs(torch.diagonal(S)), min=1e-12))
    Dinv = 1.0 / d
    Ss = S * Dinv[:, None] * Dinv[None, :]
    y = torch.linalg.solve(Ss, rhs * Dinv)
    return y * Dinv


def _apply_delta(cams: CamState, da, db, cam_active, active_m):
    """Trial state from deltas; rotation frozen for identity-rotation
    cameras (gauge anchor, add_delta). ``db`` is None in fast mode, which
    leaves b alone."""
    N = cams.focal.shape[0]
    da = da.reshape(N, 6)
    da = torch.where(cam_active[:, None], da, torch.zeros_like(da))
    frozen = torch.linalg.norm(cams.rotvec, dim=-1) < 1e-6
    rotvec = torch.where(frozen[:, None], cams.rotvec, cams.rotvec + da[:, 3:6])
    b = cams.b if db is None else \
        cams.b + torch.where(active_m[:, None], db, torch.zeros_like(db))
    return CamState(cams.focal + da[:, 0], cams.ppal + da[:, 1:3], rotvec, b)


class LMResult(NamedTuple):
    cams: CamState
    error: torch.Tensor
    lam: torch.Tensor
    n_accepted: int
    n_iter: int


def lm_run_impl(cams: CamState, data: BAData, cam_active: torch.Tensor,
                lambda0, fast: bool = False, max_iter: int = 50,
                vaug_idx: Optional[int] = None) -> LMResult:
    """Full LM optimization over the active subproblem, as a host loop
    with one sync per trial (the accept test). ``fast`` selects the
    Lowe objective."""
    N = cams.focal.shape[0]
    # ids beyond a cropped camera table clamp, like a JAX gather
    active_m = (data.m_valid & cam_active[torch.clamp(data.mi, max=N - 1)]
                & cam_active[torch.clamp(data.mj, max=N - 1)])
    cur = cams
    err = total_error(cams, data, active_m, fast)
    lam = torch.as_tensor(lambda0, dtype=torch.float32,
                          device=cams.focal.device)
    it = strikes = n_acc = 0
    while it < max_iter and strikes <= 5:
        cache = _assemble_cache(cur, data, active_m, cam_active, N,
                                vaug_idx=vaug_idx, fast=fast)
        S, rhs, Vinv = _schur_solve_system(cache, active_m, lam, cam_active,
                                           fast)
        da = _solve_preconditioned(S, rhs)
        db = None
        if not fast:
            wtd = (cache.W * da[None, :, None]).sum(1)
            db = (Vinv * (cache.eB - wtd)[:, None, :]).sum(2)
        trial = _apply_delta(cur, da, db, cam_active, active_m)
        err_new = total_error(trial, data, active_m, fast)
        if bool((err_new < err) & torch.isfinite(err_new)):
            cur, err = trial, err_new
            lam = lam * 0.1
            strikes = 0
            n_acc += 1
        else:
            lam = lam * 10.0
            strikes += 1
        it += 1
    return LMResult(cams=cur, error=err, lam=lam, n_accepted=n_acc, n_iter=it)


def lm_run(cams: CamState, data: BAData, cam_active: torch.Tensor,
           lambda0, fast: bool = False, max_iter: int = 50) -> LMResult:
    """Full LM optimization over the active subproblem."""
    return lm_run_impl(cams, data, cam_active, lambda0, fast=fast,
                       max_iter=max_iter)
