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

One LM trial is a function of device tensors (``lm_trial``, the JAX
package's while_loop body): the chain rule, the camera system summed by
ops/ba_kernel.assemble_streams (kernel 3 on the card, its plain version on
the CPU), the solve, the back-substitution by gathers and the accept test,
applied with torch.where alone. ``lm_step`` is that trial as two halves
around the assembly, ``trial_streams_ref`` and ``solve_accept_ref``: the
plain versions of kernels 4 and 5 (ops/ba_trial). Every LM run is an
``LMProgram``'s, which reads the termination flag once every READ_EVERY
trials and takes its trial from its device and process group:

  * one rank on the card (every stitch's BA; ``LMProgram.trial_kernels``):
    ``fused_trial``, kernels 4, 3 and 5, three nodes of the CUDA graph
    the program captures and replays between reads (a fourth, the pair
    tables, for a bucket of more than ~480 pairs);
  * a process group on the card (parallel.dist_ba): ``lm_step``
    captured, its two all-reduces between the assembly and the solve and
    between the trial and its error;
  * the CPU, with a group or without: ``lm_step``, run between reads
    (CUDA graphs do not exist there).

``program`` keeps each single-card bucket's program for the process, as
the JAX package's jit cache keeps its compiled LM (``release_programs``
drops them), lent to one thread at a time; ``chunk_programs`` lends a
BA call the program of each chunk. The
per-pair H chain comes from vmap over the realized camera pairs and its
Jacobian is written out by hand (``_pair_H_jac_batch``: the tangents of
the same operations, forward-mode AD's result with no AD and no
torch.func transform); the per-match table expansion is an index gather
with an explicit clamp. Both objectives are ported: the
relaxed one (fast=False) and Lowe's (fast=True), which keeps b = t fixed
and solves U* da = e_A.
"""

from __future__ import annotations

import atexit
import contextlib
import threading
import time
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.func import vmap

from simplepanorama_tpu_torch.geometry.rotation import (rodrigues,
                                                        rodrigues_jac)
from simplepanorama_tpu_torch.ops import ba_kernel, ba_trial
from simplepanorama_tpu_torch.utils.device import (CAPTURE_LOCK,
                                                   cusolver_linalg)
from simplepanorama_tpu_torch.utils.nvcc import count_launches
from simplepanorama_tpu_torch.utils.timing import span

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


def with_pair_tables(data: BAData) -> BAData:
    """``data`` with its realized-pair tables (pi, pj, mp) computed on the
    host from mi / mj, for synthetic problems (stitch.build_ba_data
    builds them for a stitch): the unique (mi, mj) rows padded to a
    multiple of 64, and each match's row."""
    mi = data.mi.cpu().numpy()
    mj = data.mj.cpu().numpy()
    uniq, inv = np.unique(np.stack([mi, mj], 1), axis=0,
                          return_inverse=True)
    P = max(64, (len(uniq) + 63) // 64 * 64)
    pi = np.zeros(P, np.int64)
    pj = np.zeros(P, np.int64)
    pi[:len(uniq)] = uniq[:, 0]
    pj[:len(uniq)] = uniq[:, 1]
    T = lambda a: torch.as_tensor(a, device=data.mi.device)
    return data._replace(pi=T(pi), pj=T(pj),
                         mp=T(inv.reshape(-1).astype(np.int64)))


def model_homography(cams: CamState, i: int, j: int) -> torch.Tensor:
    """H(i, j) of the BA model (ret_hmat): maps b-points to image i."""
    c6 = _cam6(cams)
    return _pair_H(c6[i], c6[j])


def _K_of(focal, ppal):
    z = torch.zeros_like(focal)
    o = torch.ones_like(focal)
    return torch.stack([
        torch.stack([focal, z, ppal[..., 0]], -1),
        torch.stack([z, focal, ppal[..., 1]], -1),
        torch.stack([z, z, o], -1)], -2)


def _K_inv_of(focal, ppal):
    inv_f = torch.reciprocal(focal)
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


def _K_inv_tangents(focal, ppal):
    """d K^-1 / d(f, px, py), (P, 3, 3, 3) with the direction at dim 1:
    the JVP of ``_K_inv_of`` (d(1/f) = -(1/f)^2)."""
    inv_f = torch.reciprocal(focal)
    r2 = inv_f * inv_f
    z = torch.zeros_like(focal)
    row = lambda a, b, c: torch.stack([a, b, c], -1)
    top2 = lambda r0, r1: torch.stack([r0, r1, row(z, z, z)], -2)
    return torch.stack([
        top2(row(-r2, z, ppal[..., 0] * r2), row(z, -r2, ppal[..., 1] * r2)),
        top2(row(z, z, -inv_f), row(z, z, z)),
        top2(row(z, z, z), row(z, z, -inv_f))], 1)


def _pair_H_jac_batch(ci, cj):
    """(dH/dcam_i, dH/dcam_j), each (P, 3, 3, 6), of H = K_j R_i^T R_j
    K_i^-1 over the rows of ci, cj (P, 6), written out by hand: the
    product rule along the chain's own association ((K_j R_i^T) R_j)
    K_i^-1, each camera's six directions batched at dim 1. Forward-mode
    AD adds a zero tangent for the other camera; it is left out, which
    changes at most the sign of a zero."""
    P = ci.shape[0]
    K_j = _K_of(cj[:, 0], cj[:, 1:3])
    K_i_inv = _K_inv_of(ci[:, 0], ci[:, 1:3])
    R, dR = rodrigues_jac(torch.cat([ci[:, 3:6], cj[:, 3:6]]))
    R_iT, R_j = R[:P].transpose(-1, -2), R[P:]
    dR = dR.permute(0, 3, 1, 2)
    dR_iT, dR_j = dR[:P].transpose(-1, -2), dR[P:]
    A = K_j @ R_iT
    B = A @ R_j
    # d K_j / d(f, px, py): diag(1, 1, 0), e0 e2^T, e1 e2^T
    e = torch.eye(3, dtype=ci.dtype, device=ci.device)
    dK_j = torch.stack([e - torch.outer(e[2], e[2]),
                        torch.outer(e[0], e[2]), torch.outer(e[1], e[2])])
    Kinv, R_jb = K_i_inv[:, None], R_j[:, None]
    D_i = torch.cat([B[:, None] @ _K_inv_tangents(ci[:, 0], ci[:, 1:3]),
                     ((K_j[:, None] @ dR_iT) @ R_jb) @ Kinv], 1)
    D_j = torch.cat([((dK_j @ R_iT[:, None]) @ R_jb) @ Kinv,
                     (A[:, None] @ dR_j) @ Kinv], 1)
    return D_i.permute(0, 2, 3, 1), D_j.permute(0, 2, 3, 1)


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
    """The dense form of the assemble, which the LM trial no longer runs:
    block-sparse J (M, 2, 6N) from one-hot camera masks, then U = J^T J,
    e_A = -J^T r and, in the relaxed objective, V, e_B and W = J^T B. The
    tests hold kernel 3's system and the gathered back-substitution
    against it, and chip_smoke.py times it as the assembly kernel 3
    replaced."""
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

    aug = _aug_scales(cams.focal)
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
    """Lambda-dependent half of the dense form (see _assemble_cache):
    diagonal augmentation and, in the relaxed objective, V inverse and
    Schur reduction. Returns (S, rhs, Vinv);
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
    act6 = cam_active[:, None].expand(-1, 6).reshape(-1)
    S = torch.where(act6[:, None] & act6[None, :], S, torch.zeros_like(S))
    S = S + torch.diag((~act6).to(S.dtype))
    return S, torch.where(act6, rhs, torch.zeros_like(rhs))


def _solve_preconditioned(S, rhs):
    """Jacobi-preconditioned solve (f32-friendly conditioning). A singular
    system gives non-finite values, as jnp.linalg.solve does, and the LM
    rejects that trial: ``solve_ex`` neither raises nor reads its status
    back to the host."""
    d = torch.sqrt(torch.clamp(torch.abs(torch.diagonal(S)), min=1e-12))
    Dinv = 1.0 / d
    Ss = S * Dinv[:, None] * Dinv[None, :]
    y = torch.linalg.solve_ex(Ss, rhs * Dinv)[0]
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


def _aug_scales(focal):
    """(6N,) diagonal augmentation scales: focal * 1e-3 on a camera's
    focal and principal point, pi / 16 on its rotation."""
    N = focal.shape[0]
    return torch.cat([
        (focal[:, None] * _AUG_FOCAL).repeat(1, 3),
        torch.full((N, 3), _AUG_ANG, dtype=focal.dtype, device=focal.device)],
        1).reshape(-1)


def _streams(cams: CamState, data: BAData, active_m, lam, focal_last,
             fast: bool):
    """The chain rule of one state: (r, Ai23, Aj23, B, V^-1, e_B, the nine
    float streams of ops/ba_kernel.assemble_streams). The Lowe objective
    (``fast``) has no V: V^-1 and e_B are None and the l and g streams
    zeros."""
    r, Ai, Aj, B = _jacobian_streams(cams, data, active_m, fast)
    if fast:
        z = r.new_zeros(r.shape[0])
        Vinv = eB = None
        lg = (z, z, z, z, z)
    else:
        V, eB = _v_and_eb(B, r)
        Vinv = _v_inverse(V, focal_last, lam, active_m)
        lg = _cholesky_streams(Vinv, eB)
    return r, Ai, Aj, B, Vinv, eB, (Ai, Aj, B[:, 2:, :], r[:, 2:], *lg)


def streams_from_problem(cams, data, active_m, lam, cam_active, n_cams: int,
                         fast: bool):
    """The 11 input streams of ops/ba_kernel.assemble_streams for one BA
    state of ``n_cams`` camera slots (``cam_active`` marks the live ones),
    as tests/test_ba_kernel.py rebuilds them from ba._assemble: Ai, Aj
    (M, 2, 6), B23 (M, 2, 2), r[:, 2:] (M, 2), the Cholesky factors
    l00, l10, l11 of the augmented V^-1 at ``lam``, g = V^-1 e_B, mi, mj;
    all zero on inactive matches. ``fast`` (the Lowe objective) projects
    b = t and has no V: its l and g streams are zeros."""
    if cam_active.shape != (n_cams,):
        raise ValueError(f"cam_active has shape {tuple(cam_active.shape)}, "
                         f"expected ({n_cams},)")
    *_, floats = _streams(cams, data, active_m, lam,
                          _focal_last(cams, cam_active), fast)
    return tuple(t.contiguous() for t in floats) + (data.mi, data.mj)


def _system(sums, aug, lam, cam_active, fast: bool):
    """The camera system (S, rhs) from assemble_streams' (U, +J^T r, YW,
    yeb): S = U* - YW, rhs = -J^T r - yeb (Lowe: S = U*, rhs = -J^T r),
    inactive cameras masked."""
    U, eA, YW, yeb = sums
    U_aug = _augment(U, lam, aug)
    S, rhs = (U_aug, -eA) if fast else (U_aug - YW, -eA - yeb)
    return _mask_inactive(S, rhs, cam_active)


def _back_substitute(Ai, Aj, bp, eB, Vinv, da, data: BAData):
    """db = V^-1 (e_B - W^T da) without the dense W (M, 6N, 2): W_m has
    non-zero rows only at the blocks of mi and mj, W_m = J_m^T B23[m]
    (``bp``, the projected rows of B), so W_m^T da takes the two 6-row
    blocks Ai23[m]^T B23[m] and Aj23[m]^T B23[m] and two gathers, da[mi]
    and da[mj] (an id outside the cameras adds nothing)."""
    N = da.shape[0] // 6
    d6 = da.reshape(N, 6)

    def block(A, ids):   # (M, 6, 2) block of W_m times da at ``ids``
        g = d6.index_select(0, torch.clamp(ids, 0, N - 1))
        g = torch.where(((ids >= 0) & (ids < N))[:, None], g,
                        torch.zeros_like(g))
        W = (A[:, 0, :, None] * bp[:, 0, None, :]
             + A[:, 1, :, None] * bp[:, 1, None, :])
        return W * g[:, :, None]
    wtd = torch.cat([block(Ai, data.mi), block(Aj, data.mj)], 1).sum(1)
    return (Vinv * (eB - wtd)[:, None, :]).sum(2)


class LMResult(NamedTuple):
    cams: CamState
    error: torch.Tensor
    lam: torch.Tensor
    n_accepted: torch.Tensor   # () int64
    n_iter: torch.Tensor       # () int64, trials run (accepted + rejected)


class LMState(NamedTuple):
    """The carry of the LM loop, all on the device."""
    cams: CamState
    err: torch.Tensor       # () accepted error
    lam: torch.Tensor       # () float32
    it: torch.Tensor        # () int64, trials run
    strikes: torch.Tensor   # () int64, consecutive rejections
    n_acc: torch.Tensor     # () int64, accepted steps


class LMProblem(NamedTuple):
    """What one LM run holds fixed, as device tensors."""
    data: BAData
    mi: torch.Tensor          # (M,) int32 camera ids for the kernel
    mj: torch.Tensor
    cam_active: torch.Tensor  # (N,) bool
    active_m: torch.Tensor    # (M,) bool
    vaug_idx: torch.Tensor    # () int64, camera of the V-augment focal
    max_iter: torch.Tensor    # () int64
    ws: Optional[ba_kernel.Workspace]   # kernel scratch, on the card
    # process group over which the matches are split (parallel.dist_ba):
    # the camera system and the errors are summed over its ranks
    group: object = None


# trials between two host reads of the termination flag: an LM run takes
# 46 trials on average on the measured stitches (506 in 11 runs), so a
# read every 8 wastes 3.5 no-op trials a run against ~6 reads, where a
# read every trial would stall the card 46 times
READ_EVERY = 8

def _active_matches(data: BAData, cam_active):
    # ids beyond a cropped camera table clamp, like a JAX gather
    N = cam_active.shape[0]
    return (data.m_valid & cam_active[torch.clamp(data.mi, max=N - 1)]
            & cam_active[torch.clamp(data.mj, max=N - 1)])


def lm_problem(data: BAData, cam_active, vaug_idx=None, max_iter: int = 50,
               ws=None, group=None) -> LMProblem:
    """The fixed part of an LM run. ``vaug_idx`` (int or () tensor): the
    camera whose focal scales the V augment; by default the last active
    one (the reference's quirk). With a process ``group``, ``data`` is
    this rank's share of the matches (parallel.mesh.shard_matches)."""
    dev = cam_active.device
    if vaug_idx is None:
        idx = torch.arange(cam_active.shape[0], device=dev)
        vaug_idx = torch.where(cam_active, idx, torch.zeros_like(idx)).max()
    elif not torch.is_tensor(vaug_idx):
        vaug_idx = torch.full((), int(vaug_idx), dtype=torch.int64,
                              device=dev)
    return LMProblem(
        data=data, mi=data.mi.to(torch.int32), mj=data.mj.to(torch.int32),
        cam_active=cam_active, active_m=_active_matches(data, cam_active),
        vaug_idx=vaug_idx.reshape(()).to(torch.int64),
        max_iter=torch.full((), max_iter, dtype=torch.int64, device=dev),
        ws=ws, group=group)


def _sum_ranks(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (no group: ``x``)."""
    if group is None:
        return x
    import torch.distributed as dist
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def _error(cams: CamState, pb: LMProblem, fast: bool) -> torch.Tensor:
    """total_error over every rank's matches."""
    return _sum_ranks(total_error(cams, pb.data, pb.active_m, fast),
                      pb.group)


def _camera_sums(floats, pb: LMProblem, n: int, fast: bool):
    """assemble_streams over this rank's matches (kernel 3 on the card),
    then, with a group, one all_reduce of its four outputs packed into one
    buffer: the camera system of every rank's matches."""
    sums = ba_kernel.assemble_streams(*floats, pb.mi, pb.mj, n,
                                      with_schur=not fast, ws=pb.ws)
    if pb.group is None:
        return sums
    buf = _sum_ranks(torch.cat([t.reshape(-1) for t in sums]), pb.group)
    return tuple(p.reshape(t.shape) for p, t in
                 zip(torch.split(buf, [t.numel() for t in sums]), sums))


def lm_init(cams: CamState, pb: LMProblem, lambda0, fast: bool) -> LMState:
    dev = cams.focal.device
    z = torch.zeros((), dtype=torch.int64, device=dev)
    return LMState(
        cams=cams, err=_error(cams, pb, fast),
        lam=torch.full((), float(lambda0), dtype=torch.float32, device=dev),
        it=z, strikes=z.clone(), n_acc=z.clone())


def _live(st: LMState, max_iter):
    return (st.it < max_iter) & (st.strikes <= 5)


def lm_trial(st: LMState, pb: LMProblem, fast: bool) -> LMState:
    """One LM trial as a function of tensors (the JAX package's while_loop
    body): the chain rule, the camera system from assemble_streams, the
    preconditioned solve, back-substitution, the trial error, and the
    accept test applied with torch.where alone. A trial after the run has
    ended (``it`` at max_iter, or 6 rejections in a row) changes nothing,
    so the result does not depend on how often the host reads the
    termination flag. No host sync on any device.

    With ``pb.group`` (the match-sharded BA, parallel.dist_ba) this rank
    sums its own matches, one all_reduce completes the camera system and
    one the trial error; every rank solves the same system, and the
    back-substitution of its own matches' b stays local."""
    return lm_step(st, pb, fast)[0]


def trial_streams_ref(st: LMState, pb: LMProblem,
                      fast: bool) -> ba_trial.TrialStreams:
    """The first half of the trial, before the assembly: the streams of
    ops/ba_kernel.assemble_streams, then e_B and V^-1 for the
    back-substitution (None in Lowe's objective). The plain version of
    kernel 4 (ops/ba_trial.trial_streams)."""
    cams = st.cams
    focal_last = cams.focal.index_select(0, pb.vaug_idx.reshape(1))[0]
    *_, Vinv, eB, floats = _streams(cams, pb.data, pb.active_m, st.lam,
                                    focal_last, fast)
    return ba_trial.TrialStreams(*floats, eB=eB, vinv=Vinv)


def solve_accept_ref(st: LMState, pb: LMProblem, fast: bool,
                     ts: ba_trial.TrialStreams, sums):
    """The second half of the trial, from the camera system ``sums`` (U,
    +J^T r, YW, yeb) and the streams ``ts``: the augmented and masked
    system, the preconditioned solve, the back-substitution of b, the
    trial error over every rank's matches and the accept test. Returns
    (the new state, the trial's error). The plain version of kernel 5
    (ops/ba_trial.solve_accept)."""
    cams = st.cams
    S, rhs = _system(sums, _aug_scales(cams.focal), st.lam, pb.cam_active,
                     fast)
    da = _solve_preconditioned(S, rhs)
    db = None if fast else _back_substitute(ts.ai, ts.aj, ts.bp, ts.eB,
                                            ts.vinv, da, pb.data)
    trial = _apply_delta(cams, da, db, pb.cam_active, pb.active_m)
    err_new = _error(trial, pb, fast)
    live = _live(st, pb.max_iter)
    ok = live & (err_new < st.err) & torch.isfinite(err_new)
    return LMState(
        cams=CamState(*(torch.where(ok, a, b) for a, b in zip(trial, cams))),
        err=torch.where(ok, err_new, st.err),
        lam=torch.where(live, torch.where(ok, st.lam * 0.1, st.lam * 10.0),
                        st.lam),
        it=st.it + live.to(torch.int64),
        strikes=torch.where(live, torch.where(ok, torch.zeros_like(
            st.strikes), st.strikes + 1), st.strikes),
        n_acc=st.n_acc + ok.to(torch.int64)), err_new


def lm_step(st: LMState, pb: LMProblem, fast: bool):
    """lm_trial, also returning the trial's error (over every rank's
    matches) whether or not the trial was accepted: trial_streams_ref,
    the camera system (kernel 3 and, with a group, its all-reduce), then
    solve_accept_ref."""
    ts = trial_streams_ref(st, pb, fast)
    sums = _camera_sums(ts[:9], pb, st.cams.focal.shape[0], fast)
    return solve_accept_ref(st, pb, fast, ts, sums)


def fused_trial(st: LMState, pb: LMProblem, fast: bool, live: torch.Tensor,
                tw: ba_trial.Workspace) -> None:
    """One single-card trial on the card, written into ``st``'s tensors
    and the termination flag ``live`` in place: kernel 4, kernel 3,
    kernel 5 (``tw``: their workspace). No host sync. Its plain version
    is lm_step."""
    ts = ba_trial.trial_streams(st, pb, fast, tw)
    sums = ba_kernel.assemble_streams(*ts[:9], pb.mi, pb.mj,
                                      st.cams.focal.shape[0],
                                      with_schur=not fast, ws=pb.ws)
    ba_trial.solve_accept(st, pb, fast, ts, sums, live, tw)


def _result(st: LMState) -> LMResult:
    return LMResult(cams=st.cams, error=st.err, lam=st.lam,
                    n_accepted=st.n_acc, n_iter=st.it)


def lm_run_impl(cams: CamState, data: BAData, cam_active: torch.Tensor,
                lambda0, fast: bool = False, max_iter: int = 50,
                vaug_idx=None) -> LMResult:
    """Full LM optimization over the active subproblem: an LMProgram
    made for ``data``, run once and closed. Its trial is the one every
    stitch runs: on the card, kernels 4, 3 and 5 captured as a CUDA graph;
    on the CPU, lm_step. ``fast`` selects the Lowe objective."""
    prog = LMProgram(data, cams.focal.shape[0], fast, max_iter)
    try:
        return prog.run(cams, cam_active, lambda0, vaug_idx)[0]
    finally:
        prog.close()


def lm_run(cams: CamState, data: BAData, cam_active: torch.Tensor,
           lambda0, fast: bool = False, max_iter: int = 50) -> LMResult:
    """Full LM optimization over the active subproblem (lm_run_impl: on
    the card, the stitch's captured trial)."""
    return lm_run_impl(cams, data, cam_active, lambda0, fast=fast,
                       max_iter=max_iter)


# the kernel wrappers a captured trial may record (LMProgram.per_trial)
_KERNELS = (ba_kernel.assemble_streams, ba_trial.trial_streams,
            ba_trial.solve_accept)


class LMProgram:
    """LM runs of one capacity bucket (``data`` cropped to its matches,
    ``n_cams`` camera slots, one objective), reading the termination flag
    once every READ_EVERY trials. On the card one trial is captured as a
    CUDA graph and replayed between the reads; on the CPU, where graphs
    do not exist, ``trial`` runs between them. The trial follows from the
    device and the process group (``trial_kernels``): one rank on the
    card runs ``fused_trial``, kernels 4, 3 and 5, three graph nodes, with
    their workspace ``tw``; a group, or the CPU, runs ``lm_step``.

    Every value that changes between runs lives in a static device buffer
    written before the run (cameras, b, the active cameras and matches,
    lambda, the V-augment camera, the counters), so one graph serves every
    run of the bucket. The program owns copies of the match tables
    (``data`` and the int32 ids derived from it), and ``load_data`` copies
    another problem of the same shapes into them, so one graph also
    serves every problem of the bucket (``program``, the process's cache).
    What the graph bakes in is the shapes alone: M, P, ``n_cams``, the
    objective, ``max_iter`` and the kernel's workspace, sized by M and
    ``n_cams``. The first run's first trial runs eagerly on a side stream
    (the warm-up that capture needs), then the trial is captured there
    (``_capture``; a host sync inside it fails the capture). Call
    ``close`` to release the graph and its memory pool.

    With a process ``group`` (the match-sharded BA, parallel.dist_ba),
    ``data`` and the cameras' b are this rank's share of the matches
    (parallel.mesh.shard_matches), and the trial holds its two
    all_reduces: the camera system, between the assembly and the solve,
    and the trial error. On the card the graph holds them, and the
    warm-up trial issues them eagerly before the capture, so no
    collective is first issued inside it. The termination flag is
    computed from all-reduced values only, so every rank reads the same
    flag and runs the same number of trials. A capture that fails
    raises: there is no eager fallback."""

    def __init__(self, data: BAData, n_cams: int, fast: bool,
                 max_iter: int = 50, group=None):
        dev = data.mi.device
        M = data.mi.shape[0]
        self.fast = fast
        # trials between two reads of the flag, fixed when the program
        # is made (the benchmark's card tests read it)
        self.read_every = READ_EVERY
        i64 = dict(dtype=torch.int64, device=dev)
        # the kernels' scratch on the card; elsewhere their plain versions
        on_card = dev.type == "cuda"
        ws = tw = None
        if on_card:
            # the solve on cuSOLVER: captured on the device, and one
            # backend for every thread of the process
            cusolver_linalg()
            ws = ba_kernel.workspace(M, n_cams, dev)
            if group is None:
                tw = ba_trial.workspace(M, n_cams, data.pi.shape[0], dev)
        self.tw = tw
        self.pb = lm_problem(
            BAData(*(t.clone() for t in data)),
            torch.zeros(n_cams, dtype=torch.bool, device=dev),
            torch.zeros((), **i64), max_iter, ws, group)
        f = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
        self.st = LMState(
            cams=CamState(f(n_cams), f(n_cams, 2), f(n_cams, 3), f(M, 2)),
            err=f(), lam=f(), it=torch.zeros((), **i64),
            strikes=torch.zeros((), **i64), n_acc=torch.zeros((), **i64))
        self.live = torch.zeros((), dtype=torch.bool, device=dev)
        self.graph = None
        self.capture_s = 0.0          # host seconds spent capturing
        # launches in one trial of kernels 3, 4 and 5, by wrapper
        self.per_trial = {}

    @property
    def trial_kernels(self) -> bool:
        """Whether the trial is fused_trial (kernels 4, 3 and 5): one rank
        on the card. Otherwise it is lm_step."""
        return self.tw is not None

    @property
    def graphed(self) -> bool:
        """Whether ``run`` replays the trial captured as a CUDA graph: on
        the card."""
        return self.live.is_cuda

    @property
    def launches_per_trial(self) -> int:
        """Kernel-3 launches in one captured trial (0 before the
        capture)."""
        return self.per_trial.get(ba_kernel.assemble_streams, 0)

    def load_data(self, data: BAData):
        """Copy the match tables of another problem of the same shapes and
        types into the program's buffers, in place; the graph replays on
        them from the next run. The active matches follow at that run's
        start (``_load``)."""
        pb = self.pb
        for name, dst, src in zip(BAData._fields, pb.data, data):
            if dst.shape != src.shape or dst.dtype != src.dtype:
                raise ValueError(
                    f"{name}: {tuple(src.shape)} {src.dtype}, the program "
                    f"holds {tuple(dst.shape)} {dst.dtype}")
            dst.copy_(src)
        pb.mi.copy_(pb.data.mi)
        pb.mj.copy_(pb.data.mj)

    def _tensors(self, st: LMState):
        return (*st.cams, st.err, st.lam, st.it, st.strikes, st.n_acc)

    def _store(self, st: LMState):
        for dst, src in zip(self._tensors(self.st), self._tensors(st)):
            dst.copy_(src)
        self.live.copy_(_live(st, self.pb.max_iter))

    def trial(self):
        """One trial on the program's buffers, in place: fused_trial, or
        lm_step and a copy into the buffers (trial_kernels)."""
        if self.trial_kernels:
            fused_trial(self.st, self.pb, self.fast, self.live, self.tw)
        else:
            self._store(lm_step(self.st, self.pb, self.fast)[0])

    @span("ba.load")
    def _load(self, cams: CamState, cam_active, lambda0, vaug_idx=None):
        pb, st = self.pb, self.st
        for dst, src in zip(st.cams, cams):
            dst.copy_(src)
        pb.cam_active.copy_(cam_active)
        pb.active_m.copy_(_active_matches(pb.data, pb.cam_active))
        if vaug_idx is None:     # the last active camera, on the device
            idx = torch.arange(pb.cam_active.shape[0],
                               device=pb.cam_active.device)
            pb.vaug_idx.copy_(torch.where(pb.cam_active, idx,
                                          torch.zeros_like(idx)).max())
        else:
            pb.vaug_idx.fill_(int(vaug_idx))
        st.err.copy_(_error(st.cams, pb, self.fast))
        st.lam.fill_(float(lambda0))
        for t in (st.it, st.strikes, st.n_acc):
            t.zero_()

    @span("ba.capture")
    def _capture(self):
        """The warm-up trial, then the trial captured on this program's own
        stream. One capture at a time in the process (CAPTURE_LOCK), in
        "thread_local" mode: a CUDA call of another thread, such as a
        stitch in another thread or the NCCL watchdog of a sharded
        trial's process group, neither fails the capture nor joins it."""
        with CAPTURE_LOCK:
            t0 = time.perf_counter()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self.trial()
            torch.cuda.current_stream().wait_stream(side)
            before = {k: k.recorded for k in _KERNELS}
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="thread_local"):
                self.trial()
            # the capture records the launches without running them: the
            # replays count them
            self.per_trial = {k: k.recorded - before[k] for k in _KERNELS}
            self.graph = graph
            self.capture_s = time.perf_counter() - t0

    def run(self, cams: CamState, cam_active, lambda0, vaug_idx=None):
        """One LM run from ``cams``. ``vaug_idx``: the camera whose focal
        scales the V augment (by default the last active one). Returns
        (LMResult, trials executed, the warm-up and the no-op ones after
        the end included, host reads)."""
        self._load(cams, cam_active, lambda0, vaug_idx)
        executed = reads = 0
        if self.graph is None and self.graphed:
            self._capture()
            executed += 1
        step = self.trial if self.graph is None else self.graph.replay
        while True:
            for _ in range(self.read_every):
                step()
            for k, n in self.per_trial.items():
                count_launches(k, self.read_every * n)
            executed += self.read_every
            reads += 1
            with span("ba.flag_read"):
                live = bool(self.live)
            if not live:
                break
        st = LMState(*(t.clone() if torch.is_tensor(t) else
                       CamState(*(c.clone() for c in t)) for t in self.st))
        return _result(st), executed, reads

    def close(self):
        """Release the graph and its memory pool."""
        if self.graph is not None:
            self.graph.reset()
            self.graph = None


# The process's LM programs, one a key (_program_key): the counterpart of
# the JAX package's jit cache, which compiles each bucket's LM program
# once per process. A later stitch with a bucket of the same shapes loads
# its match tables into the kept program and replays its graph: no
# warm-up trial and no capture. Each program holds its graph's private
# memory pool, its kernel workspace and its buffers until
# release_programs(). Programs of a process group (the match-sharded BA)
# are never kept: their graph holds the group's NCCL communicator, which
# can be destroyed while the program lives on.
_PROGRAMS: dict = {}
# one lock a key, held by the thread whose tables a kept program holds
# (program); never dropped, so a thread waiting on one across a
# release_programs() still shares it with the threads that come after
_PROGRAM_LOCKS: dict = {}
_CACHE_LOCK = threading.Lock()


def _program_key(data: BAData, n_cams: int, fast: bool, max_iter: int):
    """What an LMProgram's graph is built for: the device, the objective
    and every shape the graph bakes in."""
    return (data.mi.device, bool(fast), n_cams, data.mi.shape[0],
            data.pi.shape[0], max_iter)


def _kept(data: BAData, n_cams: int, fast: bool, max_iter: int,
          key) -> LMProgram:
    """The kept program of ``key`` loaded with ``data``, made when the
    process has none (captured at its first run)."""
    with _CACHE_LOCK:
        prog = _PROGRAMS.get(key)
        if prog is None:
            if not _PROGRAMS:
                # graphs released before the interpreter tears torch down
                atexit.register(release_programs)
            _PROGRAMS[key] = LMProgram(data, n_cams, fast, max_iter)
            return _PROGRAMS[key]
    prog.load_data(data)
    return prog


@contextlib.contextmanager
def program(data: BAData, n_cams: int, fast: bool, max_iter: int = 50):
    """The process's LMProgram for ``data``'s shapes on its device (one
    card, no process group), loaded with ``data``, with its key's lock
    held for the block: from loading ``data``'s tables through the
    block's last run, no other thread loads or runs that program.
    Stitches in several threads of one process then give what each gives
    alone, as with the JAX package's stateless executables; two keys run
    at once."""
    key = _program_key(data, n_cams, fast, max_iter)
    with _CACHE_LOCK:
        lock = _PROGRAM_LOCKS.setdefault(key, threading.Lock())
    with lock:
        yield _kept(data, n_cams, fast, max_iter, key)


@contextlib.contextmanager
def chunk_programs(group=None):
    """The LM programs of one BA call (stitch.bundle_adjust_stitching):
    yields ``program_of(data, n_cams, fast, max_iter=50)``, a context
    manager lending the program of ``data``'s bucket, loaded with
    ``data``, for a chunk. Where a program lives follows from the device
    and the process ``group``:

      * one rank on the card: the process's kept program (``program``),
        its key's lock held for the chunk;
      * a group on the card: one program a bucket for the call, closed
        when the call's block ends, since its graph holds the group's
        communicator;
      * the CPU: a program for the chunk alone (no graph to keep)."""
    call = {}

    @contextlib.contextmanager
    def program_of(data: BAData, n_cams: int, fast: bool,
                   max_iter: int = 50):
        if data.mi.device.type != "cuda":
            yield LMProgram(data, n_cams, fast, max_iter, group)
        elif group is None:
            with program(data, n_cams, fast, max_iter) as prog:
                yield prog
        else:
            key = _program_key(data, n_cams, fast, max_iter)
            prog = call.get(key)
            if prog is None:
                prog = call[key] = LMProgram(data, n_cams, fast, max_iter,
                                             group)
            else:
                prog.load_data(data)
            yield prog
    try:
        yield program_of
    finally:
        for prog in call.values():
            prog.close()


def release_programs() -> None:
    """Close every kept LMProgram: their graphs and memory pools are
    released (the counterpart of jax.clear_caches()). A program that a
    thread holds (program) is closed when that thread lets it go."""
    with _CACHE_LOCK:
        kept = list(_PROGRAMS.items())
        _PROGRAMS.clear()
        locks = dict(_PROGRAM_LOCKS)
    for key, prog in kept:
        with locks.get(key) or contextlib.nullcontext():
            prog.close()
