"""Rotation algebra in PyTorch: Rodrigues exp/log, SVD orthogonalization,
rotation init from homography.

Port of simplepanorama_tpu/geometry/rotation.py. Branch-free (torch.where
selects) so the functions compose with vmap; each takes a single (3,)
vector or (3, 3) matrix, batched callers vmap. ``rodrigues_jac`` is the
batched Rodrigues map with its derivative written out: the tangents run
through the same operations as ``rodrigues`` (what forward-mode AD would
compute, with no AD), for the bundle adjustment's pair Jacobian.
"""

from __future__ import annotations

import torch


def _skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrices [v]_x."""
    x, y, w = v[..., 0], v[..., 1], v[..., 2]
    z = torch.zeros_like(x)
    return torch.stack([
        torch.stack([z, -w, y], -1),
        torch.stack([w, z, -x], -1),
        torch.stack([-y, x, z], -1),
    ], -2)


def rodrigues(rotvec: torch.Tensor) -> torch.Tensor:
    """Rotation vector (3,) -> rotation matrix (3, 3); first-order
    I + [v]_x below theta^2 = 1e-8 (get_rot's small-angle branch)."""
    eps = 1e-8
    theta2 = torch.dot(rotvec, rotvec)
    theta = torch.sqrt(torch.clamp(theta2, min=eps))
    K = _skew(rotvec / theta)
    eye = torch.eye(3, dtype=rotvec.dtype, device=rotvec.device)
    R_full = eye + torch.sin(theta) * K + (1.0 - torch.cos(theta)) * (K @ K)
    R_small = eye + _skew(rotvec)
    return torch.where(theta2 < eps, R_small, R_full)


def rodrigues_jac(rotvec: torch.Tensor):
    """Batched ``rodrigues`` and its derivative: rotvec (P, 3) -> R
    (P, 3, 3) and dR/drotvec (P, 3, 3, 3), direction last.

    Each tangent follows the operation it differentiates, in the order
    ``rodrigues`` runs them, so the result is forward-mode AD's (bit for
    bit on the CPU): a zero tangent below the clamp, and below
    theta^2 = 1e-8 the derivative of the selected I + [v]_x, which is
    [e_k]_x rather than the full formula's limit. No host sync: the
    trial that calls it is captured as a CUDA graph.
    """
    eps = 1e-8
    theta2 = (rotvec * rotvec).sum(-1)
    theta = torch.sqrt(torch.clamp(theta2, min=eps))
    u = rotvec / theta[:, None]
    K = _skew(u)
    eye = torch.eye(3, dtype=rotvec.dtype, device=rotvec.device)
    s, c = torch.sin(theta), torch.cos(theta)
    omc = 1.0 - c
    KK = K @ K
    R_full = eye + s[:, None, None] * K + omc[:, None, None] * KK
    small = theta2 < eps
    R = torch.where(small[:, None, None], eye + _skew(rotvec), R_full)

    # tangents along e_k, direction k at dim 1: d theta2 = 2 v_k, zero
    # below the clamp; sqrt, v / theta, sin, cos and the products by
    # their JVP rules
    dt2 = torch.where(small[:, None], torch.zeros_like(rotvec),
                      rotvec + rotvec)
    dth = dt2 / (2 * theta)[:, None]                          # (P, 3)
    du = (eye - dth[:, :, None] * u[:, None, :]) / theta[:, None, None]
    dK = _skew(du)                                            # (P, 3, 3, 3)
    ds = dth * c[:, None]
    domc = dth * s[:, None]                # d(1 - cos) = -(dth * -sin)
    Kb, KKb = K[:, None], KK[:, None]
    dKK = dK @ Kb + Kb @ dK
    dR_full = ((dK * s[:, None, None, None] + ds[:, :, None, None] * Kb)
               + (dKK * omc[:, None, None, None]
                  + domc[:, :, None, None] * KKb))
    dR = torch.where(small[:, None, None, None], _skew(eye), dR_full)
    return R, dR.permute(0, 2, 3, 1)


def orthogonalize(M: torch.Tensor) -> torch.Tensor:
    """Nearest rotation via SVD: R = U diag(1, 1, det(U V^T)) V^T."""
    U, _, Vt = torch.linalg.svd(M)
    d = torch.linalg.det(U @ Vt)
    one = torch.ones_like(d)
    scale = torch.stack([one, one, torch.sign(d)], -1)
    return U @ (Vt * scale[..., :, None])


def rotvec_from_matrix(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> rotation vector, re-orthogonalized first
    (get_rotvec)."""
    eps = 1e-8
    Rs = orthogonalize(R)
    v = torch.stack([Rs[2, 1] - Rs[1, 2], Rs[0, 2] - Rs[2, 0],
                     Rs[1, 0] - Rs[0, 1]])
    s = torch.linalg.norm(v)
    cos_ = torch.clamp((Rs[0, 0] + Rs[1, 1] + Rs[2, 2] - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_)
    mul = torch.where(s < eps, torch.zeros_like(s),
                      theta / torch.clamp(s, min=eps))
    return v * mul


def approximate_rot(K_i: torch.Tensor, K_j: torch.Tensor,
                    H: torch.Tensor) -> torch.Tensor:
    """Nearest rotation to K_j^-1 H K_i (stch::approximate_rot)."""
    return orthogonalize(torch.linalg.solve(K_j, H @ K_i))
