"""Rotation algebra in PyTorch: Rodrigues exp/log, SVD orthogonalization,
rotation init from homography.

Port of simplepanorama_tpu/geometry/rotation.py. Branch-free (torch.where
selects) so the functions compose with torch.func.jacfwd and vmap; each
takes a single (3,) vector or (3, 3) matrix, batched callers vmap.
"""

from __future__ import annotations

import torch


def _skew(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[0])
    return torch.stack([
        torch.stack([z, -v[2], v[1]]),
        torch.stack([v[2], z, -v[0]]),
        torch.stack([-v[1], v[0], z]),
    ])


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
