"""Quaternion / covariance math for anisotropic 3D Gaussians (counterpart of
the JAX package's ``core/transforms.py``)."""

from __future__ import annotations

import torch


def normalize_quat(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalise (..., 4) quaternions stored as (w, x, y, z)."""
    return q / torch.clamp_min(torch.linalg.vector_norm(q, dim=-1,
                                                        keepdim=True), eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) unit quaternion (w, x, y, z) -> (..., 3, 3) rotation."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    r = torch.stack(
        [
            1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
            2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
            2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
        ],
        dim=-1,
    )
    return r.reshape(*q.shape[:-1], 3, 3)


def scaling_rotation_to_cov3d(scale: torch.Tensor,
                              quat: torch.Tensor) -> torch.Tensor:
    """(N, 3) linear scales + (N, 4) quaternions -> (N, 3, 3) covariance
    R diag(s)^2 R^T, written out elementwise."""
    R = quat_to_rotmat(normalize_quat(quat))
    s2 = scale * scale
    rows = [R[..., 0, :], R[..., 1, :], R[..., 2, :]]

    def entry(i, j):
        return torch.sum(s2 * rows[i] * rows[j], dim=-1)

    row0 = torch.stack([entry(0, 0), entry(0, 1), entry(0, 2)], dim=-1)
    row1 = torch.stack([entry(0, 1), entry(1, 1), entry(1, 2)], dim=-1)
    row2 = torch.stack([entry(0, 2), entry(1, 2), entry(2, 2)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def inverse_sigmoid(x):
    """Logit: opacity is stored in pre-activation space."""
    return torch.log(x / (1.0 - x))
