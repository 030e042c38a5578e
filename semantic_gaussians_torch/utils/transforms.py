"""Quaternion / rotation / covariance math for 3D Gaussians.

Port of semantic_gaussians_tpu.utils.transforms (quaternions stored w, x, y, z).
"""
from __future__ import annotations

import torch


def normalize_quat(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [..., 4] -> rotation matrix [..., 3, 3]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r0 = torch.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1
    )
    r1 = torch.stack(
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1
    )
    r2 = torch.stack(
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1
    )
    return torch.stack([r0, r1, r2], dim=-2)


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> quaternion (w, x, y, z), branch-free:
    the four candidates' magnitudes from the diagonal, the signs of x, y, z
    from the off-diagonal differences, then normalized."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    qw = torch.sqrt(torch.clamp(1 + m00 + m11 + m22, min=0)) / 2
    qx = torch.sqrt(torch.clamp(1 + m00 - m11 - m22, min=0)) / 2
    qy = torch.sqrt(torch.clamp(1 - m00 + m11 - m22, min=0)) / 2
    qz = torch.sqrt(torch.clamp(1 - m00 - m11 + m22, min=0)) / 2
    qx = torch.copysign(qx, m21 - m12)
    qy = torch.copysign(qy, m02 - m20)
    qz = torch.copysign(qz, m10 - m01)
    return normalize_quat(torch.stack([qw, qx, qy, qz], dim=-1))


def build_scaling_rotation(scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """L = R @ diag(s): [..., 3, 3]."""
    return quat_to_rotmat(normalize_quat(quats)) * scales[..., None, :]


def build_covariance_3d(scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """Sigma = L @ L^T = R diag(s^2) R^T, full [..., 3, 3]."""
    L = build_scaling_rotation(scales, quats)
    return L @ L.transpose(-1, -2)


def strip_symmetric(cov: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] symmetric -> 6-vector (xx, xy, xz, yy, yz, zz)."""
    return torch.stack(
        [
            cov[..., 0, 0],
            cov[..., 0, 1],
            cov[..., 0, 2],
            cov[..., 1, 1],
            cov[..., 1, 2],
            cov[..., 2, 2],
        ],
        dim=-1,
    )


def unstrip_symmetric(v: torch.Tensor) -> torch.Tensor:
    """6-vector (xx, xy, xz, yy, yz, zz) -> full symmetric [..., 3, 3]."""
    xx, xy, xz, yy, yz, zz = (v[..., i] for i in range(6))
    return torch.stack([
        torch.stack([xx, xy, xz], dim=-1),
        torch.stack([xy, yy, yz], dim=-1),
        torch.stack([xz, yz, zz], dim=-1),
    ], dim=-2)


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1 - x))
