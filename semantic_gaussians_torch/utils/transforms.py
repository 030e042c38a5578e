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


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1 - x))
