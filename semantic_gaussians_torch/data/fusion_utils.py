"""Fusion geometry: point -> image mapping with an occlusion test.

Port of semantic_gaussians_tpu.data.fusion_utils (`adjust_intrinsic`,
`compute_mapping`, `surface_depth`): rescale intrinsics to the feature-map
resolution, project N points with K [R|t], round to pixels, bounds test
with a cut_bound margin, occlusion |depth[px] - z| <= vis_thres * depth;
"surface" mode synthesizes the z-buffer from the points themselves. Plain
functions on tensors, on whatever device holds them. The voxelizer feeds
only the sparse UNet and is ported with the distill slice.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

# Pixel coordinates are clamped to this before the int32 cast: a point near
# the camera plane projects to ~1e30, whose cast is undefined in torch (the
# CPU wraps to INT_MIN, XLA saturates). Any clamped value fails the bounds
# test either way, so the mapping is unchanged.
_PIXEL_LIMIT = 2.0**30


def adjust_intrinsic(
    intrinsic: np.ndarray,
    intrinsic_image_dim: Tuple[int, int],
    image_dim: Tuple[int, int],
) -> np.ndarray:
    """Rescale a 3x3 / 4x4 intrinsic matrix to a new image size."""
    if tuple(intrinsic_image_dim) == tuple(image_dim):
        return intrinsic
    intrinsic = intrinsic.copy().astype(np.float64)
    intrinsic[0, 0] *= image_dim[0] / intrinsic_image_dim[0]
    intrinsic[1, 1] *= image_dim[1] / intrinsic_image_dim[1]
    # the principal point follows the pixel centres of the resize
    intrinsic[0, 2] *= (image_dim[0] - 1) / (intrinsic_image_dim[0] - 1)
    intrinsic[1, 2] *= (image_dim[1] - 1) / (intrinsic_image_dim[1] - 1)
    return intrinsic


def _project(world_to_camera, coords, intrinsic):
    """Camera-space z and rounded pixel (u, v) of each point. The camera
    transform is written as explicit products and sums, left to right as
    the reference's contraction adds them, so that no library matmul moves
    a value across a rounding half."""
    w2c = world_to_camera.to(coords.dtype)
    x, y, z3 = coords[:, 0], coords[:, 1], coords[:, 2]

    def row(i):
        return x * w2c[i, 0] + y * w2c[i, 1] + z3 * w2c[i, 2] + w2c[i, 3]

    px, py, z = row(0), row(1), row(2)
    z_safe = torch.where(z.abs() > 1e-8, z, torch.full_like(z, 1e-8))
    u = torch.round(intrinsic[0, 0] * px / z_safe + intrinsic[0, 2])
    v = torch.round(intrinsic[1, 1] * py / z_safe + intrinsic[1, 2])
    u = torch.nan_to_num(u, nan=-_PIXEL_LIMIT).clamp(-_PIXEL_LIMIT, _PIXEL_LIMIT)
    v = torch.nan_to_num(v, nan=-_PIXEL_LIMIT).clamp(-_PIXEL_LIMIT, _PIXEL_LIMIT)
    return z, u.to(torch.int32), v.to(torch.int32)


def compute_mapping(
    world_to_camera: torch.Tensor,  # [4, 4]
    coords: torch.Tensor,  # [N, 3]
    intrinsic: torch.Tensor,  # [3, 3] or [4, 4] (at feature-map scale)
    image_dim: Tuple[int, int],  # (width, height)
    depth: Optional[torch.Tensor] = None,  # [H, W] z-buffer or None
    vis_thres: float = 0.25,
    cut_bound: int = 0,
) -> torch.Tensor:
    """[N, 3] int32 rows (v, u, mask); mask = 1 where the point maps to a
    visible pixel, and (v, u) = (0, 0) elsewhere."""
    z, u, v = _project(world_to_camera, coords, intrinsic)
    w, h = image_dim
    mask = (
        (u >= cut_bound) & (v >= cut_bound) & (u < w - cut_bound) & (v < h - cut_bound)
        & (z > 0)
    )
    if depth is not None:
        d = depth[v.clamp(0, h - 1).long(), u.clamp(0, w - 1).long()]
        mask = mask & (d > 0) & ((d - z).abs() <= vis_thres * d)
    zero = torch.zeros_like(u)
    return torch.stack(
        [torch.where(mask, v, zero), torch.where(mask, u, zero), mask.to(torch.int32)], dim=-1
    )


def surface_depth(
    world_to_camera: torch.Tensor,
    coords: torch.Tensor,
    intrinsic: torch.Tensor,
    image_dim: Tuple[int, int],
    cut_bound: int = 0,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """A z-buffer [H, W] made from the points themselves (depth='surface'):
    the per-pixel minimum depth of the points with z > 0.2 inside the
    cut_bound margin, 0 where no point lands. `valid` masks out dead or
    padding slots, which would otherwise write a bogus near depth. The
    scatter-min does not depend on the order of the points."""
    w, h = image_dim
    z, u, v = _project(world_to_camera, coords, intrinsic)
    ok = (
        (u >= cut_bound) & (v >= cut_bound) & (u < w - cut_bound) & (v < h - cut_bound)
        & (z > 0.2)
    )
    if valid is not None:
        ok = ok & valid
    idx = torch.where(ok, v.long() * w + u.long(), torch.full_like(v, h * w, dtype=torch.long))
    inf = torch.full_like(z, float("inf"))
    buf = torch.full((h * w + 1,), float("inf"), dtype=z.dtype, device=z.device)
    buf.scatter_reduce_(0, idx, torch.where(ok, z, inf), "amin")
    zb = buf[: h * w].reshape(h, w)
    return torch.where(torch.isfinite(zb), zb, torch.zeros_like(zb))
