"""Fusion geometry: point -> image mapping with an occlusion test.

Port of semantic_gaussians_tpu.data.fusion_utils (`adjust_intrinsic`,
`compute_mapping`, `surface_depth`): rescale intrinsics to the feature-map
resolution, project N points with K [R|t], round to pixels, bounds test
with a cut_bound margin, occlusion |depth[px] - z| <= vis_thres * depth;
"surface" mode synthesizes the z-buffer from the points themselves. Plain
functions on tensors, on whatever device holds them. `Voxelizer` (the
sparse UNet's input: augment, floor-quantize, deduplicate) is host-side
numpy with a sort-based dedupe (`np.unique`) at every size.
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


# --------------------------------------------------------------------------
# Voxelizer (host-side, numpy)
# --------------------------------------------------------------------------
class Voxelizer:
    """Floor-quantize + dedupe with optional augmentation
    (fusion_utils.py:81-211). `voxelize` returns (voxel coords, feats,
    labels, inverse, first_idx): `inverse` maps each point to its voxel
    row, `first_idx` each voxel to its first point."""

    def __init__(
        self,
        voxel_size: float = 0.05,
        clip_bound=None,
        use_augmentation: bool = False,
        scale_augmentation_bound=None,  # e.g. (0.9, 1.1)
        rotation_augmentation_bound=None,  # e.g. ((-pi/64, pi/64), ...) per axis
        translation_augmentation_ratio_bound=None,
        ignore_label: int = 255,
    ):
        self.voxel_size = voxel_size
        self.clip_bound = clip_bound
        self.use_augmentation = use_augmentation
        self.scale_augmentation_bound = scale_augmentation_bound
        self.rotation_augmentation_bound = rotation_augmentation_bound
        self.translation_augmentation_ratio_bound = translation_augmentation_ratio_bound
        self.ignore_label = ignore_label

    def _augment_transform(self, rng: np.random.Generator) -> np.ndarray:
        T = np.eye(4)
        if self.rotation_augmentation_bound is not None:
            rot = np.eye(3)
            for axis, bound in enumerate(self.rotation_augmentation_bound):
                if bound is None:
                    continue
                theta = rng.uniform(bound[0], bound[1])
                axis_vec = np.zeros(3)
                axis_vec[axis] = 1
                rot = rot @ _axis_angle(axis_vec, theta)
            T[:3, :3] = rot
        if self.scale_augmentation_bound is not None:
            T[:3, :3] *= rng.uniform(*self.scale_augmentation_bound)
        return T

    def voxelize(
        self,
        coords: np.ndarray,
        feats: np.ndarray,
        labels: Optional[np.ndarray] = None,
        center=None,
        seed: Optional[int] = None,
    ):
        rng = np.random.default_rng(seed)
        c = np.asarray(coords, np.float64)
        if self.use_augmentation:
            T = self._augment_transform(rng)
            c = c @ T[:3, :3].T
            if self.translation_augmentation_ratio_bound is not None:
                span = c.max(0) - c.min(0)
                for i, bound in enumerate(self.translation_augmentation_ratio_bound):
                    c[:, i] += rng.uniform(span[i] * bound[0], span[i] * bound[1])
        vox = np.floor(c / self.voxel_size).astype(np.int64)
        vox -= vox.min(0)
        # sort-based dedupe (in place of the reference's FNV-64 hashing)
        dims = vox.max(0) + 1
        lin = (vox[:, 0] * dims[1] + vox[:, 1]) * dims[2] + vox[:, 2]
        _, first_idx, inverse = np.unique(lin, return_index=True, return_inverse=True)
        out_feats = np.asarray(feats)[first_idx]
        out_labels = np.asarray(labels)[first_idx] if labels is not None else None
        return vox[first_idx], out_feats, out_labels, inverse, first_idx


def _axis_angle(axis: np.ndarray, theta: float) -> np.ndarray:
    axis = axis / np.linalg.norm(axis)
    a = np.cos(theta / 2.0)
    b, c, d = -axis * np.sin(theta / 2.0)
    aa, bb, cc, dd = a * a, b * b, c * c, d * d
    bc, ad, ac, ab, bd, cd = b * c, a * d, a * c, a * b, b * d, c * d
    return np.array(
        [
            [aa + bb - cc - dd, 2 * (bc + ad), 2 * (bd - ac)],
            [2 * (bc - ad), aa + cc - bb - dd, 2 * (cd + ab)],
            [2 * (bd + ac), 2 * (cd - ab), aa + dd - bb - cc],
        ]
    )
