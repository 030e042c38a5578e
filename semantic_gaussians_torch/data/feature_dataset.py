"""Distillation dataset: (voxelized Gaussian parameters, fused 2D features).

Port of semantic_gaussians_tpu.data.feature_dataset (the reference's
dataset/feature_dataset.py:11-100): one item per (scene PLY, fused-feature
file). Load the Gaussians -> 56-dim raw-parameter features, optional
ElasticDistortion (before voxelizing) and RandomHorizontalFlip (after, on
voxel coords), voxelize at `voxel_size`, align the fused features to the
surviving voxels through each voxel's first point, and return
budget-padded numpy arrays. Host-side, like the reference's data workers;
the distill step carries the arrays onto its device.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..core.gaussians import packed_features, params_from_numpy
from ..io.ply import load_gaussian_ply
from ..pipelines.fusion import load_fused_features
from .augmentation import Compose, ElasticDistortion, RandomHorizontalFlip
from .fusion_utils import Voxelizer


def _fold(seed: Optional[int], stream: int) -> Optional[int]:
    """An independent RNG stream per augmentation stage."""
    if seed is None:
        return None
    return int(np.random.SeedSequence([seed, stream]).generate_state(1)[0])


@dataclasses.dataclass
class DistillItem:
    coords: np.ndarray  # [V, 3] int32 voxel coords (padded)
    feats: np.ndarray  # [V, 56] float32
    gt: np.ndarray  # [V, C] float32 fused features (0 where absent)
    gt_mask: np.ndarray  # [V] bool (voxels with supervision)
    mask: np.ndarray  # [V] bool alive voxels
    num_voxels: int


class FeatureDataset:
    """Host-side dataset over pairs of (scene PLY, fused .pt) paths."""

    def __init__(
        self,
        scene_plys: List[str],
        fused_files: List[str],
        voxel_size: float = 0.02,
        aug: bool = True,
        feature_type: str = "all",
        voxel_budget: int = 200_000,
    ):
        assert len(scene_plys) == len(fused_files)
        self.scene_plys = scene_plys
        self.fused_files = fused_files
        self.voxel_size = voxel_size
        self.aug = aug
        self.feature_type = feature_type
        self.voxel_budget = voxel_budget
        self.voxelizer = Voxelizer(voxel_size=voxel_size)
        self.prevox_aug = Compose([ElasticDistortion()]) if aug else None
        self.postvox_aug = Compose([RandomHorizontalFlip("z")]) if aug else None
        self._raw_cache: dict = {}  # idx -> (locs, feats, gt, gt_mask)
        self._raw_cache_max = 4

    def __len__(self):
        return len(self.scene_plys)

    def _load_raw(self, idx: int):
        """Parse-once cache of a scene's arrays (re-reading the PLY and the
        fused .pt every epoch would dominate an epoch). Augmentations stay
        per item: they work on fresh arrays. At most four scenes are kept,
        the oldest dropped first."""
        if idx in self._raw_cache:
            return self._raw_cache[idx]
        arrays, alive = load_gaussian_ply(self.scene_plys[idx])
        n_alive = int(alive.sum())
        params = params_from_numpy(arrays, "cpu")
        locs = arrays["means"][:n_alive].astype(np.float64)
        feats = packed_features(params, torch.from_numpy(alive), self.feature_type).numpy()
        gt_feat, gt_mask = load_fused_features(self.fused_files[idx], capacity=params.capacity)
        out = (locs, feats[:n_alive], gt_feat.numpy()[:n_alive], gt_mask.numpy()[:n_alive])
        if len(self._raw_cache) >= self._raw_cache_max:
            self._raw_cache.pop(next(iter(self._raw_cache)))
        self._raw_cache[idx] = out
        return out

    def __getitem__(self, idx: int, seed: Optional[int] = None) -> DistillItem:
        locs, feats, gt_feat, gt_mask = self._load_raw(idx)

        if self.prevox_aug is not None:
            # a stream apart from the post-voxelize aug's: one seed would
            # correlate their apply-gates and alias their noise draws
            locs, _, _ = self.prevox_aug(locs, seed=_fold(seed, 1))

        vcoords, vfeats, _, _, first_idx = self.voxelizer.voxelize(locs, feats, seed=seed)
        # fused features aligned to the surviving voxels via their first point
        vgt = gt_feat[first_idx]
        vgt_mask = gt_mask[first_idx] & (np.linalg.norm(vgt, axis=-1) > 0)

        if self.postvox_aug is not None:
            vcoords, _, _ = self.postvox_aug(vcoords.astype(np.float64), seed=_fold(seed, 2))
            vcoords = vcoords.astype(np.int64)
            vcoords -= vcoords.min(0)

        v = len(vcoords)
        budget = self.voxel_budget
        if v > budget:
            # a RANDOM subset, reseeded per item: the sorted-unique order is
            # spatial (x-major), so a prefix would drop the same wall of the
            # room from supervision every epoch
            keep = np.random.default_rng(_fold(seed, 3)).choice(v, budget, replace=False)
            keep.sort()
            vcoords, vfeats = vcoords[keep], vfeats[keep]
            vgt, vgt_mask = vgt[keep], vgt_mask[keep]
            v = budget

        def pad(x, dtype):
            out = np.zeros((budget,) + x.shape[1:], dtype)
            out[:v] = x
            return out

        return DistillItem(
            coords=pad(vcoords, np.int32),
            feats=pad(vfeats, np.float32),
            gt=pad(vgt, np.float32),
            gt_mask=pad(vgt_mask, bool),
            mask=pad(np.ones(v, bool), bool),
            num_voxels=v,
        )
