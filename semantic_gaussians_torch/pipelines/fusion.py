"""Fused per-Gaussian features on disk.

Port of the I/O half of semantic_gaussians_tpu.pipelines.fusion: the
reference's `.pt` layout {feat: half [M, C], mask_full: bool [N]}, where
`feat` holds the rows of the visited Gaussians. Fusion itself is ported in a
later slice.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np
import torch


def save_fused_features(out_path, features: np.ndarray, visited: np.ndarray):
    """Write {feat: half [M, C], mask_full: bool [N]} to `out_path`."""
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    mask_full = np.asarray(visited).astype(bool)
    feat = torch.from_numpy(np.asarray(features, np.float32)[mask_full]).half()
    torch.save({"feat": feat, "mask_full": torch.from_numpy(mask_full)}, out_path)


def load_fused_features(
    path,
    capacity: Optional[int] = None,
    device: Union[str, torch.device] = "cpu",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Load a {feat, mask_full} .pt file -> (features [cap, C] float32,
    visited [cap] bool) on `device`."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    mask = obj["mask_full"].bool()
    feat = obj["feat"].float()
    n = mask.shape[0]
    cap = capacity or n
    out = torch.zeros((cap, feat.shape[-1]), dtype=torch.float32)
    out_mask = torch.zeros(cap, dtype=torch.bool)
    out_mask[:n] = mask
    out[out_mask] = feat
    return out.to(device), out_mask.to(device)
