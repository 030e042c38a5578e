"""What a Feature 3DGS cell adds to a scene law: the 2D teacher's feature
maps of the training views and the Gaussians' feature field, drawn from
the seed on the device.

A teacher map stands for LSeg's output: a smooth field of D-dim vectors,
unit length at every pixel (LSeg normalises its per-pixel embedding), held
in float16 as exported maps are. The field starts where a trained one is:
a unit vector a Gaussian.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import generator

GRID = (6, 8)  # (rows, columns) of a teacher map's random anchors


def teacher_maps(num: int, height: int, width: int, dim: int, seed: int, device,
                 which=None) -> torch.Tensor:
    """[len(which), H, W, D] float16 (all `num` views by default): random
    anchors on a coarse grid a view, interpolated bilinearly and made unit
    length per pixel; any view can be made again alone."""
    g = generator(seed, device)
    anchors = torch.randn((num, dim) + GRID, generator=g, device=device)
    which = range(num) if which is None else which
    out = torch.empty((len(which), height, width, dim), dtype=torch.float16, device=device)
    for j, i in enumerate(which):  # a view at a time: one float32 map is 0.64 GB at 648x484
        m = F.interpolate(anchors[i:i + 1], size=(height, width), mode="bilinear",
                          align_corners=True)[0]
        m = m / torch.linalg.vector_norm(m, dim=0, keepdim=True)
        out[j] = m.permute(1, 2, 0)
    return out


def feature_field(num: int, dim: int, seed: int, device) -> torch.Tensor:
    """[N, D] float32: a random unit vector a Gaussian."""
    f = torch.randn((num, dim), generator=generator(seed, device), device=device)
    return f / torch.linalg.vector_norm(f, dim=1, keepdim=True)
