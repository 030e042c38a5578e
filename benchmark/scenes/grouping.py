"""What a Gaussian Grouping cell adds to the room law: each training view's
object map, the Gaussians' identity field and the classifier, made on the
device.

An object map stands for the DEVA-associated SAM masks of their pipeline:
the id of the object that each pixel's ray meets first, by analytic ray
tests against the room law's own layout (scenes/room.py): 0 where the ray
meets nothing (no ceiling), 1 the floor, 2-5 the walls in the perimeter
walk's order (y = 0, x = lx, y = ly, x = 0), 6 + b box b. The ids are the
same across views, as associated masks are, and fixed by the layout, not
the seed. The field and the classifier are drawn from the seed: the field
at the late phase, N(0, 1) entries; the classifier as torch's Conv2d
initialises one, uniform in +-1 / sqrt(D).
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from .common import generator
from .room import _boxes

FLOOR, FIRST_WALL, FIRST_BOX = 1, 2, 6


def _rays(c2w: np.ndarray, fov_x: float, fov_y: float, width: int, height: int, device):
    """(origin [3], directions [H * W, 3]) of the pixel centres, in the
    rasterizer's convention (pixel i at NDC (2 i + 1) / W - 1; camera x
    right, y down, z forward)."""
    f64 = torch.float64
    x = (2 * torch.arange(width, dtype=f64, device=device) + 1) / width - 1
    y = (2 * torch.arange(height, dtype=f64, device=device) + 1) / height - 1
    yy, xx = torch.meshgrid(y * math.tan(fov_y / 2), x * math.tan(fov_x / 2), indexing="ij")
    cam = torch.stack([xx, yy, torch.ones_like(xx)], -1).reshape(-1, 3)
    rot = torch.tensor(c2w[:3, :3], dtype=f64, device=device)
    return torch.tensor(c2w[:3, 3], dtype=f64, device=device), cam @ rot.T


def _plane(o, d, axis: int, at: float, lo, hi):
    """The distance along each ray to the plane x_axis = at, where the hit
    lies inside the box [lo, hi] on the other two axes; inf elsewhere."""
    t = (at - o[axis]) / d[:, axis]  # inf (or nan) where the ray runs along the plane
    p = o + t[:, None] * d
    inside = (t > 0) & torch.isfinite(t)
    for a in range(3):
        if a != axis:
            inside &= (p[:, a] >= lo[a]) & (p[:, a] <= hi[a])
    return torch.where(inside, t, torch.full_like(t, math.inf))


def _box(o, d, lo, hi):
    """The entry distance of each ray into the box [lo, hi] (slab test);
    inf where it misses or starts inside."""
    inv = 1.0 / d
    lo_t = torch.tensor(lo, dtype=d.dtype, device=d.device)
    hi_t = torch.tensor(hi, dtype=d.dtype, device=d.device)
    t0, t1 = (lo_t - o) * inv, (hi_t - o) * inv
    near = torch.nan_to_num(torch.minimum(t0, t1), nan=-math.inf).amax(1)
    far = torch.nan_to_num(torch.maximum(t0, t1), nan=math.inf).amin(1)
    hit = (near <= far) & (near > 0)
    return torch.where(hit, near, torch.full_like(near, math.inf))


def object_map(cfg: Dict, c2w: np.ndarray, device) -> torch.Tensor:
    """[H, W] uint8: the id of the first object each pixel's ray meets."""
    room = cfg["room"]
    lx, ly, lz = room["size_m"]
    w, h = int(cfg["width"]), int(cfg["height"])
    o, d = _rays(c2w, cfg["fov_x"], cfg["fov_y"], w, h, device)
    big = 1e9
    hits = [_plane(o, d, 2, 0.0, (0, 0, -big), (lx, ly, big))]  # the floor
    for axis, at in ((1, 0.0), (0, lx), (1, ly), (0, 0.0)):  # the walls, in the walk's order
        hits.append(_plane(o, d, axis, at, (0, 0, 0), (lx, ly, lz)))
    lo, size = _boxes(room)
    for b in range(len(lo)):
        hits.append(_box(o, d, lo[b], lo[b] + size[b]))
    t = torch.stack(hits, 1)
    first, which = t.min(1)
    ids = torch.where(torch.isfinite(first), which + FLOOR, torch.zeros_like(which))
    return ids.reshape(h, w).to(torch.uint8)


def object_maps(cfg: Dict, poses: List[np.ndarray], device, which=None) -> torch.Tensor:
    """[len(which), H, W] uint8: the object maps of the views `which` (all
    by default)."""
    which = range(len(poses)) if which is None else which
    return torch.stack([object_map(cfg, poses[i], device) for i in which])


def identity_field(num: int, dim: int, seed: int, device) -> torch.Tensor:
    """[N, D] float32: N(0, 1) entries."""
    return torch.randn((num, dim), generator=generator(seed, device), device=device)


def classifier(num_classes: int, dim: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """{"classifier.weight" [C, D], "classifier.bias" [C]}: uniform in
    +-1 / sqrt(D), torch's Conv2d init."""
    g = generator(seed, device)
    bound = 1.0 / math.sqrt(dim)

    def draw(shape):
        return (torch.rand(shape, generator=g, device=device) * 2 - 1) * bound

    return {"classifier.weight": draw((num_classes, dim)), "classifier.bias": draw((num_classes,))}
