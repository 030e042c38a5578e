"""The orbit law: an unbounded outdoor capture around a central object.

A table with an object on it in the middle, ground around it out to the
configuration's radius, and a background shell far off (trees, walls), in
the shares the configuration gives; the cameras ring the table at a fixed
height, facing inward, as a Mip-NeRF 360 capture walks around its
subject. The layout (table, ring) is the configuration's; the seed draws
the Gaussians and the images.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from .common import gaussians_on, generator, look_pose, uniform


def scene(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The configuration's Gaussians, drawn from `seed` on `device`."""
    o = cfg["orbit"]
    n = int(cfg["num_gaussians"])
    g = generator(seed, device)
    n_obj = int(n * o["share_object"])
    n_ground = int(n * o["share_ground"])
    n_back = n - n_obj - n_ground
    tr, th = o["table_radius_m"], o["table_height_m"]
    # the object: a table top and a blob on it
    half = n_obj // 2
    r = tr * torch.sqrt(torch.rand(half, generator=g, device=device))
    a = uniform(g, (half,), 0, 2 * math.pi, device)
    top = torch.stack([r * torch.cos(a), r * torch.sin(a), torch.full_like(r, th)], 1)
    d = torch.randn((n_obj - half, 3), generator=g, device=device)
    d = d / torch.linalg.norm(d, dim=1, keepdim=True)
    blob = d * torch.tensor([0.3, 0.3, 0.45], device=device) + torch.tensor(
        [0.0, 0.0, th + 0.45], device=device)
    # the ground: a disc, uniform in area
    gr = o["ground_radius_m"] * torch.sqrt(torch.rand(n_ground, generator=g, device=device))
    ga = uniform(g, (n_ground,), 0, 2 * math.pi, device)
    ground = torch.stack([gr * torch.cos(ga), gr * torch.sin(ga), torch.zeros_like(gr)], 1)
    # the background: a cylinder shell
    br = uniform(g, (n_back,), o["back_radius_m"][0], o["back_radius_m"][1], device)
    ba = uniform(g, (n_back,), 0, 2 * math.pi, device)
    bz = uniform(g, (n_back,), 0, o["back_height_m"], device)
    back = torch.stack([br * torch.cos(ba), br * torch.sin(ba), bz], 1)
    points = torch.cat([top, blob, ground, back])
    points = points + torch.randn(points.shape, generator=g, device=device) * 0.003
    area_obj = math.pi * tr * tr + 4 * math.pi * 0.35 ** 2
    area_ground = math.pi * o["ground_radius_m"] ** 2
    r_mid = sum(o["back_radius_m"]) / 2
    area_back = 2 * math.pi * r_mid * o["back_height_m"]
    spacing = torch.cat([
        torch.full((n_obj,), math.sqrt(area_obj / n_obj), device=device),
        torch.full((n_ground,), math.sqrt(area_ground / n_ground), device=device),
        torch.full((n_back,), math.sqrt(area_back / n_back), device=device),
    ]) * o["splat_scale"]
    rgb = torch.cat([
        torch.tensor([0.55, 0.35, 0.25], device=device).expand(half, 3),
        torch.tensor([0.75, 0.70, 0.30], device=device).expand(n_obj - half, 3),
        torch.tensor([0.30, 0.45, 0.20], device=device).expand(n_ground, 3),
        torch.tensor([0.25, 0.35, 0.30], device=device).expand(n_back, 3),
    ]) + 0.1 * torch.sin(points[:, :1] * 2.0 + points[:, 1:2])
    return gaussians_on(points, spacing, rgb, int(cfg["sh_degree"]), g)


def poses(cfg: Dict) -> List[np.ndarray]:
    """`views` inward-facing poses on the ring, in capture order."""
    o = cfg["orbit"]
    rng = np.random.default_rng([o["layout_seed"], 13])
    target = np.array([0.0, 0.0, o["table_height_m"]])
    out = []
    for k in range(int(cfg["views"])):
        a = 2 * math.pi * k / cfg["views"]
        eye = np.array([o["ring_radius_m"] * math.cos(a), o["ring_radius_m"] * math.sin(a),
                        o["ring_height_m"] + rng.normal(0, 0.15)])
        out.append(look_pose(eye, target + rng.normal(0, 0.1, 3) - eye))
    return out


def train_poses(cfg: Dict) -> List[np.ndarray]:
    """Every view but each `eval_hold`-th, which is held out for testing."""
    hold = int(cfg["eval_hold"])
    return [p for i, p in enumerate(poses(cfg)) if i % hold != 0]
