"""The room law: an indoor scan of a ScanNet-sized room.

Gaussians lie on the floor, the four walls and the faces of boxes that
stand on the floor (furniture), in the shares the configuration gives;
cameras follow a handheld sweep around the room's middle, looking out at
the walls and down at the floor as a person scanning the room holds them.
No ceiling: a handheld scan rarely covers it.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from .common import gaussians_on, generator, look_pose, uniform


def _boxes(room: Dict):
    """The furniture, standing along the walls: fixed by the configuration's
    layout, not the seed, so that every seed asks the same work of the
    renderer."""
    rng = np.random.default_rng([room["layout_seed"], 11])
    lx, ly, _ = room["size_m"]
    b = room["boxes"]
    size = rng.uniform(room["box_min_m"], room["box_max_m"], size=(b, 3))
    wall = np.arange(b) % 4
    gap = rng.uniform(0.05, 0.3, size=b)
    along_x = rng.uniform(0.2, lx - size[:, 0] - 0.2)
    along_y = rng.uniform(0.2, ly - size[:, 1] - 0.2)
    x = np.select([wall == 0, wall == 1], [along_x, lx - size[:, 0] - gap],
                  np.where(wall == 2, along_x, gap))
    y = np.select([wall == 0, wall == 1], [gap, along_y],
                  np.where(wall == 2, ly - size[:, 1] - gap, along_y))
    return np.stack([x, y, np.zeros(b)], 1), size


def scene(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The configuration's Gaussians, drawn from `seed` on `device`."""
    room = cfg["room"]
    n = int(cfg["num_gaussians"])
    g = generator(seed, device)
    lx, ly, lz = room["size_m"]
    n_floor = int(n * room["share_floor"])
    n_wall = int(n * room["share_walls"])
    n_box = n - n_floor - n_wall
    pts, rgb = [], []
    # floor
    p = torch.stack([uniform(g, (n_floor,), 0, lx, device), uniform(g, (n_floor,), 0, ly, device),
                     torch.zeros(n_floor, device=device)], 1)
    pts.append(p)
    rgb.append(torch.tensor([0.45, 0.33, 0.22], device=device).expand(n_floor, 3)
               + 0.1 * torch.sin(p[:, :1] * 3.0))
    # walls: a walk along the perimeter
    per = 2 * (lx + ly)
    t = uniform(g, (n_wall,), 0, per, device)
    z = uniform(g, (n_wall,), 0, lz, device)
    x = torch.where(t < lx, t, torch.where(t < lx + ly, torch.full_like(t, lx),
                    torch.where(t < 2 * lx + ly, 2 * lx + ly - t, torch.zeros_like(t))))
    y = torch.where(t < lx, torch.zeros_like(t), torch.where(t < lx + ly, t - lx,
                    torch.where(t < 2 * lx + ly, torch.full_like(t, ly), per - t)))
    pts.append(torch.stack([x, y, z], 1))
    rgb.append(torch.tensor([0.80, 0.78, 0.70], device=device).expand(n_wall, 3)
               + 0.08 * torch.sin(t[:, None] * 2.0 + z[:, None]))
    # boxes: five faces each (no bottom), a face drawn by its area
    lo, size = _boxes(room)
    sx, sy, sz = size[:, 0], size[:, 1], size[:, 2]
    areas = np.stack([sx * sy, sx * sz, sx * sz, sy * sz, sy * sz], 1)
    flat = torch.tensor((areas / areas.sum()).reshape(-1), dtype=torch.float32, device=device)
    pick = torch.multinomial(flat, n_box, replacement=True, generator=g)
    box, face = pick // 5, pick % 5
    lo_t = torch.tensor(lo, dtype=torch.float32, device=device)[box]
    sz_t = torch.tensor(size, dtype=torch.float32, device=device)[box]
    u = torch.rand((n_box, 3), generator=g, device=device)
    fixed = torch.tensor([[0, 0, 1], [0, 0, 0], [0, 1, 0], [0, 0, 0], [1, 0, 0]],
                         dtype=torch.float32, device=device)  # where a face sits
    axis = torch.tensor([2, 1, 1, 0, 0], device=device)  # the axis it is normal to
    u.scatter_(1, axis[face][:, None], fixed[face].gather(1, axis[face][:, None]))
    pts.append(lo_t + u * sz_t)
    box_rgb = torch.rand((len(lo), 3), generator=g, device=device) * 0.8 + 0.1
    rgb.append(box_rgb[box])
    points = torch.cat(pts) + torch.randn((n, 3), generator=g, device=device) * 0.004
    area = lx * ly + per * lz + float(areas.sum())
    spacing = torch.full((n,), room["splat_scale"] * math.sqrt(area / n), device=device)
    return gaussians_on(points, spacing, torch.cat(rgb), int(cfg["sh_degree"]), g)


def train_poses(cfg: Dict) -> List[np.ndarray]:
    """The handheld sweep, every frame a training view: `views` poses on two loops
    around the room's middle at head height, looking outward and down;
    fixed by the layout, like the furniture."""
    room = cfg["room"]
    lx, ly, _ = room["size_m"]
    v = int(cfg["views"])
    rng = np.random.default_rng([room["layout_seed"], 12])
    out = []
    for k in range(v):
        a = 4 * math.pi * k / v + rng.normal(0, 0.05)
        eye = np.array([lx / 2 + 0.15 * lx * math.cos(a), ly / 2 + 0.15 * ly * math.sin(a),
                        rng.normal(1.45, 0.12)])
        yaw = a + rng.normal(0, 0.25)
        pitch = rng.normal(0.35, 0.05)
        fwd = np.array([math.cos(pitch) * math.cos(yaw), math.cos(pitch) * math.sin(yaw),
                        -math.sin(pitch)])
        out.append(look_pose(eye, fwd))
    return out
