"""What the scene laws share: Gaussian attributes around given surface
points, camera poses that look along a direction, the ground-truth images.

Everything is drawn on the device from one `torch.Generator`, in a few
large calls, in float32 (the port's training precision).
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

SH_C0 = 0.28209479177387814


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def uniform(g, shape, lo, hi, device):
    return torch.rand(shape, generator=g, device=device) * (hi - lo) + lo


def gaussians_on(points: torch.Tensor, spacing: torch.Tensor, base_rgb: torch.Tensor,
                 sh_degree: int, g: torch.Generator) -> Dict[str, torch.Tensor]:
    """Gaussian parameters for surface samples `points` [N, 3]: flat
    splats (two axes log-normal about twice the local `spacing` [N], so
    that neighbours overlap as a trained scene's do, the third a third of
    it), random orientations, two populations of opacity (65% nearly
    opaque, 35% faint, as a trained scene has), colour `base_rgb` [N, 3]
    with SH degree `sh_degree` view dependence of a few percent."""
    dev = points.device
    n = points.shape[0]
    k = (sh_degree + 1) ** 2 - 1
    ls = torch.log(2.0 * spacing)[:, None] + torch.randn((n, 3), generator=g, device=dev) * 0.4
    ls[:, 2] -= math.log(3.0)
    opaque = torch.rand((n, 1), generator=g, device=dev) < 0.65
    logits = torch.where(opaque, uniform(g, (n, 1), 1.0, 4.0, dev),
                         uniform(g, (n, 1), -4.0, 0.0, dev))
    rgb = torch.clamp(base_rgb + torch.randn((n, 3), generator=g, device=dev) * 0.05, 0.02, 0.98)
    return dict(
        means=points.contiguous(),
        sh_dc=((rgb - 0.5) / SH_C0)[:, None, :].contiguous(),
        sh_rest=(torch.randn((n, k, 3), generator=g, device=dev) * 0.03).contiguous(),
        log_scales=ls.contiguous(),
        quats=torch.randn((n, 4), generator=g, device=dev),
        opacity_logits=logits.contiguous(),
    )


def look_pose(eye: np.ndarray, forward: np.ndarray) -> np.ndarray:
    """4x4 camera-to-world of a camera at `eye` looking along `forward`
    (world z up; camera x right, y down, z forward)."""
    f = forward / np.linalg.norm(forward)
    right = np.cross(f, np.array([0.0, 0.0, 1.0]))
    right /= np.linalg.norm(right)
    down = np.cross(f, right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down, f, eye
    return c2w


def scene_extent(poses) -> float:
    """The 3DGS spatial scale: 1.1 x the largest distance of a camera
    centre from their mean (getNerfppNorm's radius)."""
    c = np.stack([p[:3, 3] for p in poses])
    return float(1.1 * np.linalg.norm(c - c.mean(0), axis=1).max())


def target_images(num: int, height: int, width: int, seed: int, device,
                  which=None) -> torch.Tensor:
    """[len(which), H, W, 3] smooth colour fields in [0.05, 0.95], one a
    view (all `num` views by default): two plane waves a channel with
    directions and phases drawn from `seed`, so that any view can be made
    again alone."""
    g = generator(seed, device)
    freq = uniform(g, (num, 2, 3, 2), -6.0, 6.0, device)
    phase = uniform(g, (num, 2, 3), 0.0, 2 * math.pi, device)
    yy = torch.linspace(0, 1, height, device=device)[:, None]
    xx = torch.linspace(0, 1, width, device=device)[None, :]
    which = range(num) if which is None else which
    out = torch.empty((len(which), height, width, 3), device=device)
    for j, i in enumerate(which):  # a view at a time: a 1080p stack of waves is large
        f, p = freq[i], phase[i]
        wave = torch.sin(f[:, :, 0, None, None] * 2 * xx + f[:, :, 1, None, None] * 2 * yy
                         + p[:, :, None, None]).mean(0)  # [3, H, W]
        out[j] = (0.5 + 0.45 * wave).permute(1, 2, 0)
    return out
