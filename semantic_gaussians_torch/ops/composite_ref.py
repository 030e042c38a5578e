"""Dense reference compositor — the correctness oracle.

Port of semantic_gaussians_tpu.ops.composite_ref: every Gaussian over every
pixel, in global depth order, one Gaussian per step. Slow by design; it
backs `backend="dense"`. With `tile_shape` given, contributions are
restricted to each Gaussian's tile rect and to the tiles the exact
tile-ellipse cull keeps, so n_contrib (the 1-based walk index of the last
contributor) is comparable with the tiled path.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .expand import TIGHTCULL_MARGIN, tile_min_qn
from .projection import ProjectedGaussians

ALPHA_CUTOFF = 1.0 / 255.0
T_EPS = 1e-4
MAX_ALPHA = 0.99
MEDIAN_DEPTH_INIT = 15.0


def rasterize_dense(
    proj: ProjectedGaussians,
    img_width: int,
    img_height: int,
    bg: torch.Tensor,  # [C]
    tile_shape: Optional[Tuple[int, int]] = None,  # (tile_h, tile_w)
) -> dict:
    """Returns dict(render [H,W,C], depth, final_T, n_contrib [H,W])."""
    dev = proj.means2d.device
    f32 = torch.float32
    n = proj.means2d.shape[0]
    num_ch = proj.colors.shape[-1]
    has_rect = (proj.radii_xy[:, 0] > 0) & (proj.radii_xy[:, 1] > 0)
    sort_depth = torch.where(has_rect, proj.depths, torch.full_like(proj.depths, float("inf")))
    order = torch.argsort(sort_depth, stable=True)
    means2d = proj.means2d[order]
    conics = proj.conics[order]
    opac = proj.opacities[order]
    colors = proj.colors[order]
    depths = proj.depths[order]
    radii_xy = proj.radii_xy[order]
    cull_e = (
        torch.zeros((n, 3), dtype=f32, device=dev)
        if proj.cull_ellipse is None
        else proj.cull_ellipse[order]
    )

    px_y, px_x = torch.meshgrid(
        torch.arange(img_height, dtype=f32, device=dev),
        torch.arange(img_width, dtype=f32, device=dev),
        indexing="ij",
    )
    if tile_shape is not None:
        th, tw = tile_shape
        ntx = -(-img_width // tw)
        nty = -(-img_height // th)
        tile_ix = (px_x / tw).to(torch.int32)
        tile_iy = (px_y / th).to(torch.int32)

    T = torch.ones((img_height, img_width), dtype=f32, device=dev)
    C = torch.zeros((img_height, img_width, num_ch), dtype=f32, device=dev)
    D = torch.full((img_height, img_width), MEDIAN_DEPTH_INIT, dtype=f32, device=dev)
    done = torch.zeros((img_height, img_width), dtype=torch.bool, device=dev)
    n_contrib = torch.zeros((img_height, img_width), dtype=torch.int32, device=dev)
    walk = torch.zeros((img_height, img_width), dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    for k in range(n):
        mean2d, conic, o, depth = means2d[k], conics[k], opac[k], depths[k]
        dx = mean2d[0] - px_x
        dy = mean2d[1] - px_y
        power = -0.5 * (conic[0] * dx * dx + conic[2] * dy * dy) - conic[1] * dx * dy
        alpha = torch.clamp(o * torch.exp(torch.clamp(power, max=0.0)), max=MAX_ALPHA)
        candidate = (power <= 0.0) & (alpha >= ALPHA_CUTOFF)
        if tile_shape is not None:
            rx = radii_xy[k, 0].to(f32)
            ry = radii_xy[k, 1].to(f32)
            x0 = torch.clamp(torch.floor((mean2d[0] - rx) / tw), 0, ntx).to(torch.int32)
            x1 = torch.clamp(torch.floor((mean2d[0] + rx + tw - 1) / tw), 0, ntx).to(torch.int32)
            y0 = torch.clamp(torch.floor((mean2d[1] - ry) / th), 0, nty).to(torch.int32)
            y1 = torch.clamp(torch.floor((mean2d[1] + ry + th - 1) / th), 0, nty).to(torch.int32)
            in_rect = (tile_ix >= x0) & (tile_ix < x1) & (tile_iy >= y0) & (tile_iy < y1)
            lox = (tile_ix * tw).to(f32) - mean2d[0]
            hix = lox + float(tw - 1)
            loy = (tile_iy * th).to(f32) - mean2d[1]
            hiy = loy + float(th - 1)
            ce = cull_e[k]
            qn = tile_min_qn(lox, hix, loy, hiy, ce[0], ce[1], ce[2])
            in_rect = in_rect & ~(qn > TIGHTCULL_MARGIN)
            candidate = candidate & in_rect
        test_t = T * (1.0 - alpha)
        terminate = candidate & (test_t < T_EPS)
        contribute = candidate & ~terminate & ~done
        w = torch.where(contribute, alpha * T, zero)
        C = C + w[..., None] * colors[k][None, None, :]
        D = torch.where(contribute & (T > 0.5) & (test_t < 0.5), depth, D)
        T = torch.where(contribute, test_t, T)
        done = done | terminate
        # n_contrib counts every pair WALKED in the pixel's list (in_rect
        # when tiled) and records that index at the last contribution.
        if tile_shape is not None:
            in_list = in_rect & (radii_xy[k, 0] > 0) & (radii_xy[k, 1] > 0)
            walk = walk + in_list.to(torch.int32)
        else:
            walk = walk + 1
        n_contrib = torch.where(contribute, walk, n_contrib)
    render = C + T[..., None] * bg[None, None, :]
    return dict(render=render, depth=D, final_T=T, n_contrib=n_contrib)
