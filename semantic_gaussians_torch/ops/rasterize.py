"""Rasterization: projected Gaussians -> channel-last images.

Port of the forward of semantic_gaussians_tpu.ops.rasterize:
bin (ops.binning, with the pair-expand kernel) -> composite (the forward
kernel of ops.composite, which gathers each pair's columns from the
per-Gaussian arrays through the sorted `pair_gaussian` ids) -> untile the
tile-major buffers to raster order. `backend="dense"` runs the sequential
oracle (ops.composite_ref) instead.

The JAX package gates the exact tile-ellipse cull on a TPU memory criterion
and environment variables; here it is the explicit `tight_cull` argument.
The cull is output-exact, so renders do not depend on it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .binning import bin_gaussians, default_pair_budget
from .composite import composite_forward, pack_geometry
from .composite_ref import rasterize_dense
from .projection import ProjectedGaussians

DEFAULT_TILE: Tuple[int, int] = (16, 32)


def _untile(tile_major: torch.Tensor, grid_shape, tile_shape, h: int, w: int):
    """(num_tiles, PX) -> [H, W], or (num_tiles, C, PX) -> [H, W, C], cropped."""
    gh, gw = grid_shape
    th, tw = tile_shape
    if tile_major.dim() == 2:
        x = tile_major.reshape(gh, gw, th, tw).permute(0, 2, 1, 3)
        return x.reshape(gh * th, gw * tw)[:h, :w]
    c = tile_major.shape[1]
    x = tile_major.reshape(gh, gw, c, th, tw).permute(0, 3, 1, 4, 2)
    return x.reshape(gh * th, gw * tw, c)[:h, :w]


def rasterize(
    proj: ProjectedGaussians,
    bg: torch.Tensor,
    img_width: int,
    img_height: int,
    tile_shape: Optional[Tuple[int, int]] = DEFAULT_TILE,
    pair_budget: Optional[int] = None,
    backend: str = "tiled",  # "tiled" | "dense"
    tight_cull: bool = True,
) -> dict:
    """Returns dict(render [H,W,C], depth [H,W], final_T [H,W],
    n_contrib [H,W] int32, overflow [] int32, num_pairs [] int32)."""
    tile_shape = tile_shape or DEFAULT_TILE
    if not tight_cull:
        proj = dataclasses.replace(proj, cull_ellipse=None)
    bg = bg.to(device=proj.means2d.device, dtype=torch.float32).contiguous()

    if backend == "dense":
        out = rasterize_dense(proj, img_width, img_height, bg, tile_shape)
        zero = torch.zeros((), dtype=torch.int32, device=bg.device)
        out["overflow"] = zero
        out["num_pairs"] = zero
        return out
    if backend != "tiled":
        raise ValueError(f"unknown backend {backend!r}")

    th, tw = tile_shape
    grid = (-(-img_height // th), -(-img_width // tw))
    n = proj.means2d.shape[0]
    budget = pair_budget or default_pair_budget(n)
    binning = bin_gaussians(
        proj.means2d, proj.depths, proj.radii_xy, tile_shape, grid, budget,
        cull_ellipse=proj.cull_ellipse,
    )
    geom = pack_geometry(proj.means2d, proj.conics, proj.opacities, proj.depths)
    colors = proj.colors.to(torch.float32).contiguous()
    color, depth, final_t, n_contrib = composite_forward(
        geom, colors, binning.pair_gaussian, binning.tile_start,
        binning.tile_count, bg, grid[1], th, tw,
    )
    return dict(
        render=_untile(color, grid, tile_shape, img_height, img_width),
        depth=_untile(depth, grid, tile_shape, img_height, img_width),
        final_T=_untile(final_t, grid, tile_shape, img_height, img_width),
        n_contrib=_untile(n_contrib, grid, tile_shape, img_height, img_width),
        overflow=binning.overflow,
        num_pairs=binning.num_pairs,
    )
