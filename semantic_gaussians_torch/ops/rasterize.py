"""Differentiable rasterization: projected Gaussians -> channel-last images.

Port of semantic_gaussians_tpu.ops.rasterize:
bin (ops.binning, with the pair-expand kernel) -> composite (the kernels of
ops.composite, which gather each pair's columns from the per-Gaussian
arrays through the sorted `pair_gaussian` ids) -> untile the tile-major
buffers to raster order. `backend="dense"` runs the sequential oracle
(ops.composite_ref) instead; autograd differentiates it directly.

The tiled path's gradient is `CompositeFunction`: the backward kernel gives
one gradient row per pair, and `pair_grads_to_gaussians` (the port of the
JAX package's `pack_gather` VJP) reduces them to per-Gaussian gradients
with the contiguous segment sum (ops.segsum) in place of atomic adds.

The JAX package gates the exact tile-ellipse cull on a TPU memory criterion
and environment variables; here it is the explicit `tight_cull` argument.
The cull is output-exact, so renders do not depend on it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..utils import tracing
from .binning import TileBinning, bin_gaussians, default_pair_budget
from .composite import GEOM_COLS, GRAD_GEOM_COLS, CompositeFunction, pack_geometry
from .composite_ref import rasterize_dense
from .projection import ProjectedGaussians
from .segsum import segsum_contiguous

DEFAULT_TILE: Tuple[int, int] = (16, 32)
WIDE_BLOCK_COLS = 128  # columns of pair rows reduced at once, where rows are wider


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


def generation_rows(rows: torch.Tensor, binning: TileBinning) -> torch.Tensor:
    """Tile-sorted per-pair rows -> generation order, non-live rows zeroed
    (steps 1-2 of `pair_grads_to_gaussians`)."""
    gen = torch.empty_like(rows)
    gen[binning.gen_of_tile_pos.long()] = rows
    return gen.masked_fill_(~binning.gen_live[:, None], 0.0)


def pair_grads_to_gaussians(rows: torch.Tensor, binning: TileBinning):
    """Per-pair gradient rows [P, 6 + C] in tile-sorted order -> per-Gaussian
    (d_geom [N, 8], d_colors [N, C]); the port of `pack_gather`'s VJP:

    1. permute the rows to generation order (where each Gaussian's pairs
       are contiguous) through `gen_of_tile_pos`;
    2. zero the rows of pairs that are not live (invalid slots and
       tight-culled pairs: the backward leaves them unwritten, and 0 * NaN
       would poison a sum);
    3. segment-sum them by `gen_owner` (the segsum kernel; rows past
       `num_pairs` are all invalid and are skipped);
    4. gather the sums back to original ids through `orig_to_dense`;
       Gaussians without pairs (the sentinel) get exactly zero.
    The permutation and masking are plain torch, in place on one copy.
    Rows wider than WIDE_BLOCK_COLS (a feature field's 6 + 3 + D) go
    through steps 1-3 a block of that many columns at a time, so that the
    generation-order copy holds one block, not all P (6 + C) floats (8.7 GB
    at C = 515 and 2^22 pairs)."""
    tracing.phase("segsum", rows.device)
    n = binning.orig_to_dense.shape[0]
    width = rows.shape[1]
    if width <= WIDE_BLOCK_COLS:
        gen = generation_rows(rows, binning)
        dense = segsum_contiguous(gen, binning.gen_owner, n + 1, limit=binning.num_pairs)
    else:
        dense = rows.new_empty((n + 1, width))
        for c in range(0, width, WIDE_BLOCK_COLS):
            gen = generation_rows(rows[:, c:c + WIDE_BLOCK_COLS], binning)
            dense[:, c:c + WIDE_BLOCK_COLS] = segsum_contiguous(
                gen, binning.gen_owner, n + 1, limit=binning.num_pairs)
            del gen
    has_pairs = (binning.orig_to_dense < n)[:, None]
    per = torch.where(has_pairs, dense[binning.orig_to_dense.long()], 0.0)
    d_geom = torch.cat(
        [per[:, :GRAD_GEOM_COLS], per.new_zeros((n, GEOM_COLS - GRAD_GEOM_COLS))], dim=1
    )
    return d_geom, per[:, GRAD_GEOM_COLS:]


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
    tracing.phase("bin", bg.device)
    binning = bin_gaussians(
        proj.means2d, proj.depths, proj.radii_xy, tile_shape, grid, budget,
        cull_ellipse=proj.cull_ellipse,
    )
    geom = pack_geometry(proj.means2d, proj.conics, proj.opacities, proj.depths)
    colors = proj.colors.to(torch.float32).contiguous()
    tracing.phase("composite", bg.device)
    color, depth, final_t, n_contrib = CompositeFunction.apply(
        geom, colors, bg, binning.pair_gaussian, binning.tile_start,
        binning.tile_count, grid[1], th, tw,
        lambda rows: pair_grads_to_gaussians(rows, binning),
    )
    return dict(
        render=_untile(color, grid, tile_shape, img_height, img_width),
        depth=_untile(depth, grid, tile_shape, img_height, img_width),
        final_T=_untile(final_t, grid, tile_shape, img_height, img_width),
        n_contrib=_untile(n_contrib, grid, tile_shape, img_height, img_width),
        overflow=binning.overflow,
        num_pairs=binning.num_pairs,
    )
