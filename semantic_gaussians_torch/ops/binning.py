"""Tile binning: per-Gaussian tile rects, depth sort, pair expand, stable
tile sort, per-tile ranges.

Port of semantic_gaussians_tpu.ops.binning. The sorts and searches are
plain torch (`torch.sort(stable=True)`, `torch.searchsorted`); the pair
expansion is the CUDA kernel of ops.expand. Every field is bit-identical to
the JAX package's for the same projected inputs. Prefix sums run in int64
(the JAX package's f32 cumsum is exact below 2^24, where the two agree).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .expand import expand_pairs


@dataclasses.dataclass(frozen=True)
class TileBinning:
    """Sorted (tile, depth) pair list + per-tile ranges (fields as in the
    JAX package; "generation order" is the pre-tile-sort order, where each
    Gaussian's pairs are contiguous)."""

    pair_gaussian: torch.Tensor  # [budget] int32 gaussian id (N = invalid)
    pair_tile: torch.Tensor  # [budget] int32 tile id (num_tiles = invalid)
    tile_start: torch.Tensor  # [num_tiles] int32
    tile_count: torch.Tensor  # [num_tiles] int32
    num_pairs: torch.Tensor  # [] int32 valid pairs (clipped to the budget)
    overflow: torch.Tensor  # [] int32 pairs dropped for the budget
    gen_of_tile_pos: torch.Tensor  # [budget] int32 tile sort's permutation
    gen_owner: torch.Tensor  # [budget] int32 dense owner rank (generation order)
    orig_to_dense: torch.Tensor  # [N] int32 original id -> dense rank or N
    gen_live: torch.Tensor  # [budget] bool, generation order: in a tile range


def tile_rects(
    means2d: torch.Tensor,
    radii_xy: torch.Tensor,  # [N, 2] per-axis half-extents (0 = culled)
    tile_shape: Tuple[int, int],
    grid_shape: Tuple[int, int],
):
    """Per-Gaussian touched tile rectangle [x0, x1) x [y0, y1) and count."""
    th, tw = tile_shape
    nty, ntx = grid_shape
    rx = radii_xy[:, 0].to(torch.float32)
    ry = radii_xy[:, 1].to(torch.float32)
    x, y = means2d[:, 0], means2d[:, 1]
    x0 = torch.clamp(torch.floor((x - rx) / tw), 0, ntx).to(torch.int32)
    x1 = torch.clamp(torch.floor((x + rx + tw - 1) / tw), 0, ntx).to(torch.int32)
    y0 = torch.clamp(torch.floor((y - ry) / th), 0, nty).to(torch.int32)
    y1 = torch.clamp(torch.floor((y + ry + th - 1) / th), 0, nty).to(torch.int32)
    counts = torch.where(
        (radii_xy[:, 0] > 0) & (radii_xy[:, 1] > 0),
        (x1 - x0) * (y1 - y0),
        torch.zeros_like(x0),
    )
    return x0, x1, y0, y1, counts


@dataclasses.dataclass(frozen=True)
class ExpandInputs:
    """The pair-expand kernel's inputs: the depth-ordered per-Gaussian
    table and the pair totals."""

    order: torch.Tensor  # [N] int64 depth order (stable; zero-count last)
    offsets: torch.Tensor  # [N] int32 exclusive cumsum, clamped to budget+1
    rect_packed_d: torch.Tensor  # [N] int32 x0<<16 | y0<<8 | w
    idx_d: torch.Tensor  # [N] int32 original gaussian id
    cull_d: Optional[torch.Tensor]  # (5, N) f32 mean_x, mean_y, e0, e1, e2
    nonzero: torch.Tensor  # [N] bool pair-emitting, depth order
    num_pairs: torch.Tensor  # [] int32 valid pairs (clipped to the budget)
    num_dense: torch.Tensor  # [] int32 pair-emitting gaussians
    overflow: torch.Tensor  # [] int32 pairs dropped for the budget


def depth_sorted_rects(
    means2d: torch.Tensor,
    depths: torch.Tensor,
    radii_xy: torch.Tensor,
    tile_shape: Tuple[int, int],
    grid_shape: Tuple[int, int],
    pair_budget: int,
    cull_ellipse: Optional[torch.Tensor] = None,
) -> ExpandInputs:
    """Tile rects, stable depth sort and pair offsets: everything the pair
    expansion reads."""
    nty, ntx = grid_shape
    i32 = torch.int32
    # The rect triple is bit-packed x0<<16 | y0<<8 | w: each must be < 256.
    if ntx >= 256 or nty >= 256:
        raise ValueError(f"grid {grid_shape} exceeds the 255x255-tile packed-rect bound")
    if pair_budget >= (1 << 24):
        raise ValueError("pair budget must stay below 2^24")

    x0, x1, y0, y1, counts = tile_rects(means2d, radii_xy, tile_shape, grid_shape)
    inf = torch.full_like(depths, float("inf"))
    depth_key = torch.where(counts > 0, depths, inf)
    rect_packed = (x0 << 16) | (y0 << 8) | torch.clamp(x1 - x0, min=1)
    # Stable depth sort: ties (and the zero-count tail, keyed +inf) keep
    # their original order, as the JAX package's lax.sort(is_stable=True).
    _, order = torch.sort(depth_key, stable=True)
    counts_d = counts[order]
    cull_d = None
    if cull_ellipse is not None:
        cull_d = torch.stack(
            [means2d[:, 0], means2d[:, 1], cull_ellipse[:, 0], cull_ellipse[:, 1],
             cull_ellipse[:, 2]],
            dim=0,
        )[:, order].to(torch.float32).contiguous()
    cum = torch.cumsum(counts_d.to(torch.int64), 0)
    total = torch.clamp(cum[-1], max=2**31 - 128)
    nonzero = counts_d > 0
    return ExpandInputs(
        order=order,
        offsets=torch.clamp(cum - counts_d, max=pair_budget + 1).to(i32).contiguous(),
        rect_packed_d=rect_packed[order].contiguous(),
        idx_d=order.to(i32),
        cull_d=cull_d,
        nonzero=nonzero,
        num_pairs=torch.clamp(total, max=pair_budget).to(i32),
        num_dense=nonzero.sum().to(i32),
        overflow=torch.clamp(total - pair_budget, min=0).to(i32),
    )


def bin_gaussians(
    means2d: torch.Tensor,
    depths: torch.Tensor,
    radii_xy: torch.Tensor,
    tile_shape: Tuple[int, int],
    grid_shape: Tuple[int, int],
    pair_budget: int,
    cull_ellipse: Optional[torch.Tensor] = None,  # [N, 3] conic / r^2;
    # enables the exact tile-ellipse cull (output-exact). None disables.
) -> TileBinning:
    n = means2d.shape[0]
    num_tiles = grid_shape[0] * grid_shape[1]
    dev = means2d.device
    i32 = torch.int32
    ex = depth_sorted_rects(
        means2d, depths, radii_xy, tile_shape, grid_shape, pair_budget, cull_ellipse
    )
    tile, g_key, gen_owner = expand_pairs(
        ex.offsets, ex.rect_packed_d, ex.idx_d, ex.cull_d, ex.num_pairs,
        ex.num_dense, pair_budget, grid_shape[1], num_tiles, n,
        tile_w=tile_shape[1], tile_h=tile_shape[0],
    )
    # original id -> dense rank (or N for zero-pair gaussians).
    orig_to_dense = torch.empty(n, dtype=i32, device=dev)
    orig_to_dense[ex.order] = torch.where(
        ex.nonzero, torch.arange(n, dtype=i32, device=dev), torch.full_like(ex.idx_d, n)
    )
    sorted_tile, perm = torch.sort(tile, stable=True)
    tile_ids = torch.arange(num_tiles, dtype=i32, device=dev)
    tile_start = torch.searchsorted(sorted_tile, tile_ids, side="left", out_int32=True)
    tile_end = torch.searchsorted(sorted_tile, tile_ids, side="right", out_int32=True)
    return TileBinning(
        pair_gaussian=g_key[perm],
        pair_tile=sorted_tile,
        tile_start=tile_start,
        tile_count=tile_end - tile_start,
        num_pairs=ex.num_pairs,
        overflow=ex.overflow,
        gen_of_tile_pos=perm.to(i32),
        gen_owner=gen_owner,
        orig_to_dense=orig_to_dense,
        gen_live=tile < num_tiles,
    )


def default_pair_budget(n: int, avg_tiles_per_gaussian: int = 12) -> int:
    """Heuristic static budget, rounded to 8k granules."""
    b = n * avg_tiles_per_gaussian
    return max(8192, -(-b // 8192) * 8192)


def band_pair_budget(capacity: int, nband: int) -> int:
    """Per-band static budget of a tile-band render: 2x headroom over the
    even 1/nband split of the full image's budget (clustered splats would
    overflow an even split), ceiled to 8k granules."""
    per_band = -(-default_pair_budget(capacity) * 2 // nband)
    return max(8192, -(-per_band // 8192) * 8192)
