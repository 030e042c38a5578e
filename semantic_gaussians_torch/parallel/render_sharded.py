"""Tile-band sharded rendering: one view's pixels split across ranks.

Port of semantic_gaussians_tpu.parallel.render_sharded. Each rank renders a
horizontal band of `band_rows` tile rows; the Gaussians are replicated.
Shifting means2d up by the band's pixel offset turns the band into an
independent smaller render (a Gaussian's falloff depends only on pixel
deltas), so the single-device stack runs unchanged on a (band_rows,
grid_w) grid: projection, binning with the pair-expand kernel and the exact
tile-ellipse cull, and the composite kernels through `CompositeFunction`,
whose backward is the composite backward kernel and the pack-gather VJP's
segment sum. The tile-major band buffers are gathered in band order, which
is the padded image's tile order. Bands past the image (grid_h not a
multiple of the rank count) bin no pair and render background.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..core.gaussians import GaussianParams, tree_build, tree_leaves
from ..ops.binning import band_pair_budget, bin_gaussians
from ..ops.composite import CompositeFunction, pack_geometry
from ..ops.projection import project_gaussians
from ..ops.rasterize import DEFAULT_TILE, _untile, pair_grads_to_gaussians
from ..utils.camera import Camera
from .collectives import all_gather, gather_bands, psum, replicated
from .mesh import Mesh


def band_grid(width: int, height: int, nband: int, tile_shape=DEFAULT_TILE):
    """(band_rows, grid_w) of one band of an image split into `nband`."""
    th, tw = tile_shape
    grid_h = -(-height // th)
    return -(-grid_h // nband), -(-width // tw)


def band_render_core(
    camera: Camera,
    params: GaussianParams,
    alive: Optional[torch.Tensor],
    override: Optional[torch.Tensor],
    bg: torch.Tensor,
    m2d_off: Optional[torch.Tensor],
    band: int,
    band_rows: int,
    tile_shape: Tuple[int, int],
    grid_w: int,
    budget: int,
    sh_degree: int,
):
    """Render tile-row band `band` of `camera` (shared by the band-sharded
    renderer and the band / hybrid train steps). Returns the tile-major
    band buffers color [T, C, PX], depth, final_T, n_contrib [T, PX], and
    overflow [], radii [N] (the whole image's: every band projects every
    Gaussian) and num_pairs []."""
    th, tw = tile_shape
    camera = camera.to(params.device)
    proj = project_gaussians(
        params.means, params.scales, params.quats, params.opacity[:, 0],
        camera.world_view, camera.full_proj, camera.camera_center,
        camera.width, camera.height, camera.tan_half_fov_x, camera.tan_half_fov_y,
        sh_coeffs=None if override is not None else params.sh_coeffs,
        sh_degree=sh_degree, override_color=override, alive=alive, mean2d_offset=m2d_off,
    )
    shift = torch.tensor([[0.0, float(band * band_rows * th)]], device=params.device)
    proj = dataclasses.replace(proj, means2d=proj.means2d - shift)
    binning = bin_gaussians(
        proj.means2d, proj.depths, proj.radii_xy, tile_shape, (band_rows, grid_w), budget,
        cull_ellipse=proj.cull_ellipse,
    )
    geom = pack_geometry(proj.means2d, proj.conics, proj.opacities, proj.depths)
    colors = proj.colors.to(torch.float32).contiguous()
    bg = bg.to(device=params.device, dtype=torch.float32).contiguous()
    color, depth, final_t, n_contrib = CompositeFunction.apply(
        geom, colors, bg, binning.pair_gaussian, binning.tile_start, binning.tile_count,
        grid_w, th, tw, lambda rows: pair_grads_to_gaussians(rows, binning),
    )
    return color, depth, final_t, n_contrib, binning.overflow, proj.radii, binning.num_pairs


def render_sharded(
    camera: Camera,
    params: GaussianParams,
    alive: Optional[torch.Tensor],
    mesh: Mesh,
    bg: Optional[torch.Tensor] = None,
    *,
    active_sh_degree: Optional[int] = None,
    override_color: Optional[torch.Tensor] = None,  # [N, C] -> feature render
    tile_shape: Tuple[int, int] = DEFAULT_TILE,
    pair_budget: Optional[int] = None,
    axis: str = "data",
    mean2d_offset: Optional[torch.Tensor] = None,  # [N, 2] zeros (densify stats)
) -> dict:
    """Render one camera with its tile rows split across the ranks of
    `axis`; every rank returns the whole image, as ops.rasterize.rasterize
    does: render [H, W, C], depth, final_T, n_contrib, overflow (summed over
    bands), num_pairs (summed), radii.

    Differentiable: the gradients of the parameters, the override colours,
    the background and the offset come out summed over the bands (the
    inputs are replicated), so every rank holds the single-device
    gradient."""
    ndev, band = mesh.size(axis), mesh.coord(axis)
    band_rows, grid_w = band_grid(camera.width, camera.height, ndev, tile_shape)
    budget = pair_budget or band_pair_budget(params.capacity, ndev)
    num_ch = 3 if override_color is None else override_color.shape[-1]
    if bg is None:
        bg = torch.zeros(num_ch, dtype=torch.float32, device=params.device)
    sh_degree = params.max_sh_degree if active_sh_degree is None else active_sh_degree
    leaves = tree_leaves(params)
    *values, override_color, bg, mean2d_offset = replicated(
        list(leaves.values()) + [override_color, bg, mean2d_offset], mesh, axis)
    params = tree_build(GaussianParams, dict(zip(leaves, values)))
    color, depth, final_t, n_contrib, overflow, radii, num_pairs = band_render_core(
        camera, params, alive, override_color, bg, mean2d_offset, band, band_rows,
        tile_shape, grid_w, budget, sh_degree,
    )
    color = gather_bands(color, mesh, axis)
    planes = all_gather(torch.stack([depth, final_t], dim=1), mesh, axis)
    depth, final_t = planes[:, 0], planes[:, 1]
    n_contrib = all_gather(n_contrib, mesh, axis)
    counts = psum(torch.stack([overflow, num_pairs]), mesh, axis)
    grid = (ndev * band_rows, grid_w)
    h, w = camera.height, camera.width
    return dict(
        render=_untile(color, grid, tile_shape, h, w),
        depth=_untile(depth, grid, tile_shape, h, w),
        final_T=_untile(final_t, grid, tile_shape, h, w),
        n_contrib=_untile(n_contrib, grid, tile_shape, h, w),
        overflow=counts[0],
        num_pairs=counts[1],
        radii=radii,
    )
