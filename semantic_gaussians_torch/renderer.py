"""Camera-level render API.

Port of semantic_gaussians_tpu.renderer: render() and render_chn() with
scaling_modifier, override_color, override_shape, foreground mask,
world_rotate, bg color, and N-channel feature rendering. Differentiable:
autograd reaches every GaussianParams leaf, the features and
`mean2d_offset` (whose gradient is the densify statistic dL/dmean2D).

`features` renders Feature 3DGS's joint image: the SH colour and the
feature rows are composited together, [N, 3 + D] in one pass over one
binning, with the colour's own alpha weights; the feature channels get no
background. The colour cotangent is split back into the projection's
three channels and the features' D by the concatenation's backward.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from .core.gaussians import GaussianParams
from .ops.projection import project_gaussians
from .ops.rasterize import DEFAULT_TILE, rasterize
from .utils import tracing
from .utils.camera import Camera
from .utils.transforms import build_covariance_3d, strip_symmetric


def render(
    camera: Camera,
    params: GaussianParams,
    alive: Optional[torch.Tensor] = None,
    bg: Optional[torch.Tensor] = None,
    *,
    scaling_modifier: float = 1.0,
    active_sh_degree: Optional[int] = None,
    override_color: Optional[torch.Tensor] = None,  # [N, C] -> feature render
    override_shape: Optional[Tuple[int, int]] = None,  # (width, height)
    foreground: Optional[torch.Tensor] = None,  # [N] bool; False -> opacity 0
    world_rotate: Optional[torch.Tensor] = None,  # [3, 3]
    tile_shape: Tuple[int, int] = DEFAULT_TILE,
    pair_budget: Optional[int] = None,
    backend: str = "tiled",
    tight_cull: bool = True,
    mean2d_offset: Optional[torch.Tensor] = None,  # [N, 2] zeros (densify stats)
    features: Optional[torch.Tensor] = None,  # [N, D] -> RGB and features jointly
) -> dict:
    """Render RGB(+median depth) or N-channel features from one camera, on
    the device that holds `params`; with `features`, RGB and the features
    in one composite.

    Returns dict(render [H,W,C], depth, final_T, n_contrib, radii [N],
    overflow, num_pairs), and with `features` also feature [H,W,D] (render
    then holds the RGB channels).
    """
    dev = params.device
    tracing.phase("project", dev)
    if override_shape is not None:
        camera = camera.resized(override_shape[0], override_shape[1])
    camera = camera.to(dev)
    if bg is None:
        num_ch = 3 if override_color is None else override_color.shape[-1]
        bg = torch.zeros(num_ch, dtype=torch.float32, device=dev)

    opac = params.opacity[:, 0]
    if foreground is not None:
        opac = opac * foreground.to(opac.dtype)

    means = params.means
    cov3d_precomp = None
    if world_rotate is not None:
        world_rotate = world_rotate.to(device=dev, dtype=torch.float32)
        means = means @ world_rotate  # row-vector convention, R^T @ p
        cov = build_covariance_3d(params.scales * scaling_modifier, params.quats)
        cov = world_rotate.T @ cov @ world_rotate
        cov3d_precomp = strip_symmetric(cov)

    sh_degree = params.max_sh_degree if active_sh_degree is None else active_sh_degree
    proj = project_gaussians(
        means,
        params.scales,
        params.quats,
        opac,
        camera.world_view,
        camera.full_proj,
        camera.camera_center,
        camera.width,
        camera.height,
        camera.tan_half_fov_x,
        camera.tan_half_fov_y,
        sh_coeffs=None if override_color is not None else params.sh_coeffs,
        sh_degree=sh_degree,
        override_color=override_color,
        cov3d_precomp=cov3d_precomp,
        scaling_modifier=scaling_modifier,
        alive=alive,
        mean2d_offset=mean2d_offset,
    )
    num_ch = proj.colors.shape[1]
    if features is not None:
        proj = dataclasses.replace(proj, colors=torch.cat([proj.colors, features], 1))
        bg = torch.cat([bg, bg.new_zeros(features.shape[1])])
    out = rasterize(
        proj, bg, camera.width, camera.height, tile_shape=tile_shape,
        pair_budget=pair_budget, backend=backend, tight_cull=tight_cull,
    )
    if features is not None:
        joint = out["render"]
        out["render"], out["feature"] = joint[..., :num_ch], joint[..., num_ch:]
    out["radii"] = proj.radii
    return out


def render_many(
    cameras: Sequence[Camera],
    params: GaussianParams,
    alive: Optional[torch.Tensor] = None,
    bg: Optional[torch.Tensor] = None,
    **kw,
) -> list:
    """Render each camera in turn (the JAX package maps over a stacked
    camera to save dispatches; eager torch needs no such trick)."""
    return [render(cam, params, alive=alive, bg=bg, **kw) for cam in cameras]


def render_chn(
    camera: Camera,
    params: GaussianParams,
    features: torch.Tensor,  # [N, C]
    alive: Optional[torch.Tensor] = None,
    bg: Optional[torch.Tensor] = None,
    **kw,
) -> dict:
    """N-channel feature rasterization."""
    return render(camera, params, alive=alive, bg=bg, override_color=features, **kw)
