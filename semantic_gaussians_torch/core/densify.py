"""Densification (clone / split / prune / opacity reset).

Port of semantic_gaussians_tpu.core.densify. Gaussians live in a
capacity-padded buffer with an `alive` mask; densify writes new entries
into dead slots and zeroes the Adam moments of every touched slot. Slot
assignment is the JAX package's: stable argsorts of integer-cast masks
(valid candidates first, dead slots first), so the same inputs fill the
same slots. Semantics (see the JAX module for the reference lines):
  * clone: grad-norm >= threshold and max-scale <= percent_dense * extent;
  * split: grad-norm >= threshold and max-scale > percent_dense * extent;
    split_n children at mean + R (scale * eps), scales / (0.8 split_n),
    parent removed;
  * prune: opacity < min_opacity, plus (with max_screen_size) the
    0.1 * extent world-size test; the screen-radius test stays inert
    unless `screen_size_prune_active`;
  * statistics reset after each pass;
  * a feature field's rows go with their Gaussian: a clone and both split
    children copy the parent's, a pruned slot keeps its row but is dead.
The split noise eps comes from `noise` (a list of split_n [cap, 3]
arrays, so tests can hand both packages the same draws) or else from
`torch.randn` with the given generator.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch

from ..utils.transforms import quat_to_rotmat
from .gaussians import GaussianParams, tree_map
from .optimizer import AdamState, zero_moments_at, zero_moments_leaf


@dataclasses.dataclass(frozen=True)
class DensifyState:
    xyz_grad_accum: torch.Tensor  # [cap]
    denom: torch.Tensor  # [cap]
    max_radii2d: torch.Tensor  # [cap] float

    @staticmethod
    def zeros(capacity: int, device="cpu") -> "DensifyState":
        z = torch.zeros((capacity,), dtype=torch.float32, device=device)
        return DensifyState(z, z.clone(), z.clone())


@dataclasses.dataclass(frozen=True)
class DensifyConfig:
    grad_threshold: float = 0.0002
    min_opacity: float = 0.005
    percent_dense: float = 0.01
    max_screen_size: Optional[float] = None  # 20.0 after the first opacity reset
    split_n: int = 2
    screen_size_prune_active: bool = False


@torch.no_grad()
def add_stats(
    dstate: DensifyState,
    mean2d_grad: torch.Tensor,  # [cap, 2] pixel-space dL/dmean2D
    radii: torch.Tensor,  # [cap] int32
    img_width: int,
    img_height: int,
) -> DensifyState:
    """Accumulate view-space gradient norms of visible Gaussians, scaled to
    the reference's NDC half extents."""
    visible = radii > 0
    # filled on the device, not copied from the host (a CUDA graph captures this)
    scale = torch.cat([torch.full((1, 1), img_width * 0.5, device=mean2d_grad.device),
                       torch.full((1, 1), img_height * 0.5, device=mean2d_grad.device)], 1)
    norm = torch.linalg.norm(mean2d_grad * scale, dim=-1)
    zero = torch.zeros((), dtype=torch.float32, device=norm.device)
    return DensifyState(
        xyz_grad_accum=dstate.xyz_grad_accum + torch.where(visible, norm, zero),
        denom=dstate.denom + visible.to(torch.float32),
        max_radii2d=torch.maximum(
            dstate.max_radii2d, torch.where(visible, radii.to(torch.float32), zero)
        ),
    )


@torch.no_grad()
def add_stats_prereduced(
    dstate: DensifyState,
    norm_sum: torch.Tensor,  # [cap] sum over views of per-view grad norms
    vis_sum: torch.Tensor,  # [cap] sum over views of visibility counts
    radii_max: torch.Tensor,  # [cap] max radii over views
) -> DensifyState:
    """Accumulate statistics already reduced over a batch of views. The
    reference adds one view's norm and visibility a step; with V views a
    step the equivalent is sum_v ||g_v|| and sum_v visible_v, not the norm
    of the mean gradient (cross-view cancellation would under-trigger
    densification). Multi-device steps sum the per-view norms and counts
    over their ranks and pass the sums here."""
    return DensifyState(
        xyz_grad_accum=dstate.xyz_grad_accum + norm_sum,
        denom=dstate.denom + vis_sum,
        max_radii2d=torch.maximum(dstate.max_radii2d, radii_max.to(torch.float32)),
    )


def _stable_order(mask: torch.Tensor) -> torch.Tensor:
    """Indices with the False entries first, each group in index order."""
    return torch.argsort(mask.to(torch.int32), stable=True)


def _insert(params, alive, adam, cand, cand_valid):
    """Insert the valid candidate rows into dead slots. Returns
    (params, alive, adam, dropped_count)."""
    cap = alive.shape[0]
    src = _stable_order(~cand_valid)  # valid candidates first
    tgt = _stable_order(alive)  # dead slots first
    k = torch.minimum(cand_valid.sum(), (~alive).sum())
    take = torch.arange(cap, device=alive.device) < k

    def put(p, c):
        out = p.clone()
        out[tgt] = torch.where(take.reshape((-1,) + (1,) * (p.dim() - 1)), c[src], p[tgt])
        return out

    new_alive = alive.clone()
    new_alive[tgt] = alive[tgt] | take
    touched = torch.zeros(cap, dtype=torch.bool, device=alive.device)
    touched[tgt] = take
    return (
        tree_map(put, params, cand), new_alive, zero_moments_at(adam, touched),
        cand_valid.sum() - k,
    )


def _kill(params: GaussianParams, mask: torch.Tensor) -> GaussianParams:
    """Dead slots get opacity logit -20 (invisible)."""
    return dataclasses.replace(
        params,
        opacity_logits=torch.where(
            mask[:, None], torch.full_like(params.opacity_logits, -20.0), params.opacity_logits
        ),
    )


@torch.no_grad()
def densify_and_prune(
    params: GaussianParams,
    alive: torch.Tensor,
    adam: AdamState,
    dstate: DensifyState,
    scene_extent: float,
    cfg: DensifyConfig,
    noise: Optional[List[torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
):
    """One densification pass. Returns (params, alive, adam, dstate, dropped)."""
    grads = dstate.xyz_grad_accum / torch.clamp(dstate.denom, min=1.0)
    grads = torch.where(torch.isnan(grads), torch.zeros_like(grads), grads)

    scales = params.scales
    max_scale = torch.max(scales, dim=-1).values
    opacity = params.opacity[:, 0]

    prune = opacity < cfg.min_opacity
    if cfg.max_screen_size is not None:
        if cfg.screen_size_prune_active:
            prune = prune | (dstate.max_radii2d > cfg.max_screen_size)
        prune = prune | (max_scale > 0.1 * scene_extent)
    prune = prune & alive

    high_grad = grads >= cfg.grad_threshold
    small = max_scale <= cfg.percent_dense * scene_extent
    clone_mask = alive & ~prune & high_grad & small
    split_mask = alive & ~prune & high_grad & ~small

    # Candidates come from the parameters before any slot is killed (split
    # parents leave `alive` but still parent their children).
    params0 = params
    alive_new = alive & ~prune & ~split_mask
    params = _kill(params, ~alive_new)
    params, alive_new, adam, dropped = _insert(params, alive_new, adam, params0, clone_mask)

    quats = params0.quats
    rot = quat_to_rotmat(
        quats / torch.clamp(torch.linalg.norm(quats, dim=-1, keepdim=True), min=1e-12)
    )
    n = cfg.split_n
    child_log_scales = torch.log(scales / (0.8 * n))
    for i in range(n):
        if noise is not None:
            eps = torch.as_tensor(noise[i], dtype=torch.float32).to(params0.means.device)
        else:
            eps = torch.randn(params0.means.shape, generator=generator,
                              device=params0.means.device)
        offset = torch.einsum("nij,nj->ni", rot, scales * eps)
        child = dataclasses.replace(
            params0, means=params0.means + offset, log_scales=child_log_scales
        )
        child_valid = split_mask
        if cfg.max_screen_size is not None:
            child_valid = child_valid & ~(
                torch.max(torch.exp(child_log_scales), dim=-1).values > 0.1 * scene_extent
            )
        child_valid = child_valid & ~(opacity < cfg.min_opacity)
        params, alive_new, adam, d = _insert(params, alive_new, adam, child, child_valid)
        dropped = dropped + d

    return (params, alive_new, adam, DensifyState.zeros(alive.shape[0], alive.device),
            dropped)


@torch.no_grad()
def reset_opacity(params: GaussianParams, adam: AdamState):
    """Clamp opacity to <= 0.01 and clear its Adam moments."""
    target = math.log(0.01 / 0.99)
    new_logits = torch.clamp(params.opacity_logits, max=target)
    return (
        dataclasses.replace(params, opacity_logits=new_logits),
        zero_moments_leaf(adam, "opacity_logits"),
    )
