"""Per-group Adam over GaussianParams.

Port of semantic_gaussians_tpu.core.optimizer: the reference's named-group
torch.optim.Adam (xyz at position_lr * spatial scale on an exponential
schedule, f_dc at feature_lr, f_rest at feature_lr / 20, fixed opacity /
scaling / rotation rates, eps = 1e-15) as an explicit optimizer whose
moments are GaussianParams-shaped, so densification can zero the moments
of the slots it touches with a masked update. A feature field (Feature
3DGS) is one more group, at `semantic_feature_lr`. The update is
torch.optim.Adam's:
  m_hat = m / (1 - b1^t);  v_hat = v / (1 - b2^t)
  p -= lr * m_hat / (sqrt(v_hat) + eps)
Functional, as the JAX package: each call returns new tensors.
"""
from __future__ import annotations

import dataclasses

import torch

from ..utils.schedules import expon_lr_schedule
from .gaussians import GaussianParams, leaf_names, tree_map


@dataclasses.dataclass(frozen=True)
class AdamState:
    count: torch.Tensor  # [] int32
    mu: GaussianParams
    nu: GaussianParams


@dataclasses.dataclass(frozen=True)
class TrainHyper:
    """Learning-rate hyperparameters (official_train.yaml)."""

    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 10000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    semantic_feature_lr: float = 0.001  # the feature field's (Feature 3DGS's own rate)
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-15


def lr_tree(hyper: TrainHyper, spatial_lr_scale: float, step,
            features: bool = False) -> GaussianParams:
    """Per-leaf learning rates at `step` (float32 scalars on the step's
    device; `step` may be a device tensor, so nothing syncs), with the
    feature field's where `features`."""
    xyz_sched = expon_lr_schedule(
        hyper.position_lr_init * spatial_lr_scale,
        hyper.position_lr_final * spatial_lr_scale,
        lr_delay_mult=hyper.position_lr_delay_mult,
        max_steps=hyper.position_lr_max_steps,
    )
    xyz = xyz_sched(step)

    def const(v):  # a fill on the device: no copy from the host (capturable)
        return torch.full((), v, dtype=torch.float32, device=xyz.device)

    return GaussianParams(
        means=xyz,
        sh_dc=const(hyper.feature_lr),
        sh_rest=const(hyper.feature_lr / 20.0),
        log_scales=const(hyper.scaling_lr),
        quats=const(hyper.rotation_lr),
        opacity_logits=const(hyper.opacity_lr),
        features=const(hyper.semantic_feature_lr) if features else None,
    )


def adam_init(params: GaussianParams) -> AdamState:
    zeros = tree_map(torch.zeros_like, params)
    return AdamState(
        count=torch.zeros((), dtype=torch.int32, device=params.device), mu=zeros, nu=zeros
    )


@torch.no_grad()
def adam_update(
    grads: GaussianParams,
    state: AdamState,
    params: GaussianParams,
    lrs: GaussianParams,
    hyper: TrainHyper,
):
    """One Adam step: (new params, new AdamState)."""
    count = state.count + 1
    t = count.to(torch.float32)
    b1, b2 = hyper.beta1, hyper.beta2
    bc1 = 1.0 - torch.pow(torch.full((), b1, dtype=torch.float32, device=t.device), t)
    bc2 = 1.0 - torch.pow(torch.full((), b2, dtype=torch.float32, device=t.device), t)
    new_p, new_m, new_v = {}, {}, {}
    for f in leaf_names(params):
        p, g = getattr(params, f), getattr(grads, f)
        m = b1 * getattr(state.mu, f) + (1 - b1) * g
        v = b2 * getattr(state.nu, f) + (1 - b2) * g * g
        m_hat = m / bc1
        v_hat = v / bc2
        new_p[f] = p - getattr(lrs, f) * m_hat / (torch.sqrt(v_hat) + hyper.eps)
        new_m[f], new_v[f] = m, v
    return GaussianParams(**new_p), AdamState(
        count=count, mu=GaussianParams(**new_m), nu=GaussianParams(**new_v)
    )


def zero_moments_at(state: AdamState, slot_mask: torch.Tensor) -> AdamState:
    """Zero the moments of the masked slots (cloned, split, pruned)."""
    keep = (~slot_mask).to(torch.float32)

    def z(x):
        return x * keep.reshape((-1,) + (1,) * (x.dim() - 1))

    return AdamState(count=state.count, mu=tree_map(z, state.mu), nu=tree_map(z, state.nu))


def zero_moments_leaf(state: AdamState, leaf: str) -> AdamState:
    """Zero one leaf's moments entirely (opacity reset)."""
    mu = dataclasses.replace(state.mu, **{leaf: torch.zeros_like(getattr(state.mu, leaf))})
    nu = dataclasses.replace(state.nu, **{leaf: torch.zeros_like(getattr(state.nu, leaf))})
    return AdamState(count=state.count, mu=mu, nu=nu)
