"""Per-group Adam over GaussianParams.

Port of semantic_gaussians_tpu.core.optimizer: the reference's named-group
torch.optim.Adam (xyz at position_lr * spatial scale on an exponential
schedule, f_dc at feature_lr, f_rest at feature_lr / 20, fixed opacity /
scaling / rotation rates, eps = 1e-15) as an explicit optimizer whose
moments are GaussianParams-shaped, so densification can zero the moments
of the slots it touches with a masked update. A feature field (Feature
3DGS, or Gaussian Grouping's identity field) is one more group, at
`semantic_feature_lr`. Leaves outside GaussianParams (Gaussian Grouping's
classifier) step in the same call through `adam_update_with`, as rows
that carry their own rate and eps. The update is torch.optim.Adam's:
  m_hat = m / (1 - b1^t);  v_hat = v / (1 - b2^t)
  p -= lr * m_hat / (sqrt(v_hat) + eps)
Functional, as the JAX package: each call returns new tensors.

`adam_update_with` picks its path from the device: on a CUDA device one
kernel launch updates all leaves, each at its own rate and eps
(csrc/adam.cu, counter `ADAM`), on the CPU the plain loop runs. The
kernel takes float32 leaves of one shape and float32 learning-rate
scalars on that device, and raises on anything else; it
reads each gradient where its rows are contiguous (autograd hands the SH
leaves and the feature field their gradients as slices of one joined
gradient) and makes a contiguous copy of anything else, such as the column
views that gathering a sharded state leaves. Both paths do the same
float32 operations in the same order, so they agree bit for bit.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Sequence

import torch

from ..ops import kernels
from ..utils.schedules import expon_lr_schedule
from .gaussians import GaussianParams, leaf_names, tree_map

ADAM = kernels.LaunchCounter("adam")  # one a launch of csrc/adam.cu
_P = ctypes.c_void_p
_F = ctypes.c_float
_SIGNATURES = {
    "sgt_adam": (_P, _P, _P, ctypes.c_int, _P, _P, _F, _F, _F, _F, _P),
}


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


def adam_update(
    grads: GaussianParams,
    state: AdamState,
    params: GaussianParams,
    lrs: GaussianParams,
    hyper: TrainHyper,
):
    """One Adam step: (new params, new AdamState)."""
    new_params, new_state, _ = adam_update_with(grads, state, params, lrs, hyper, ())
    return new_params, new_state


@torch.no_grad()
def adam_update_with(
    grads: GaussianParams,
    state: AdamState,
    params: GaussianParams,
    lrs: GaussianParams,
    hyper: TrainHyper,
    extra: Sequence[tuple],
):
    """adam_update, and in the same launch the leaves of `extra`, each a row
    (p, g, m, v, lr, eps) at its own rate (a float32 scalar) and eps, which
    step at the state's count: (new params, new AdamState, [(p', m', v')]
    a row of `extra`)."""
    count = state.count + 1
    bc1, bc2 = bias_corrections(count, hyper)
    names = leaf_names(params)
    rows = [tuple(getattr(tree, f) for tree in (params, grads, state.mu, state.nu, lrs))
            + (hyper.eps,) for f in names] + list(extra)
    if bc1.device.type == "cuda":
        out = _adam_kernel(rows, bc1, bc2, hyper)
    else:
        out = [_adam_plain(*row[:5], bc1, bc2, hyper, eps=row[5]) for row in rows]
    new_p, new_m, new_v = ({f: o[k] for f, o in zip(names, out)} for k in range(3))
    return (GaussianParams(**new_p),
            AdamState(count=count, mu=GaussianParams(**new_m), nu=GaussianParams(**new_v)),
            out[len(names):])


def bias_corrections(count: torch.Tensor, hyper: TrainHyper):
    """1 - b1^t and 1 - b2^t at step t = `count` (float32 scalars on its
    device)."""
    t = count.to(torch.float32)
    return tuple(1.0 - torch.pow(torch.full((), b, dtype=torch.float32, device=t.device), t)
                 for b in (hyper.beta1, hyper.beta2))


def _adam_plain(p, g, mu, nu, lr, bc1, bc2, hyper: TrainHyper, eps=None):
    """One leaf's Adam step in torch ops at `eps` (hyper.eps where None):
    (p', m', v')."""
    b1, b2 = hyper.beta1, hyper.beta2
    m = b1 * mu + (1 - b1) * g
    v = b2 * nu + (1 - b2) * g * g
    m_hat = m / bc1
    v_hat = v / bc2
    return p - lr * m_hat / (torch.sqrt(v_hat) + (hyper.eps if eps is None else eps)), m, v


def _row_stride(x: torch.Tensor):
    """x's stride along its first dimension where each of its rows (what
    follows the first index) is contiguous, else None."""
    want = 1
    for size, stride in zip(reversed(x.shape[1:]), reversed(x.stride()[1:])):
        if size != 1 and stride != want:
            return None
        want *= size
    return x.stride(0) if x.shape[0] > 1 else want


def _kernel_rows(rows, dev: torch.device):
    """The leaves (p, g, m, v, lr, ...) as the kernel reads them: [(p, g,
    m, v, lr, g's row stride)], p, m and v contiguous and each g with
    contiguous rows (as it is where it has them, else a contiguous copy).
    Raises unless every p, g, m, v is a float32 tensor of p's shape ([N,
    ...]) on `dev` and every learning rate a float32 scalar there."""
    out = []
    for p, g, mu, nu, lr, *_ in rows:
        if not (isinstance(lr, torch.Tensor) and lr.numel() == 1
                and lr.dtype == torch.float32 and lr.device == dev):
            raise ValueError(f"adam_update on {dev} wants float32 learning-rate scalars there")
        for x in (p, g, mu, nu):
            if not (x.dtype == torch.float32 and x.device == dev and x.shape == p.shape
                    and x.dim() > 0):
                raise ValueError(f"adam_update on {dev} wants float32 leaves of one shape "
                                 f"[N, ...] there, got {x.dtype} {tuple(x.shape)} on "
                                 f"{x.device} beside {tuple(p.shape)}")
        stride = _row_stride(g)
        if stride is None:
            g = g.contiguous()
            stride = _row_stride(g)
        out.append((p.contiguous(), g, mu.contiguous(), nu.contiguous(), lr, stride))
    return out


def _adam_kernel(rows, bc1, bc2, hyper: TrainHyper):
    """All leaves' Adam step in one launch of csrc/adam.cu, each row (p, g,
    m, v, lr, eps): [(p', m', v')] a leaf, fresh contiguous tensors."""
    dev = bc1.device
    out, ptrs, sizes = [], [], []
    for p, g, mu, nu, lr, stride in _kernel_rows(rows, dev):
        new = tuple(torch.empty_like(p) for _ in range(3))
        out.append(new)
        ptrs += [x.data_ptr() for x in (p, g, mu, nu, *new, lr)]
        n = p.numel()
        sizes += [n, n // p.shape[0] if n else 1, stride]
    eps = [row[5] for row in rows]
    b1, b2 = hyper.beta1, hyper.beta2
    lib = kernels.load("adam", _SIGNATURES)
    with kernels.on_device(dev):
        err = lib.sgt_adam(
            (_P * len(ptrs))(*ptrs), (ctypes.c_longlong * len(sizes))(*sizes),
            (_F * len(eps))(*eps), len(rows), bc1.data_ptr(), bc2.data_ptr(),
            b1, 1 - b1, b2, 1 - b2, kernels.current_stream(dev),
        )
    kernels.check(lib, err, "sgt_adam")
    if any(sizes[::3]):  # else nothing was launched
        ADAM.add()
    return out


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
