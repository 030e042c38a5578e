"""Gaussian scene state.

Port of semantic_gaussians_tpu.core.gaussians: capacity-padded parameter
arrays with an `alive` mask kept beside them, and the same activations:
  scales  = exp(log_scales)
  opacity = sigmoid(opacity_logits)
  quat    = normalize(quats)   (w, x, y, z)
The state is a frozen dataclass of tensors; edits build a new one with
`dataclasses.replace`, as the JAX package does. `init_from_pcd` makes the
initial state from a point cloud (the JAX package's, with the port's own
torch KNN in place of its native or blocked-JAX one). `packed_features`
is the distill net's per-Gaussian input.

A state may carry one more leaf, `features` [N, D]: the learned feature
field of Feature 3DGS (Zhou et al., CVPR 2024), composited with the
colour's own alpha weights and trained against a 2D teacher's maps. It is
outside FIELDS (the 3DGS leaves); `leaf_names` lists the leaves a state
has, and RGB-only states (features None) take exactly the 3DGS path.
`tree_leaves` and `tree_build`, the one description of a train state's
layout, flatten a frozen dataclass of tensors (this one, AdamState,
DensifyState, a TrainState) to its tensors by dotted path and back.
"""
from __future__ import annotations

import dataclasses
import functools
import typing
from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ..ops.knn import knn_mean_sq_dist
from ..utils.sh import rgb_to_sh, sh_to_rgb

FIELDS = ("means", "sh_dc", "sh_rest", "log_scales", "quats", "opacity_logits")
FEATURES = "features"  # the Feature 3DGS leaf, where a state has one


@dataclasses.dataclass(frozen=True)
class GaussianParams:
    """Parameters; every tensor has leading dim = capacity."""

    means: torch.Tensor  # [N, 3]
    sh_dc: torch.Tensor  # [N, 1, 3]
    sh_rest: torch.Tensor  # [N, K-1, 3]
    log_scales: torch.Tensor  # [N, 3]
    quats: torch.Tensor  # [N, 4] raw (normalized on use)
    opacity_logits: torch.Tensor  # [N, 1]
    features: Optional[torch.Tensor] = None  # [N, D] learned feature field, or None

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    @property
    def device(self) -> torch.device:
        return self.means.device

    @property
    def max_sh_degree(self) -> int:
        k = 1 + self.sh_rest.shape[1]
        return int(round(k**0.5)) - 1

    @property
    def scales(self) -> torch.Tensor:
        return torch.exp(self.log_scales)

    @property
    def opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.opacity_logits)

    @property
    def rotations(self) -> torch.Tensor:
        n = torch.linalg.norm(self.quats, dim=-1, keepdim=True)
        return self.quats / torch.clamp(n, min=1e-12)

    @property
    def sh_coeffs(self) -> torch.Tensor:
        """[N, K, 3] full SH stack (dc first)."""
        return torch.cat([self.sh_dc, self.sh_rest], dim=1)

    @property
    def feature_dim(self) -> int:
        return 0 if self.features is None else self.features.shape[1]

    def to_numpy(self) -> Dict[str, np.ndarray]:
        return {f: x.detach().cpu().numpy() for f, x in tree_leaves(self).items()}


def leaf_names(params: GaussianParams) -> Tuple[str, ...]:
    """The leaves `params` carries: FIELDS, then FEATURES where it has a
    feature field."""
    return FIELDS if params.features is None else FIELDS + (FEATURES,)


@functools.lru_cache(maxsize=None)
def _layout(cls) -> Tuple[Tuple[str, Optional[type]], ...]:
    """(name, its type where that is a dataclass too) of each field of `cls`."""
    types = typing.get_type_hints(cls)
    return tuple((f.name, types[f.name] if dataclasses.is_dataclass(types[f.name]) else None)
                 for f in dataclasses.fields(cls))


def tree_leaves(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The tensors (not copies) of a frozen dataclass of tensors by dotted
    path ("params.means", "adam.mu.features", "step"), nested dataclasses
    flattened in field order; a None field is absent."""
    out = {}
    for name, kind in _layout(type(tree)):
        x = getattr(tree, name)
        if kind is not None:
            out.update(tree_leaves(x, f"{prefix}{name}."))
        elif x is not None:
            out[prefix + name] = x
    return out


def tree_build(cls, leaves: Mapping[str, torch.Tensor], prefix: str = ""):
    """The inverse of tree_leaves (the tensors as given); a field with no
    leaf takes its default."""
    kw = {}
    for name, kind in _layout(cls):
        if kind is not None:
            kw[name] = tree_build(kind, leaves, f"{prefix}{name}.")
        elif prefix + name in leaves:
            kw[name] = leaves[prefix + name]
    return cls(**kw)


def tree_map(fn: Callable, *trees):
    """fn leaf by leaf over trees of one layout, as the first one's type."""
    flat = [tree_leaves(t) for t in trees]
    return tree_build(type(trees[0]), {k: fn(*(t[k] for t in flat)) for k in flat[0]})


def with_feature_field(params: GaussianParams, dim: int,
                       features: Optional[torch.Tensor] = None) -> GaussianParams:
    """`params` with a feature field of width `dim`: `features` [N, dim]
    as given, else zeros (Feature 3DGS starts its field at zero)."""
    if features is None:
        features = torch.zeros((params.capacity, dim), dtype=torch.float32,
                               device=params.device)
    if tuple(features.shape) != (params.capacity, dim):
        raise ValueError(f"features {tuple(features.shape)}, expected ({params.capacity}, {dim})")
    return dataclasses.replace(params, features=features)


def round_capacity(n: int, granule: int = 4096) -> int:
    """Static capacities come from a small set of sizes."""
    return max(granule, -(-n // granule) * granule)


def params_from_numpy(
    arrays: Dict[str, np.ndarray], device: Union[str, torch.device]
) -> GaussianParams:
    """Carry GaussianParams leaves given as numpy arrays (e.g. the JAX
    package's, via np.asarray) into the port's state, as float32 on
    `device`. Values are copied bit for bit (never shared with the caller);
    a "features" array, where given, becomes the feature field."""
    missing = [f for f in FIELDS if f not in arrays]
    if missing:
        raise KeyError(f"missing GaussianParams fields: {missing}")
    return GaussianParams(
        **{
            f: torch.from_numpy(np.array(arrays[f], dtype=np.float32)).to(device)
            for f in FIELDS + ((FEATURES,) if FEATURES in arrays else ())
        }
    )


def init_from_pcd(
    points: np.ndarray,
    colors: np.ndarray,
    sh_degree: int = 3,
    capacity: Optional[int] = None,
    init_opacity: float = 0.1,
    device: Union[str, torch.device] = "cpu",
) -> Tuple[GaussianParams, torch.Tensor]:
    """Gaussians from a point cloud: (params, alive mask), as the JAX
    package's init_from_pcd. SH DC from RGB, higher bands zero, isotropic
    log-scale = 0.5 log(max(mean 3-NN squared distance, 1e-7)), identity
    quaternion, opacity logit = logit(init_opacity). Slots past the cloud
    are dead (zeros, opacity logit -20)."""
    n = points.shape[0]
    cap = capacity or round_capacity(n)
    k = (sh_degree + 1) ** 2
    f32 = torch.float32
    pts = torch.as_tensor(np.asarray(points, np.float32)).to(device)
    dist2 = torch.clamp(knn_mean_sq_dist(pts), min=1e-7)
    log_scale = 0.5 * torch.log(dist2)

    def pad(x, fill=0.0):
        out = torch.full((cap,) + tuple(x.shape[1:]), fill, dtype=f32, device=device)
        out[:n] = x
        return out

    cols = torch.as_tensor(np.asarray(colors, np.float32)).to(device)
    quats = torch.zeros((cap, 4), dtype=f32, device=device)
    quats[:, 0] = 1.0
    p0 = torch.tensor(init_opacity, dtype=f32)
    logit = float(torch.log(p0 / (1 - p0)))
    opacity_logits = torch.full((cap, 1), -20.0, dtype=f32, device=device)
    opacity_logits[:n] = logit
    params = GaussianParams(
        means=pad(pts),
        sh_dc=pad(rgb_to_sh(cols)[:, None, :]),
        sh_rest=torch.zeros((cap, k - 1, 3), dtype=f32, device=device),
        log_scales=pad(log_scale[:, None].expand(n, 3)),
        quats=quats,
        opacity_logits=opacity_logits,
    )
    return params, torch.arange(cap, device=device) < n


def random_init(
    generator: torch.Generator, num_points: int = 100_000, sh_degree: int = 3,
    device: Union[str, torch.device] = "cpu",
) -> Tuple[GaussianParams, torch.Tensor]:
    """A random cloud in the Blender-scene bounds (gaussian_model.py:152-160),
    drawn from `generator` (a CPU torch.Generator)."""
    xyz = torch.rand((num_points, 3), generator=generator) * 2.6 - 1.3
    shs = torch.rand((num_points, 3), generator=generator) / 255.0
    return init_from_pcd(xyz.numpy(), sh_to_rgb(shs).numpy(), sh_degree, device=device)


def packed_features(
    params: GaussianParams, alive: torch.Tensor, feature_type: str = "all"
) -> torch.Tensor:
    """Per-Gaussian input of the 3D distill net: the RAW (pre-activation)
    parameters, as get_locs_and_features (gaussian_model.py:400-418) packs
    them. "all": [opacity_logit, f_dc(3), f_rest(45), log_scale(3),
    quat(4)] = 56 channels; "color": [f_dc(3), f_rest(45)] = 48 (SH degree
    3). Dead rows are zero."""
    f_dc = params.sh_dc.reshape(params.capacity, -1)
    f_rest = params.sh_rest.reshape(params.capacity, -1)
    if feature_type == "color":
        feats = torch.cat([f_dc, f_rest], dim=-1)
    else:
        feats = torch.cat(
            [params.opacity_logits, f_dc, f_rest, params.log_scales, params.quats], dim=-1
        )
    return feats * alive[:, None]


def num_alive(alive: torch.Tensor) -> torch.Tensor:
    return torch.sum(alive.to(torch.int32))


def create_semantic(capacity: int, num_channels: int = 768,
                    device: Union[str, torch.device] = "cpu"):
    """Zero per-Gaussian semantic features and visit counters
    (create_semantic, gaussian_model.py:188-194)."""
    return (torch.zeros((capacity, num_channels), dtype=torch.float32, device=device),
            torch.zeros((capacity,), dtype=torch.float32, device=device))
