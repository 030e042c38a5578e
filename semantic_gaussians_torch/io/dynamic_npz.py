"""Dynamic-3DGS scene loading (CMU-Panoptic params.npz).

Port of semantic_gaussians_tpu.io.dynamic_npz: params.npz holds per-timestep
means3D [T, N, 3], rgb_colors [T, N, 3], unnorm_rotations [T, N, 4] plus
static logit_opacities [N, 1], log_scales [N, 1 or 3] and a foreground mask
seg_colors (is_fg = seg[:, 0] > 0.5). The scene stays in numpy on the host;
`params_at(t)` pads one timestep to the shared capacity and puts it on a
device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..core.gaussians import GaussianParams, params_from_numpy, round_capacity
from ..utils.sh import rgb_to_sh


@dataclasses.dataclass
class DynamicScene:
    means: np.ndarray  # [T, N, 3]
    colors: np.ndarray  # [T, N, 3]
    rotations: np.ndarray  # [T, N, 4]
    opacity_logits: np.ndarray  # [N, 1]
    log_scales: np.ndarray  # [N, 3]
    is_fg: np.ndarray  # [N] bool
    capacity: int

    @classmethod
    def from_numpy(cls, arrays: Dict[str, np.ndarray], capacity: int) -> "DynamicScene":
        """A scene from the JAX package's DynamicScene fields given as numpy
        arrays (means, colors, rotations, opacity_logits, log_scales, is_fg)."""
        f32 = {k: np.array(arrays[k], np.float32) for k in
               ("means", "colors", "rotations", "opacity_logits", "log_scales")}
        return cls(**f32, is_fg=np.array(arrays["is_fg"], bool), capacity=int(capacity))

    @property
    def num_timesteps(self) -> int:
        return self.means.shape[0]

    def params_at(
        self, t: int, sh_degree: int = 0, device: Union[str, torch.device] = "cpu"
    ) -> Tuple[GaussianParams, torch.Tensor]:
        """(GaussianParams, alive) for timestep t on `device` (SH degree 0
        by default: colours only, like the reference's dynamic path)."""
        n = self.means.shape[1]
        cap = self.capacity
        k = (sh_degree + 1) ** 2

        def pad(x, fill=0.0):
            out = np.full((cap,) + x.shape[1:], fill, np.float32)
            out[:n] = x
            return out

        params = params_from_numpy(dict(
            means=pad(self.means[t]),
            sh_dc=pad(rgb_to_sh(self.colors[t])[:, None, :]),
            sh_rest=np.zeros((cap, k - 1, 3), np.float32),
            log_scales=pad(self.log_scales),
            quats=pad(self.rotations[t]),
            opacity_logits=pad(self.opacity_logits, fill=-20.0),
        ), device)
        alive = torch.from_numpy(np.arange(cap) < n).to(device)
        return params, alive

    def foreground_mask(self, device: Union[str, torch.device] = "cpu") -> torch.Tensor:
        out = np.zeros(self.capacity, bool)
        out[: len(self.is_fg)] = self.is_fg
        return torch.from_numpy(out).to(device)


def load_dynamic_npz(path, capacity: Optional[int] = None) -> DynamicScene:
    data = np.load(path)
    means = np.asarray(data["means3D"], np.float32)
    opacity = np.asarray(data["logit_opacities"], np.float32)
    if opacity.ndim == 1:
        opacity = opacity[:, None]
    log_scales = np.asarray(data["log_scales"], np.float32)
    if log_scales.shape[-1] == 1:
        log_scales = np.repeat(log_scales, 3, axis=-1)
    seg = np.asarray(data["seg_colors"], np.float32)
    return DynamicScene(
        means=means,
        colors=np.asarray(data["rgb_colors"], np.float32),
        rotations=np.asarray(data["unnorm_rotations"], np.float32),
        opacity_logits=opacity,
        log_scales=log_scales,
        is_fg=seg[:, 0] > 0.5,
        capacity=capacity or round_capacity(means.shape[1]),
    )
