"""What the bench tools share: the random-cloud scene of the root tools.

Port of the root tools/common.py. `random_cloud_params` draws its numpy
arrays in the root tool's order from the same seed, so the parameters are
the root tool's bit for bit; the root tool's `setup(cpu)` (the JAX backend)
becomes `utils.device.resolve_device`, which the tools call.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.gaussians import GaussianParams, params_from_numpy


def random_cloud_params(n: int, seed: int = 0, spread=(1.2, 0.9, 0.8), center=(0, 0, 4),
                        log_scale_range=(-4.0, -2.5), sh_rest_k: int = 0, device="cpu"):
    """A random cloud of `n` Gaussians in front of an identity camera:
    (GaussianParams on `device`, alive [n] all true, the numpy generator
    after its draws, for the caller's further inputs)."""
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, 3)).astype(np.float32) * np.asarray(spread, np.float32)
           + np.asarray(center, np.float32))
    sh_dc = ((rng.uniform(size=(n, 3)).astype(np.float32) - 0.5) / 0.28209479)[:, None, :]
    log_scales = rng.uniform(*log_scale_range, size=(n, 3)).astype(np.float32)
    opacity_logits = rng.uniform(-1.0, 1.5, size=(n, 1)).astype(np.float32)
    quats = np.zeros((n, 4), np.float32)
    quats[:, 0] = 1.0
    params: GaussianParams = params_from_numpy(dict(
        means=pts, sh_dc=sh_dc, sh_rest=np.zeros((n, sh_rest_k, 3), np.float32),
        log_scales=log_scales, quats=quats, opacity_logits=opacity_logits), device)
    return params, torch.ones(n, dtype=torch.bool, device=device), rng
