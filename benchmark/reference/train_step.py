"""Plain-PyTorch reference of the 3DGS training step.

The loss of 3DGS (0.8 L1 + 0.2 (1 - SSIM), SSIM with an 11-tap Gaussian
window of sigma 1.5 and zero padding, C1 = 0.01^2, C2 = 0.03^2), its
gradient through the reference rasterizer (`render.py`), and per-group Adam
(torch.optim.Adam's update, eps 1e-15) at the official learning rates, the
position's on its exponential schedule times the scene's extent.
`follow` runs the first steps from the benchmark's own inputs and reports
what the check compares.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from . import render as R

FIELDS = ("means", "sh_dc", "sh_rest", "log_scales", "quats", "opacity_logits")


def _window(dtype, device, size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    x = np.arange(size, dtype=np.float64) - size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return torch.tensor(g / g.sum(), dtype=dtype, device=device)


def _blur(x: torch.Tensor) -> torch.Tensor:
    """Separable blur of [B, H, W, C] over H and W, zero padded: sums of
    shifted slices in the tensor's own precision (a convolution would go
    through cuDNN in TF32)."""
    w = _window(x.dtype, x.device).tolist()
    h, wd = x.shape[1], x.shape[2]
    xp = F.pad(x, (0, 0, 0, 0, 5, 5))
    y = sum(w[k] * xp[:, k:k + h] for k in range(11))
    yp = F.pad(y, (0, 0, 5, 5))
    return sum(w[k] * yp[:, :, k:k + wd] for k in range(11))


def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    s = _blur(torch.stack([a, b, a * a, b * b, a * b]))
    mu1, mu2 = s[0], s[1]
    v1, v2, cov = s[2] - mu1 * mu1, s[3] - mu2 * mu2, s[4] - mu1 * mu2
    m = ((2 * mu1 * mu2 + c1) * (2 * cov + c2)) / ((mu1 * mu1 + mu2 * mu2 + c1) * (v1 + v2 + c2))
    return m.mean()


def photometric_loss(pred, gt, lambda_dssim: float = 0.2) -> torch.Tensor:
    return (1 - lambda_dssim) * (pred - gt).abs().mean() + lambda_dssim * (1 - ssim(pred, gt))


def learning_rates(hyper: Dict, extent: float, step: int) -> Dict[str, float]:
    """The official per-group rates at `step` (the position's decays
    exponentially from init to final over position_lr_max_steps)."""
    t = min(max(step / hyper["position_lr_max_steps"], 0.0), 1.0)
    lo, hi = math.log(hyper["position_lr_init"] * extent), math.log(hyper["position_lr_final"] * extent)
    return dict(means=math.exp(lo * (1 - t) + hi * t), sh_dc=hyper["feature_lr"],
                sh_rest=hyper["feature_lr"] / 20.0, log_scales=hyper["scaling_lr"],
                quats=hyper["rotation_lr"], opacity_logits=hyper["opacity_lr"])


def norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}


def follow(params0: Dict[str, torch.Tensor], cams: List[Dict], images: List[torch.Tensor],
           hyper: Dict, extent: float, first_step: int, sh_degree: int,
           dtype=torch.float32) -> Dict:
    """len(cams) steps of training from `params0` with fresh Adam moments,
    the k-th on cams[k] against images[k]; the step counter (which sets the
    position's rate) starts at `first_step`. Returns each step's loss, the
    first step's gradient norm by leaf, and after all the steps the norm by
    leaf of Adam's first moment and of the change of the parameters."""
    p = {k: params0[k].detach().to(dtype) for k in FIELDS}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    bg = torch.zeros(3, dtype=dtype, device=p["means"].device)
    b1, b2, eps = 0.9, 0.999, 1e-15
    losses, g1 = [], None
    for k, (cam, gt) in enumerate(zip(cams, images)):
        leaves = {f: p[f].clone().requires_grad_(True) for f in FIELDS}
        img = R.render(leaves, cam, sh_degree, bg)["image"]
        loss = photometric_loss(img, gt.to(dtype), hyper["lambda_dssim"])
        grads = dict(zip(FIELDS, torch.autograd.grad(loss, [leaves[f] for f in FIELDS])))
        losses.append(float(loss.detach()))
        if g1 is None:
            g1 = norms(grads)
        lrs = learning_rates(hyper, extent, first_step + k)
        t = k + 1
        with torch.no_grad():
            for f in FIELDS:
                g = grads[f]
                m[f] = b1 * m[f] + (1 - b1) * g
                v2[f] = b2 * v2[f] + (1 - b2) * g * g
                mh = m[f] / (1 - b1 ** t)
                vh = v2[f] / (1 - b2 ** t)
                p[f] = p[f] - lrs[f] * mh / (torch.sqrt(vh) + eps)
    change = norms({f: p[f].double() - params0[f].double() for f in FIELDS})
    return dict(losses=losses, grad_norms=g1, moment_norms=norms(m), change_norms=change)
