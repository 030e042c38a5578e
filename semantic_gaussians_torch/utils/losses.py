"""Losses: L1, L2, SSIM, PSNR, the 3DGS photometric loss and the distill
cosine loss.

Port of semantic_gaussians_tpu.utils.losses (11x11 Gaussian window, sigma
1.5, per-channel SAME zero-padded blur, C1 = 0.01^2, C2 = 0.03^2). Images
are [H, W, C].

The SSIM blur must be full float32. Its variance terms are blur(x^2) -
mu^2, a cancellation that reduced precision turns into garbage, and on a
TPU that garbage reached the densify statistics through the SSIM backward
and cloned nearly every Gaussian. PyTorch routes a float32 convolution
through cuDNN in TF32 by default (torch.backends.cudnn.allow_tf32), in the
backward as well, whatever flags a caller set around the forward. So the
blur is written without cuDNN: a separable sum of shifted slices, plain
float32 multiplies and adds in both directions of autograd.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def l2_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-image PSNR (reference loss_utils.py semantics)."""
    mse = torch.mean((pred - target) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse + 1e-12))


@functools.lru_cache(maxsize=None)
def _gaussian_window(window_size: int, sigma: float) -> tuple:
    xs = np.arange(window_size, dtype=np.float32) - window_size // 2
    g = np.exp(-(xs**2) / (2 * sigma**2))
    return tuple(float(v) for v in g / g.sum())


def _blur(x: torch.Tensor, window_size: int, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur over the H and W axes of [..., H, W, C],
    SAME zero padding."""
    g = _gaussian_window(window_size, sigma)
    r = window_size // 2
    h, w = x.shape[-3], x.shape[-2]
    xp = F.pad(x, (0, 0, 0, 0, r, r))  # pad H
    y = g[0] * xp[..., 0:h, :, :]
    for k in range(1, window_size):
        y = y + g[k] * xp[..., k:k + h, :, :]
    yp = F.pad(y, (0, 0, r, r))  # pad W
    z = g[0] * yp[..., :, 0:w, :]
    for k in range(1, window_size):
        z = z + g[k] * yp[..., :, k:k + w, :]
    return z


def ssim(
    img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11, sigma: float = 1.5
) -> torch.Tensor:
    """Mean SSIM over [H, W, C] images in [0, 1]."""
    c1 = 0.01**2
    c2 = 0.03**2
    # The five blurred maps in one batched pass.
    stats = _blur(
        torch.stack([img1, img2, img1 * img1, img2 * img2, img1 * img2]), window_size, sigma
    )
    mu1, mu2 = stats[0], stats[1]
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = stats[2] - mu1_sq
    sigma2_sq = stats[3] - mu2_sq
    sigma12 = stats[4] - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    return torch.mean(ssim_map)


def photometric_loss(
    pred: torch.Tensor, target: torch.Tensor, lambda_dssim: float = 0.2
) -> torch.Tensor:
    """(1 - l) L1 + l (1 - SSIM): the 3DGS training loss."""
    return (1.0 - lambda_dssim) * l1_loss(pred, target) + lambda_dssim * (
        1.0 - ssim(pred, target)
    )


def cosine_distill_loss(pred: torch.Tensor, target: torch.Tensor, mask=None) -> torch.Tensor:
    """1 - cosine similarity, averaged over valid rows (by default rows with
    a non-zero target). The norms are sqrt(sum + 1e-12): a plain norm has a
    NaN gradient at exactly 0, and masked-out (dead-voxel) rows are exactly
    0; 0 * NaN would still poison the backward."""
    pn = pred / torch.sqrt(torch.sum(pred * pred, dim=-1, keepdim=True) + 1e-12)
    tn = target / torch.sqrt(torch.sum(target * target, dim=-1, keepdim=True) + 1e-12)
    per_row = 1.0 - torch.sum(pn * tn, dim=-1)
    if mask is None:
        mask = torch.linalg.norm(target, dim=-1) > 0
    mask = mask.to(per_row.dtype)
    return torch.sum(per_row * mask) / torch.clamp(torch.sum(mask), min=1.0)
