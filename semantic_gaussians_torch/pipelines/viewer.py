"""Viewer core: render modes + text-driven scene editing (headless).

Port of semantic_gaussians_tpu.pipelines.viewer. Render modes RGB / Depth /
Semantic / Relevancy, and the edits applied to text-selected Gaussians:
  Remove -> opacity logit := -9999
  Color  -> DC color inverted (1 - rgb, clamped)
  Size   -> log-scales and positions doubled
  Move   -> xyz += 1
Selection: per-Gaussian argmax over ['other'] + edit prompts + preserve
prompts; selected iff 0 < label <= len(edit prompts).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.gaussians import GaussianParams
from ..data.scannet_constants import COLORMAP
from ..renderer import render, render_chn
from ..utils.camera import Camera
from ..utils.sh import rgb_to_sh, sh_to_rgb


def _normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-8) -> torch.Tensor:
    return x / (torch.linalg.norm(x, dim=dim, keepdim=True) + eps)


def _text(text_encoder, labels, like: torch.Tensor) -> torch.Tensor:
    feats = np.asarray(text_encoder.extract_text_feature(list(labels)), np.float32)
    return torch.from_numpy(feats).to(like.device)


def select_by_text(
    gauss_feats: torch.Tensor,  # [cap, D]
    text_encoder,
    edit_prompts: Sequence[str],
    preserve_prompts: Sequence[str] = (),
) -> torch.Tensor:
    """[cap] bool — Gaussians whose best prompt is one of edit_prompts."""
    labelset = ["other"] + list(edit_prompts) + list(preserve_prompts)
    text = _text(text_encoder, labelset, gauss_feats)
    label = torch.argmax(_normalize(gauss_feats) @ text.T, dim=-1)
    return (label > 0) & (label <= len(edit_prompts))


def apply_edit(params: GaussianParams, edit_mask: torch.Tensor, mode: str) -> GaussianParams:
    """Edit the selected Gaussians; returns new params (inputs untouched)."""
    m = edit_mask
    if mode == "Remove":
        return dataclasses.replace(
            params,
            opacity_logits=torch.where(
                m[:, None], torch.full_like(params.opacity_logits, -9999.0),
                params.opacity_logits,
            ),
        )
    if mode == "Color":
        inv = rgb_to_sh(torch.clamp(1.0 - sh_to_rgb(params.sh_dc), 0.0, 1.0))
        return dataclasses.replace(
            params, sh_dc=torch.where(m[:, None, None], inv, params.sh_dc)
        )
    if mode == "Size":
        return dataclasses.replace(
            params,
            log_scales=torch.where(m[:, None], params.log_scales * 2.0, params.log_scales),
            means=torch.where(m[:, None], params.means * 2.0, params.means),
        )
    if mode == "Move":
        return dataclasses.replace(
            params, means=torch.where(m[:, None], params.means + 1.0, params.means)
        )
    raise ValueError(f"unknown edit mode {mode!r}")


def render_view(
    camera: Camera,
    params: GaussianParams,
    alive: torch.Tensor,
    mode: str = "RGB",
    gauss_feats: Optional[torch.Tensor] = None,
    text_encoder=None,
    prompts: Optional[Sequence[str]] = None,
    backend: str = "tiled",
) -> np.ndarray:
    """[H, W, 3] uint8 image for one of the four view modes."""
    if mode == "RGB":
        out = render(camera, params, alive=alive, backend=backend)
        img = torch.clamp(out["render"], 0, 1).cpu().numpy()
    elif mode == "Depth":
        out = render(camera, params, alive=alive, backend=backend)
        d = out["depth"].cpu().numpy()
        lo, hi = np.percentile(d, 2), np.percentile(d, 98)
        img = np.repeat(((np.clip(d, lo, hi) - lo) / max(hi - lo, 1e-6))[..., None], 3, -1)
    elif mode == "Semantic":
        if gauss_feats is None or not prompts:
            raise ValueError("Semantic mode needs features and prompts")
        labelset = ["other"] + list(prompts)
        text = _text(text_encoder, labelset, gauss_feats)
        label = torch.argmax(_normalize(gauss_feats) @ text.T, dim=-1)
        onehot = torch.nn.functional.one_hot(label, len(labelset)).to(torch.float32)
        out = render_chn(
            camera, params, onehot * alive[:, None], alive=alive, backend=backend
        )
        cls = torch.argmax(out["render"], dim=-1).cpu().numpy()
        img = (COLORMAP[: len(labelset)] / 255.0)[cls]
    elif mode == "Relevancy":
        if gauss_feats is None or not prompts:
            raise ValueError("Relevancy mode needs features and prompts")
        text = _text(text_encoder, prompts, gauss_feats)
        rel = (_normalize(gauss_feats) @ text.T).max(dim=-1, keepdim=True).values
        rel = torch.clamp((rel + 1) / 2, 0, 1)
        out = render_chn(camera, params, rel * alive[:, None], alive=alive, backend=backend)
        r = out["render"][..., 0].cpu().numpy()
        img = np.stack([r, 0.2 + 0.6 * r, 1.0 - r], axis=-1)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)
