"""CLIP image encoder (ViT): the image tower SAMCLIP encodes its mask crops
with and VLPart's native detector classifies proposals with.

Port of semantic_gaussians_tpu.models.clip_vision: OpenAI CLIP's visual
transformer (patch conv without bias, class token, learned positional
embedding, ln_pre, pre-LN blocks with QuickGELU MLPs, ln_post on the class
token, projection into the joint space). `state_dict()` keys are OpenAI's
under `visual.` (`conv1.weight`, `transformer.resblocks.N.attn.in_proj_weight`,
`proj`, ...); `CLIPVisionTower.from_state_dict` takes a full CLIP state
dict or the `visual.*` part and reads the widths from it.

The LayerNorms use epsilon 1e-6 as the JAX tower's do (flax's default,
clip_vision.py:59, 61, 98, 101); OpenAI CLIP uses 1e-5.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from ..utils.device import resolve_device
from .clip_text import Transformer, count_blocks
from .common import float32_state, load_torch_state_dict

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
LN_EPS = 1e-6  # the JAX tower's (flax default), not OpenAI's 1e-5


class CLIPVisionTower(nn.Module):
    """ViT-L/14@336 defaults. [B, S, S, 3] normalized -> [B, embed_dim]
    unnormalized."""

    def __init__(self, image_size: int = 336, patch: int = 14, width: int = 1024,
                 layers: int = 24, heads: int = 16, embed_dim: int = 768):
        super().__init__()
        self.image_size, self.embed_dim = image_size, embed_dim
        g = image_size // patch
        self.conv1 = nn.Conv2d(3, width, patch, stride=patch, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(torch.empty(g * g + 1, width))
        self.ln_pre = nn.LayerNorm(width, eps=LN_EPS)
        self.transformer = Transformer(width, layers, heads, causal=False, eps=LN_EPS)
        self.ln_post = nn.LayerNorm(width, eps=LN_EPS)
        self.proj = nn.Parameter(torch.empty(width, embed_dim))

    @classmethod
    def from_state_dict(cls, sd) -> "CLIPVisionTower":
        """The tower a CLIP state dict's `visual.*` keys (or a bare visual
        state dict) describe, with those weights in float32; heads =
        width // 64."""
        sd = float32_state(sd)
        if any(k.startswith("visual.") for k in sd):
            sd = {k[7:]: v for k, v in sd.items() if k.startswith("visual.")}
        width, _, patch, _ = sd["conv1.weight"].shape
        grid = round((sd["positional_embedding"].shape[0] - 1) ** 0.5)
        with torch.device("meta"):  # no init of weights about to be replaced
            tower = cls(image_size=grid * patch, patch=patch, width=width,
                        layers=count_blocks(sd, "transformer.resblocks."), heads=width // 64,
                        embed_dim=sd["proj"].shape[1])
        tower.load_state_dict(sd, assign=True)
        return tower

    def forward(self, x):  # [B, S, S, 3]
        b = x.shape[0]
        x = self.conv1(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)  # [B, g*g, W]
        cls = self.class_embedding.expand(b, 1, -1)
        x = self.ln_pre(torch.cat([cls, x], dim=1) + self.positional_embedding)
        x = self.ln_post(self.transformer(x)[:, 0])
        return x @ self.proj


def state_from_flax(variables) -> dict:
    """The JAX image tower's variables -> this tower's state dict (the
    `visual.*` part of an OpenAI checkpoint, without the prefix)."""
    from .common import tensor_tree

    p = tensor_tree(variables["params"] if "params" in variables else variables)
    sd = {
        "conv1.weight": p["patch_embed"]["kernel"].permute(3, 2, 0, 1),
        "class_embedding": p["class_embedding"],
        "positional_embedding": p["positional_embedding"],
        "ln_pre.weight": p["ln_pre"]["scale"], "ln_pre.bias": p["ln_pre"]["bias"],
        "ln_post.weight": p["ln_post"]["scale"], "ln_post.bias": p["ln_post"]["bias"],
        "proj": p["proj"],
    }
    for i in range(sum(k.startswith("block") and k[5:].isdigit() for k in p)):
        b, o = p[f"block{i}"], f"transformer.resblocks.{i}"
        sd.update({
            f"{o}.ln_1.weight": b["ln_1"]["scale"], f"{o}.ln_1.bias": b["ln_1"]["bias"],
            f"{o}.ln_2.weight": b["ln_2"]["scale"], f"{o}.ln_2.bias": b["ln_2"]["bias"],
            f"{o}.attn.in_proj_weight": b["attn"]["qkv"]["kernel"].T,
            f"{o}.attn.in_proj_bias": b["attn"]["qkv"]["bias"],
            f"{o}.attn.out_proj.weight": b["attn"]["out"]["kernel"].T,
            f"{o}.attn.out_proj.bias": b["attn"]["out"]["bias"],
            f"{o}.mlp.c_fc.weight": b["mlp_fc"]["kernel"].T,
            f"{o}.mlp.c_fc.bias": b["mlp_fc"]["bias"],
            f"{o}.mlp.c_proj.weight": b["mlp_proj"]["kernel"].T,
            f"{o}.mlp.c_proj.bias": b["mlp_proj"]["bias"],
        })
    return {k: v.contiguous() for k, v in sd.items()}


class CLIPImageEncoder:
    """`encode_image` over [B, S, S, 3] float RGB batches in [0, 1]; runs on
    CUDA unless `device` asks for the CPU."""

    def __init__(self, tower: Optional[CLIPVisionTower] = None, *, state_dict=None,
                 checkpoint_path=None, device=None):
        self.device = resolve_device(device)
        if tower is None:
            if state_dict is None:
                if checkpoint_path is None:
                    raise ValueError("need tower, state_dict or checkpoint_path")
                state_dict = load_torch_state_dict(checkpoint_path)
            tower = CLIPVisionTower.from_state_dict(state_dict)
        self.tower = tower.to(self.device).eval()
        self.embedding_dim = self.tower.embed_dim
        self._mean = torch.from_numpy(CLIP_MEAN).to(self.device)
        self._std = torch.from_numpy(CLIP_STD).to(self.device)

    @torch.inference_mode()
    def encode(self, batch: torch.Tensor) -> torch.Tensor:
        """[B, S, S, 3] in [0, 1] on the encoder's device -> [B, D]
        unnormalized embeddings (the crops' features are summed per pixel
        before any normalization)."""
        return self.tower((batch - self._mean) / self._std)

    def encode_image(self, batch) -> np.ndarray:
        x = torch.as_tensor(np.asarray(batch, np.float32), device=self.device)
        return self.encode(x).float().cpu().numpy()
