"""Checkpoints of the 2D towers with seeded random weights, written in the
public layouts the providers load (`make_predictor`'s `sam_checkpoint`,
`clip_checkpoint`, `lseg_checkpoint`, `bpe_path`), at any width: the
published ones on the card (chip_smoke.py), small ones in the CPU tests.
No checkpoint or BPE vocabulary is shipped with the repository.

  * SAM: the `sam_vit_*.pth` state dict, plus random mask-prompt convs
    (`prompt_encoder.mask_downscaling.*`) as a public file carries them;
    its mask decoder is scaled so that its masks pass the AMG's filters.
  * CLIP: an OpenAI state dict: the text tower's keys, the image tower's
    under `visual.`, and `logit_scale`.
  * LSeg: a Lightning checkpoint {"state_dict": `net.*`} with a CLIP text
    tower under `net.clip_pretrained.*`.
  * BPE: a gzip merges file that builds the given words from their
    characters (a header line, then one merge a line).
"""
from __future__ import annotations

import gzip
from pathlib import Path
from typing import Iterable

import torch

from ..models.clip_text import CLIPTextTower
from ..models.clip_vision import CLIPVisionTower
from ..models.common import random_init_
from ..models.lseg import LSegConfig, LSegNet
from ..models.sam import Sam, SamConfig, init_scales


def _random(build, seed: int, **kw):
    """build() on the CPU without its default init, then seeded weights."""
    with torch.device("meta"):
        module = build()
    return random_init_(module.to_empty(device="cpu"), seed=seed, **kw).eval()


# A SAM with N(0, 0.02) weights predicts IoUs near 0 and mask logits of
# about +-0.3, so the automatic mask generator's default filters (predicted
# IoU > 0.7, stability >= 0.85 at offset 1) keep no mask and the stages
# after them get no work. sam_model keeps the scale of the mask path
# instead: the hypernetwork MLPs and the last upscaling conv at std
# 1 / sqrt(fan-in), the hypernetworks' output layers HYPER_GAIN times that,
# which gives logits of tens at any width (stable masks that follow the
# image); IOU_BIAS on the IoU head's last bias gives predicted IoUs near 0.9.
HYPER_GAIN = 50.0
IOU_BIAS = 0.9


def sam_model(cfg: SamConfig, seed: int = 0) -> Sam:
    """A random SAM whose masks pass the AMG's default filters."""
    d = cfg.decoder_dim
    scales = dict(init_scales(), **{"output_upscaling.3.weight": (d // 4) ** -0.5})
    for i in range(1 + cfg.num_multimask):
        mlp = f"output_hypernetworks_mlps.{i}.layers"
        scales.update({f"{mlp}.0.weight": d ** -0.5, f"{mlp}.1.weight": d ** -0.5,
                       f"{mlp}.2.weight": HYPER_GAIN * d ** -0.5})
    model = _random(lambda: Sam(cfg), seed, scales=scales)
    with torch.no_grad():
        model.mask_decoder.iou_prediction_head.layers[2].bias.add_(IOU_BIAS)
        for mlp in model.mask_decoder.output_hypernetworks_mlps:
            for t in (mlp.layers[2].weight, mlp.layers[2].bias):
                t.sub_(t.mean(dim=0))  # zero-sum over channels: masks near half the image
    return model


def write_sam(path, cfg: SamConfig, seed: int = 0) -> Sam:
    model = sam_model(cfg, seed)
    sd = dict(model.state_dict())
    g = torch.Generator().manual_seed(seed + 1)
    for name, shape in (("0.weight", (4, 1, 2, 2)), ("0.bias", (4,))):  # its first conv
        sd[f"prompt_encoder.mask_downscaling.{name}"] = torch.randn(shape, generator=g)
    _save(sd, path)
    return model


def clip_towers(text_kw: dict, vision_kw: dict, seed: int = 0):
    text = _random(lambda: CLIPTextTower(**text_kw), seed)
    vision = _random(lambda: CLIPVisionTower(**vision_kw), seed + 1)
    return text, vision


def write_clip(path, text_kw: dict, vision_kw: dict, seed: int = 0):
    text, vision = clip_towers(text_kw, vision_kw, seed)
    sd = dict(text.state_dict())
    sd.update({"visual." + k: v for k, v in vision.state_dict().items()})
    sd["logit_scale"] = torch.tensor(4.6052)
    _save(sd, path)
    return text, vision


def write_lseg(path, cfg: LSegConfig, text_kw: dict, seed: int = 0):
    net = _random(lambda: LSegNet(cfg), seed)
    text = _random(lambda: CLIPTextTower(**text_kw), seed + 1)
    sd = {"net." + k: v for k, v in net.state_dict().items()}
    sd.update({"net.clip_pretrained." + k: v for k, v in text.state_dict().items()})
    sd["net.clip_pretrained.logit_scale"] = torch.tensor(4.6052)
    _save({"state_dict": sd, "epoch": 0}, path)
    return net, text


def merges_for(words: Iterable[str]) -> list:
    """Merges that build each word from its characters left to right,
    first use first, without repeats."""
    merges = []
    for w in words:
        parts = list(w[:-1]) + [w[-1] + "</w>"]
        while len(parts) > 1:
            m = (parts[0], parts[1])
            if m not in merges:
                merges.append(m)
            parts = [parts[0] + parts[1]] + parts[2:]
    return merges


def write_bpe(path, words: Iterable[str]) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: random\n" + "\n".join(" ".join(m) for m in merges_for(words)) + "\n")
    return path


def _save(obj, path):
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    torch.save(obj, path)
