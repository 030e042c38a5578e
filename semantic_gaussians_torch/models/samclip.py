"""SAMCLIP predictor: SAM automatic masks x CLIP crop embeddings.

Port of semantic_gaussians_tpu.models.samclip: masks of the automatic mask
generator's merged set, sorted by descending area; each mask's bbox crop of
the image, zeroed outside the mask, padded to a centred square, resized to
the CLIP input (336) and encoded; every crop's unnormalized embedding added
into the mask's pixels; finally an L2 norm per pixel. embedding_dim 768.

The per-pixel sum runs on the device as one matrix product, masks^T @
embeddings, over the masks in the same (descending-area) order: the sum
over masks is accumulated in the product's order, not in the JAX
package's one masked add per mask (a few ulp apart; the tests hold the two
at 1e-4). Output [H, W, D] float32 numpy, channel-last.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..utils.device import resolve_device
from .automask import AutoMaskConfig, SamAutoMask
from .clip_vision import CLIPImageEncoder
from .common import resize_bilinear
from .predictors import load_image
from .sam import Sam


def pad_square_crop(image: np.ndarray, seg: np.ndarray, bbox, out_size: int, device=None):
    """The masked bbox crop of `image` (H, W, 3) float [0, 1], padded to a
    centred square and resized to (out_size, out_size, 3) as
    `jax.image.resize` linear does; a float32 tensor on `device`."""
    x1, y1 = int(bbox[0]), int(bbox[1])
    x2, y2 = int(bbox[0] + bbox[2]), int(bbox[1] + bbox[3])
    crop = image[y1:y2, x1:x2] * seg[y1:y2, x1:x2, None]
    h, w = crop.shape[:2]
    if h == 0 or w == 0:
        return torch.zeros((out_size, out_size, 3), device=device)
    side = max(h, w)
    pad = np.zeros((side, side, 3), np.float32)
    if h > w:
        off = (h - w) // 2
        pad[:, off: off + w] = crop
    else:
        off = (w - h) // 2
        pad[off: off + h, :] = crop
    t = torch.from_numpy(pad).to(device).permute(2, 0, 1)[None]
    return resize_bilinear(t, (out_size, out_size))[0].permute(1, 2, 0)


def sum_crop_features(masks: torch.Tensor, embs: torch.Tensor) -> torch.Tensor:
    """(M, H, W) bool masks, (M, D) embeddings -> (H, W, D): each pixel's
    sum of the embeddings of the masks that cover it, L2-normalized
    (+1e-8)."""
    m, h, w = masks.shape
    feats = (masks.reshape(m, h * w).T.to(embs.dtype) @ embs).reshape(h, w, -1)
    return feats / (feats.norm(dim=-1, keepdim=True) + 1e-8)


class SAMCLIPPredictor:
    """Predictor2D provider backed by the port's SAM and CLIP image towers
    (`predictors.make_predictor` loads them from checkpoints); runs on CUDA
    unless `device` asks for the CPU."""

    embedding_dim = 768

    def __init__(self, sam_model: Sam, clip_encoder: CLIPImageEncoder, *, text_encoder=None,
                 amg: AutoMaskConfig = AutoMaskConfig(), clip_batch: int = 64, device=None):
        self.device = resolve_device(device)
        self.mask_generator = SamAutoMask(sam_model.to(self.device), amg)
        self.clip = clip_encoder
        self.embedding_dim = self.clip.embedding_dim
        self.text_encoder = text_encoder
        self.clip_batch = clip_batch
        self.classes: Optional[str] = None

    # -- protocol surface ---------------------------------------------------

    def set_predefined_cls(self, cls: Sequence[str]):
        self.classes = ".".join(cls)

    def set_predefined_part(self, cls: str, parts: Sequence[str]):
        self.classes = ".".join(f"{cls}:{e}" for e in parts)

    def get_text(self, vocabulary: str, prefix_prompt: str = "a "):
        return [prefix_prompt + x.lower().replace(":", " ").replace("_", " ")
                for x in vocabulary.split(".")]

    def prepare_image(self, img_path, img_size=None) -> np.ndarray:
        """The RGB image in [0, 1], resized to img_size (W, H) as
        `jax.image.resize` linear does."""
        img = load_image(img_path)
        if img_size is not None:
            w, h = int(img_size[0]), int(img_size[1])
            t = torch.from_numpy(img.astype(np.float32)).to(self.device).permute(2, 0, 1)[None]
            img = resize_bilinear(t, (h, w))[0].permute(1, 2, 0).cpu().numpy()
        return np.clip(img.astype(np.float32) / 255.0, 0.0, 1.0)

    @torch.inference_mode()
    def crop_embeddings(self, img01: np.ndarray, anns) -> torch.Tensor:
        """(M, D) unnormalized CLIP embeddings of the annotations' crops,
        encoded in batches of clip_batch."""
        size = self.clip.tower.image_size
        crops = torch.stack([pad_square_crop(img01, a["segmentation"], a["bbox"], size,
                                             self.device) for a in anns])
        return torch.cat([self.clip.encode(crops[i: i + self.clip_batch])
                          for i in range(0, len(crops), self.clip_batch)])

    @torch.inference_mode()
    def features(self, img01: np.ndarray, anns) -> torch.Tensor:
        """[H, W, D] per-pixel features on the device from the (area-sorted)
        annotations."""
        h, w = img01.shape[:2]
        if not anns:
            return torch.zeros((h, w, self.embedding_dim), device=self.device)
        masks = torch.from_numpy(np.stack([a["segmentation"] for a in anns])).to(self.device)
        return sum_crop_features(masks, self.crop_embeddings(img01, anns))

    def extract_image_feature(self, img_path, img_size=None) -> np.ndarray:
        """[H, W, D] per-pixel CLIP-space map of a path or RGB array, resized
        to img_size (W, H) first."""
        img01 = self.prepare_image(img_path, img_size)
        anns = self.mask_generator.generate((img01 * 255).astype(np.uint8))[0]
        anns = sorted(anns, key=lambda a: a["area"], reverse=True)
        return self.features(img01, anns).cpu().numpy()

    def extract_text_feature(self, labelset) -> np.ndarray:
        if self.text_encoder is None:
            raise ValueError("no text tower; pass text_encoder")
        return np.asarray(self.text_encoder.extract_text_feature(labelset))
