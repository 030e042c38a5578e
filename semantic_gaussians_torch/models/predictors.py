"""2D open-vocabulary predictor protocol and the providers that need no
model weights.

Port of semantic_gaussians_tpu.models.predictors. Fusion and evaluation
consume per-pixel feature maps [H, W, C] and L2-normalized text features
[K, C] through one duck-typed protocol (`embedding_dim`,
`extract_image_feature`, `extract_text_feature`):

  * PrecomputedFeatureProvider: per-view feature maps exported by an
    offline 2D model (.npy / .npz / .pt), the production path for OpenSeg.
  * RandomFeatureProvider: deterministic random features keyed by path or
    label, identical to the JAX package's for the same keys.
  * The model towers (lseg, samclip, vlpart, the CLIP text encoder) belong
    to the 2D-models slice of the port; asking for one raises.
"""
from __future__ import annotations

import hashlib
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np
import torch

_TOWERS = ("lseg", "samclip", "vlpart")


def _resize_chw_nearest(feat_hwc: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Nearest-neighbour resize of an [H, W, C] map to (W, H)."""
    w, h = size
    src_h, src_w = feat_hwc.shape[:2]
    ys = (np.arange(h) * src_h // h).clip(0, src_h - 1)
    xs = (np.arange(w) * src_w // w).clip(0, src_w - 1)
    return feat_hwc[ys][:, xs]


class PrecomputedFeatureProvider:
    """Per-view feature maps exported by an offline 2D model.

    Files are looked up as <dir>/<image_stem>.{npy,npz,pt}; content is
    [H, W, C] or [C, H, W]. A map whose first axis equals `embedding_dim` is
    taken as CHW (the reference's export layout wins the ambiguous case).
    Maps come back as `dtype` (float32, as the JAX package returns them;
    float16 hands a half-precision export over as it is stored, with the
    same values and without two conversions of ~1 GB a view).
    """

    def __init__(self, feature_dir, embedding_dim: int = 768, dtype="float32"):
        self.feature_dir = Path(feature_dir)
        self.embedding_dim = embedding_dim
        self.dtype = np.dtype(dtype)

    def extract_image_feature(self, img_path, img_size):
        stem = Path(img_path).stem
        for ext in (".npy", ".npz", ".pt"):
            p = self.feature_dir / (stem + ext)
            if p.exists():
                break
        else:
            raise FileNotFoundError(f"no feature map for {stem} in {self.feature_dir}")
        if p.suffix == ".npy":
            feat = np.load(p)
        elif p.suffix == ".npz":
            data = np.load(p)
            feat = data[list(data.keys())[0]]
        else:
            obj = torch.load(p, map_location="cpu", weights_only=True)
            feat = obj["feat"] if isinstance(obj, dict) else obj
            feat = feat.numpy() if feat.dtype == torch.float16 else feat.float().numpy()
        if feat.ndim != 3:
            raise ValueError(f"bad feature map shape {feat.shape}")
        if feat.shape[0] == self.embedding_dim:
            feat = np.moveaxis(feat, 0, -1)  # CHW -> HWC
        if img_size is not None and (feat.shape[1], feat.shape[0]) != tuple(img_size):
            feat = _resize_chw_nearest(feat, img_size)
        return feat.astype(self.dtype, copy=False)

    def extract_text_feature(self, labelset):
        raise NotImplementedError(
            "precomputed provider has no text tower; pair with a CLIP text encoder"
        )


class RandomFeatureProvider:
    """Deterministic random features keyed by file path or label."""

    def __init__(self, embedding_dim: int = 16, feat_hw: Tuple[int, int] = (60, 80)):
        self.embedding_dim = embedding_dim
        self.feat_hw = feat_hw

    def _rng(self, key: str):
        seed = int.from_bytes(hashlib.sha256(key.encode()).digest()[:4], "little")
        return np.random.default_rng(seed)

    def extract_image_feature(self, img_path, img_size):
        h, w = self.feat_hw
        feat = self._rng(str(img_path)).normal(size=(h, w, self.embedding_dim))
        feat = feat.astype(np.float32)
        if img_size is not None:
            feat = _resize_chw_nearest(feat, img_size)
        return feat

    def extract_text_feature(self, labelset: Sequence[str]) -> np.ndarray:
        feats = np.stack(
            [self._rng("text:" + l).normal(size=self.embedding_dim) for l in labelset]
        ).astype(np.float32)
        return feats / np.linalg.norm(feats, axis=-1, keepdims=True)


class TorchCLIPTextEncoder:
    """The CLIP text tower: part of the 2D-models slice, not ported yet."""

    def __init__(self, model_path: str, embedding_dim: int = 768):
        raise NotImplementedError(
            "TorchCLIPTextEncoder is not ported yet: it lands with the 2D-models slice"
        )


def make_predictor(name: str, cfg):
    """Build a 2D provider by name from the `fusion` (or `eval`) config
    section: precomputed / openseg (offline exports) and random. The model
    towers raise until the 2D-models slice ports them."""
    get = cfg.get if hasattr(cfg, "get") else lambda k, d=None: d
    if name in ("precomputed", "openseg"):
        return PrecomputedFeatureProvider(
            cfg["feature_dir"], int(get("embedding_dim", 768)), get("feat_dtype") or "float32"
        )
    if name == "random":
        return RandomFeatureProvider(int(get("embedding_dim", 768)))
    if name in _TOWERS:
        raise NotImplementedError(
            f"model_2d={name!r} is not ported yet: it lands with the 2D-models slice"
        )
    raise ValueError(f"unknown model_2d: {name}")
