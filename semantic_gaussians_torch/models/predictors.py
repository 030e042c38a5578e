"""Text encoder for the viewer: deterministic random features.

Port of semantic_gaussians_tpu.models.predictors.RandomFeatureProvider's text
side (the encoder the view server uses when no 2D model is loaded). Text
features are [K, C], L2-normalized, and identical to the JAX package's for
the same labels.
"""
from __future__ import annotations

import hashlib
from typing import Sequence

import numpy as np


class RandomFeatureProvider:
    """Deterministic random features keyed by label."""

    def __init__(self, embedding_dim: int = 16):
        self.embedding_dim = embedding_dim

    def _rng(self, key: str):
        seed = int.from_bytes(hashlib.sha256(key.encode()).digest()[:4], "little")
        return np.random.default_rng(seed)

    def extract_text_feature(self, labelset: Sequence[str]) -> np.ndarray:
        feats = np.stack(
            [self._rng("text:" + l).normal(size=self.embedding_dim) for l in labelset]
        ).astype(np.float32)
        return feats / np.linalg.norm(feats, axis=-1, keepdims=True)
