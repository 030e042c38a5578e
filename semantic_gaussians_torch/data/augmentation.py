"""Point-cloud augmentations for distillation, in numpy and scipy.

The port's own copy of semantic_gaussians_tpu.data.augmentation (the
reference's dataset/augmentation.py): ElasticDistortion and
RandomHorizontalFlip are the two the distill dataset applies; the four
colour transforms and Compose complete the module. Every transform draws
from `np.random.default_rng(seed)`, so that a seed gives the JAX package's
draws.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import scipy.ndimage
import scipy.interpolate


class ElasticDistortion:
    """Gaussian-noise displacement grid, blurred, trilinearly interpolated
    (augmentation.py:155-199). distortion_params: [(granularity, magnitude)]."""

    def __init__(self, distortion_params=((0.2, 0.4), (0.8, 1.6))):
        self.distortion_params = distortion_params

    @staticmethod
    def elastic_distortion(coords, granularity, magnitude, rng):
        blurx = np.ones((3, 1, 1, 1)).astype("float32") / 3
        blury = np.ones((1, 3, 1, 1)).astype("float32") / 3
        blurz = np.ones((1, 1, 3, 1)).astype("float32") / 3
        coords_min = coords.min(0)

        noise_dim = ((coords - coords_min).max(0) // granularity).astype(int) + 3
        noise = rng.standard_normal(size=(*noise_dim, 3)).astype(np.float32)
        for _ in range(2):
            noise = scipy.ndimage.convolve(noise, blurx, mode="constant", cval=0)
            noise = scipy.ndimage.convolve(noise, blury, mode="constant", cval=0)
            noise = scipy.ndimage.convolve(noise, blurz, mode="constant", cval=0)
        ax = [
            np.linspace(d_min, d_max, d)
            for d_min, d_max, d in zip(
                coords_min - granularity,
                coords_min + granularity * (noise_dim - 2),
                noise_dim,
            )
        ]
        interp = scipy.interpolate.RegularGridInterpolator(
            ax, noise, bounds_error=False, fill_value=0
        )
        return coords + interp(coords) * magnitude

    def __call__(self, coords, feats=None, labels=None, seed: Optional[int] = None):
        rng = np.random.default_rng(seed)
        if self.distortion_params is not None and rng.random() < 0.95:
            for granularity, magnitude in self.distortion_params:
                coords = self.elastic_distortion(
                    coords, granularity, magnitude, rng
                )
        return coords, feats, labels


class RandomHorizontalFlip:
    """Flip along upright-perpendicular axes with p=0.95*0.5
    (augmentation.py:135-152)."""

    def __init__(self, upright_axis: str = "z", is_temporal: bool = False):
        self.upright_axis = {"x": 0, "y": 1, "z": 2}[upright_axis.lower()]
        self.horz_axes = set(range(3)) - {self.upright_axis}

    def __call__(self, coords, feats=None, labels=None, seed: Optional[int] = None):
        rng = np.random.default_rng(seed)
        if rng.random() < 0.95:
            for axis in self.horz_axes:
                if rng.random() < 0.5:
                    coord_max = np.max(coords[:, axis])
                    coords = coords.copy()
                    coords[:, axis] = coord_max - coords[:, axis]
        return coords, feats, labels


class ChromaticTranslation:
    """Add a random color shift (augmentation.py:18-34); feats in [0,255]."""

    def __init__(self, trans_range_ratio: float = 0.1):
        self.trans_range_ratio = trans_range_ratio

    def __call__(self, coords, feats=None, labels=None, seed=None):
        rng = np.random.default_rng(seed)
        if feats is not None and rng.random() < 0.95:
            tr = (rng.random((1, 3)) - 0.5) * 255 * 2 * self.trans_range_ratio
            feats = feats.copy()
            feats[:, :3] = np.clip(tr + feats[:, :3], 0, 255)
        return coords, feats, labels


class ChromaticAutoContrast:
    """Blend toward contrast-stretched colors (augmentation.py:37-58)."""

    def __init__(self, randomize_blend_factor=True, blend_factor=0.5):
        self.randomize_blend_factor = randomize_blend_factor
        self.blend_factor = blend_factor

    def __call__(self, coords, feats=None, labels=None, seed=None):
        rng = np.random.default_rng(seed)
        if feats is not None and rng.random() < 0.2:
            lo = feats[:, :3].min(0, keepdims=True)
            hi = feats[:, :3].max(0, keepdims=True)
            scale = 255 / np.maximum(hi - lo, 1e-6)
            contrast = (feats[:, :3] - lo) * scale
            blend = (
                rng.random() if self.randomize_blend_factor else self.blend_factor
            )
            feats = feats.copy()
            feats[:, :3] = (1 - blend) * feats[:, :3] + blend * contrast
        return coords, feats, labels


class ChromaticJitter:
    """Gaussian color noise (augmentation.py:61-72)."""

    def __init__(self, std: float = 0.01):
        self.std = std

    def __call__(self, coords, feats=None, labels=None, seed=None):
        rng = np.random.default_rng(seed)
        if feats is not None and rng.random() < 0.95:
            noise = rng.standard_normal((feats.shape[0], 3)) * 255 * self.std
            feats = feats.copy()
            feats[:, :3] = np.clip(noise + feats[:, :3], 0, 255)
        return coords, feats, labels


class HueSaturationTranslation:
    """Random hue/saturation shift in HSV space (augmentation.py:75-129)."""

    def __init__(self, hue_max: float = 0.5, saturation_max: float = 0.2):
        self.hue_max = hue_max
        self.saturation_max = saturation_max

    @staticmethod
    def rgb_to_hsv(rgb):
        rgb = rgb.astype("float")
        hsv = np.zeros_like(rgb)
        maxc = rgb.max(-1)
        minc = rgb.min(-1)
        hsv[..., 2] = maxc
        mask = maxc != minc
        cr = maxc - minc
        s = np.zeros_like(maxc)
        s[mask] = cr[mask] / maxc[mask]
        hsv[..., 1] = s
        rc = np.zeros_like(maxc)
        gc = np.zeros_like(maxc)
        bc = np.zeros_like(maxc)
        rc[mask] = (maxc - rgb[..., 0])[mask] / cr[mask]
        gc[mask] = (maxc - rgb[..., 1])[mask] / cr[mask]
        bc[mask] = (maxc - rgb[..., 2])[mask] / cr[mask]
        h = np.select(
            [rgb[..., 0] == maxc, rgb[..., 1] == maxc],
            [bc - gc, 2.0 + rc - bc],
            default=4.0 + gc - rc,
        )
        hsv[..., 0] = (h / 6.0) % 1.0
        return hsv

    @staticmethod
    def hsv_to_rgb(hsv):
        h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
        i = (h * 6.0).astype("uint8")
        f = (h * 6.0) - i
        p = v * (1.0 - s)
        q = v * (1.0 - s * f)
        t = v * (1.0 - s * (1.0 - f))
        i = i % 6
        rgb = np.zeros(hsv.shape)
        conds = [i == k for k in range(6)]
        rgb[..., 0] = np.select(conds, [v, q, p, p, t, v])
        rgb[..., 1] = np.select(conds, [t, v, v, q, p, p])
        rgb[..., 2] = np.select(conds, [p, p, t, v, v, q])
        return rgb

    def __call__(self, coords, feats=None, labels=None, seed=None):
        rng = np.random.default_rng(seed)
        if feats is not None:
            hsv = self.rgb_to_hsv(feats[:, :3])
            hue = (rng.random() - 0.5) * 2 * self.hue_max
            sat = 1 + (rng.random() - 0.5) * 2 * self.saturation_max
            hsv[..., 0] = np.remainder(hue + hsv[..., 0] + 1, 1)
            hsv[..., 1] = np.clip(sat * hsv[..., 1], 0, 1)
            feats = feats.copy()
            feats[:, :3] = np.clip(self.hsv_to_rgb(hsv), 0, 255)
        return coords, feats, labels


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = transforms

    def __call__(self, coords, feats=None, labels=None, seed=None):
        for i, t in enumerate(self.transforms):
            coords, feats, labels = t(
                coords, feats, labels,
                seed=None if seed is None else seed + i,
            )
        return coords, feats, labels
