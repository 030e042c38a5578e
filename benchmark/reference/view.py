"""Plain reference of the viewer's four modes and of PNG decoding.

A request names a camera (a row-major camera-to-world pose, the image
size and the vertical field of view) and a mode:
  RGB        the SH render, clamped to [0, 1]
  Depth      the median depth, stretched between its 2nd and 98th
             percentiles, grey
  Semantic   each Gaussian's label, the most similar of ["other"] +
             prompts to its unit feature, rendered as one-hot channels;
             each pixel's largest channel in the ScanNet palette
  Relevancy  each Gaussian's best cosine with the prompts, (c + 1) / 2,
             rendered; r -> (r, 0.2 + 0.6 r, 1 - r)
then scaled by 255 and truncated to bytes. Text features are the
viewer's stand-in text encoder: a unit normal vector a label, drawn by
numpy from the first four bytes (little-endian) of the SHA-256 of
"text:" + label.
"""
from __future__ import annotations

import hashlib
import math
import struct
import zlib
from typing import Dict, List

import numpy as np
import torch

from . import render as R

# ScanNet's palette (NYU40 colours), entry 0 black for "other"
PALETTE = np.array([
    [0, 0, 0], [174, 199, 232], [152, 223, 138], [31, 119, 180], [255, 187, 120],
    [188, 189, 34], [140, 86, 75], [255, 152, 150], [214, 39, 40], [197, 176, 213],
    [148, 103, 189], [196, 156, 148], [23, 190, 207], [247, 182, 210], [219, 219, 141],
    [255, 127, 14], [158, 218, 229], [44, 160, 44], [112, 128, 144], [227, 119, 194],
    [213, 92, 176]], np.float32)


def text_features(labels: List[str], dim: int) -> np.ndarray:
    out = []
    for label in labels:
        seed = int.from_bytes(hashlib.sha256(("text:" + label).encode()).digest()[:4], "little")
        out.append(np.random.default_rng(seed).normal(size=dim))
    f = np.stack(out).astype(np.float32)
    return f / np.linalg.norm(f, axis=-1, keepdims=True)


def decode_png(data: bytes) -> np.ndarray:
    """8-bit RGB PNG (any of the five row filters) -> [H, W, 3] uint8."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, idat = 8, b""
    w = h = 0
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if zlib.crc32(kind + body) != struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0]:
            raise ValueError(f"bad CRC in {kind!r}")
        if kind == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            if depth != 8 or ctype != 2:
                raise ValueError("only 8-bit RGB")
        elif kind == b"IDAT":
            idat += body
        pos += 12 + length
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    out = np.zeros((h, 3 * w), np.int32)
    prev = np.zeros(3 * w, np.int32)
    for y in range(h):
        f, row = raw[y, 0], raw[y, 1:].astype(np.int32)
        if f == 0:
            cur = row
        elif f == 2:
            cur = (row + prev) & 255
        else:
            cur = np.zeros(3 * w, np.int32)
            for x in range(3 * w):
                a = cur[x - 3] if x >= 3 else 0
                b = prev[x]
                c = prev[x - 3] if x >= 3 else 0
                if f == 1:
                    pred = a
                elif f == 3:
                    pred = (a + b) // 2
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (row[x] + pred) & 255
        out[y] = cur
        prev = cur
    return out.reshape(h, w, 3).astype(np.uint8)


def request_camera(c2w: np.ndarray, width: int, height: int, fov_y: float, device) -> Dict:
    fov_x = 2.0 * math.atan(math.tan(fov_y / 2.0) * width / height)
    return R.camera(c2w, fov_x, fov_y, width, height, device)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.norm(x, dim=-1, keepdim=True) + 1e-8)


@torch.no_grad()
def render_mode(params: Dict[str, torch.Tensor], feats: torch.Tensor, cam: Dict, mode: str,
                prompts: List[str], sh_degree: int, dtype=torch.float32) -> np.ndarray:
    """[H, W, 3] uint8 image of one request, from the scene's parameters
    and per-Gaussian features [N, D]."""
    p = {k: v.to(dtype) for k, v in params.items()}
    dev = p["means"].device
    if mode in ("RGB", "Depth"):
        out = R.render(p, cam, sh_degree, torch.zeros(3, dtype=dtype, device=dev),
                       with_depth=mode == "Depth")
        if mode == "RGB":
            img = torch.clamp(out["image"].float(), 0, 1).cpu().numpy()
        else:
            d = out["depth"].float().cpu().numpy()
            lo, hi = np.percentile(d, 2), np.percentile(d, 98)
            img = np.repeat(((np.clip(d, lo, hi) - lo) / max(hi - lo, 1e-6))[..., None], 3, -1)
    else:
        f = feats.to(dtype)
        if mode == "Semantic":
            labels = ["other"] + list(prompts)
            text = torch.from_numpy(text_features(labels, f.shape[1])).to(dev, dtype)
            lab = torch.argmax(_normalize(f) @ text.T, dim=-1)
            colors = torch.nn.functional.one_hot(lab, len(labels)).to(dtype)
        else:
            text = torch.from_numpy(text_features(list(prompts), f.shape[1])).to(dev, dtype)
            rel = (_normalize(f) @ text.T).max(dim=-1, keepdim=True).values
            colors = torch.clamp((rel + 1) / 2, 0, 1)
        c = colors.shape[1]
        out = R.render(p, cam, sh_degree, torch.zeros(c, dtype=dtype, device=dev), colors=colors)
        ch = out["image"].float()
        if mode == "Semantic":
            img = (PALETTE[:c] / 255.0)[torch.argmax(ch, dim=-1).cpu().numpy()]
        else:
            r = ch[..., 0].cpu().numpy()
            img = np.stack([r, 0.2 + 0.6 * r, 1.0 - r], axis=-1)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)
