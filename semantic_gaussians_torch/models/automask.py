"""Automatic multi-scale mask generation over a point grid (SAM AMG).

Port of semantic_gaussians_tpu.models.automask: a points_per_side^2 grid of
positive point prompts goes through the mask decoder in batches (tokens
1..3 = small / medium / large); each batch's logits are resampled to the
image, filtered by predicted IoU and stability score, thresholded and boxed;
each scale's set and the merged set then go through greedy box NMS, small
holes and islands are removed, and NMS runs again preferring unchanged masks.

Three stages, which the smoke run times apart:
  * `decode_batch` (device): the decoder on one batch of points and the
    low-res -> image resample, as ONE bilinear resample (the JAX module's
    `scale_and_translate`, automask.py:174; upstream SAM chains two bilinear
    resizes, which differ from it by up to 4.3 on N(0, 1) logits). It is
    `F.interpolate(scale_factor=4h/rh, 4w/rw, recompute_scale_factor=False)`
    cropped to (h, w): 9.9e-5 from JAX on N(0, 1) logits of a 256^2 map.
  * `select` (the logits' device): IoU and stability filters, thresholding
    and boxes: integer and boolean results, identical on the card and the
    CPU for the same logits.
  * `finish` (host): NMS in numpy (`np.argsort(-scores)` breaks the many
    ties of the second NMS as the JAX package does) and region removal with
    scipy's 8-connected labels.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from .sam import Sam, SamConfig, preprocess_image


@dataclasses.dataclass(frozen=True)
class AutoMaskConfig:
    points_per_side: int = 32
    points_per_batch: int = 64
    pred_iou_thresh: float = 0.7
    stability_score_thresh: float = 0.85
    stability_score_offset: float = 1.0
    box_nms_thresh: float = 0.7
    min_mask_region_area: int = 100
    mask_threshold: float = 0.0


def build_point_grid(n: int) -> np.ndarray:
    """(n*n, 2) normalized [0, 1] xy grid with a half-cell offset."""
    off = 1.0 / (2 * n)
    g = np.linspace(off, 1.0 - off, n, dtype=np.float32)
    gx, gy = np.meshgrid(g, g)
    return np.stack([gx, gy], axis=-1).reshape(-1, 2)


def greedy_nms(boxes: np.ndarray, scores: np.ndarray, thresh: float) -> np.ndarray:
    """Indices kept by greedy IoU NMS over xyxy boxes, in order of
    descending score (ties as np.argsort(-scores) orders them)."""
    order = np.argsort(-scores)
    keep = []
    suppressed = np.zeros(len(boxes), bool)
    areas = np.maximum(boxes[:, 2] - boxes[:, 0], 0) * np.maximum(boxes[:, 3] - boxes[:, 1], 0)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        x1 = np.maximum(boxes[i, 0], boxes[:, 0])
        y1 = np.maximum(boxes[i, 1], boxes[:, 1])
        x2 = np.minimum(boxes[i, 2], boxes[:, 2])
        y2 = np.minimum(boxes[i, 3], boxes[:, 3])
        inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
        iou = inter / np.maximum(areas[i] + areas - inter, 1e-9)
        suppressed |= iou > thresh
    return np.array(keep, np.int64)


def masks_to_boxes(masks: torch.Tensor) -> torch.Tensor:
    """(..., H, W) bool -> (..., 4) int32 xyxy with exclusive x2 / y2;
    [0, 0, 0, 0] for an empty mask."""
    h, w = masks.shape[-2:]
    ys = torch.arange(h, device=masks.device)
    xs = torch.arange(w, device=masks.device)
    in_h, in_w = masks.any(dim=-1), masks.any(dim=-2)
    bottom = (in_h * ys).amax(dim=-1)
    top = torch.where(in_h, ys, h).amin(dim=-1)
    right = (in_w * xs).amax(dim=-1)
    left = torch.where(in_w, xs, w).amin(dim=-1)
    box = torch.stack([left, top, right + 1, bottom + 1], dim=-1)
    return torch.where(in_h.any(dim=-1)[..., None], box, 0).to(torch.int32)


def remove_small_regions(mask: np.ndarray, area_thresh: int, mode: str):
    """Fill small holes or drop small islands (8-connected components);
    returns (mask, changed)."""
    from scipy import ndimage

    if mode not in ("holes", "islands"):
        raise ValueError(f"mode must be holes or islands, got {mode!r}")
    correct_holes = mode == "holes"
    working = (correct_holes ^ mask).astype(np.uint8)
    labels, n = ndimage.label(working, structure=np.ones((3, 3), np.uint8))
    if n == 0:
        return mask, False
    sizes = ndimage.sum_labels(np.ones_like(working), labels, np.arange(1, n + 1))
    small = [i + 1 for i, s in enumerate(sizes) if s < area_thresh]
    if not small:
        return mask, False
    fill = np.isin(labels, small)
    if correct_holes:
        return mask | fill, True
    out = mask & ~fill
    if not out.any():  # keep the largest island rather than delete the mask
        out = labels == 1 + int(np.argmax(sizes))
    return out, True


def resample_logits(logits: torch.Tensor, hw, rhw) -> torch.Tensor:
    """Low-res mask logits (..., 4g, 4g) -> (..., h, w) of the original
    image in one bilinear resample (scale 4h/rh, 4w/rw, half-pixel centres,
    no antialias): the JAX package's `scale_and_translate`."""
    (h, w), (rh, rw) = hw, rhw
    lead = logits.shape[:-2]
    x = logits.reshape(-1, 1, *logits.shape[-2:])
    x = F.interpolate(x, scale_factor=(4.0 * h / rh, 4.0 * w / rw), mode="bilinear",
                      align_corners=False, recompute_scale_factor=False)
    return x[..., :h, :w].reshape(*lead, h, w)


class SamAutoMask:
    """Automatic mask generator over the port's Sam (on the model's device).
    `counts` holds how many masks the last `generate` kept at each stage:
    per scale after the IoU filter and after the stability filter, and per
    set (merged, s, m, l) after the first NMS, after region removal and the
    second NMS, and as annotations."""

    def __init__(self, model: Sam, amg: AutoMaskConfig = AutoMaskConfig()):
        self.model = model.eval()
        self.cfg: SamConfig = model.cfg
        self.amg = amg
        self.counts: dict = {}

    @property
    def device(self):
        return self.model.image_encoder.pos_embed.device

    @torch.inference_mode()
    def embed(self, image: np.ndarray):
        """The image's SAM embedding (g, g, D) and its resized (rh, rw)."""
        x, rhw = preprocess_image(image, self.cfg.img_size, self.device)
        return self.model.encode_image(x[None])[0], rhw

    def prompts(self, hw) -> torch.Tensor:
        """The point grid in the encoder's frame, padded to whole batches."""
        h, w = hw
        pts = build_point_grid(self.amg.points_per_side) * np.array([[w, h]], np.float32)
        pts = pts * (self.cfg.img_size / max(h, w))
        npad = (-len(pts)) % self.amg.points_per_batch
        pts = np.concatenate([pts, np.zeros((npad, 2), np.float32)])
        return torch.from_numpy(pts).to(self.device)

    def decode_batch(self, emb, points, hw, rhw):
        """One batch of point prompts (B, 2) -> image-size logits of the
        three scales (B, 3, h, w) and their predicted IoU (B, 3)."""
        labels = torch.ones((points.shape[0], 1), dtype=torch.int32, device=points.device)
        logits, iou = self.model.predict_points(emb, points[:, None], labels)
        return resample_logits(logits[:, 1:], hw, rhw), iou[:, 1:]

    def stability(self, logits):
        """Each mask's stability score: the pixels above threshold + offset
        over those above threshold - offset."""
        thr, off = self.amg.mask_threshold, self.amg.stability_score_offset
        inter = (logits > thr + off).sum(dim=(-2, -1))
        union = (logits > thr - off).sum(dim=(-2, -1))
        return inter / union.clamp(min=1)

    def select(self, logits, iou, nvalid: int):
        """The filters of one batch, on the logits' device: for each scale
        the kept rows' (masks, iou, stability, boxes) as host arrays."""
        a = self.amg
        thr = a.mask_threshold
        stab = self.stability(logits)
        logits, iou, stab = logits[:nvalid], iou[:nvalid], stab[:nvalid]
        out = []
        for sc in range(3):
            iou_ok = iou[:, sc] > a.pred_iou_thresh
            idx = torch.nonzero(iou_ok & (stab[:, sc] >= a.stability_score_thresh))[:, 0]
            if self.counts:
                self.counts["iou"][sc] += int(iou_ok.sum())
                self.counts["stability"][sc] += len(idx)
            masks = logits[idx, sc] > thr
            out.append(tuple(t.cpu().numpy() for t in
                             (masks, iou[idx, sc], stab[idx, sc], masks_to_boxes(masks))))
        return out

    @torch.inference_mode()
    def candidates(self, image: np.ndarray):
        """Every batch through the decoder and the filters: per scale, the
        lists of kept (masks, iou, stability, boxes) arrays."""
        h, w = image.shape[:2]
        emb, rhw = self.embed(image)
        pts = self.prompts((h, w))
        nreal = self.amg.points_per_side ** 2
        bsz = self.amg.points_per_batch
        self.counts = dict(points=nreal, iou=[0, 0, 0], stability=[0, 0, 0])
        per_scale = [dict(masks=[], iou=[], stab=[], boxes=[]) for _ in range(3)]
        for i0 in range(0, min(len(pts), nreal), bsz):
            logits, iou = self.decode_batch(emb, pts[i0: i0 + bsz], (h, w), rhw)
            for sc, arrays in enumerate(self.select(logits, iou, min(bsz, nreal - i0))):
                for key, a in zip(("masks", "iou", "stab", "boxes"), arrays):
                    per_scale[sc][key].append(a)
        return per_scale

    def finish(self, sets, name=None):
        """NMS, small-region removal, NMS preferring unchanged masks, then
        the annotation records (host); the stage counts go to
        counts[name]."""
        amg = self.amg
        stages = self.counts.setdefault(name, {}) if name else {}
        stages.update(nms=0, regions_nms=0, annotations=0)
        if not sets["masks"]:
            return []
        masks = np.concatenate(sets["masks"])
        iou = np.concatenate(sets["iou"])
        stab = np.concatenate(sets["stab"])
        boxes = np.concatenate(sets["boxes"]).astype(np.float32)
        if len(masks) == 0:
            return []
        keep = greedy_nms(boxes, iou, amg.box_nms_thresh)
        masks, iou, stab, boxes = masks[keep], iou[keep], stab[keep], boxes[keep]
        stages["nms"] = stages["regions_nms"] = len(keep)
        if amg.min_mask_region_area > 0:
            new_masks, unchanged = [], []
            for m in masks:
                m2, ch1 = remove_small_regions(m, amg.min_mask_region_area, "holes")
                m2, ch2 = remove_small_regions(m2, amg.min_mask_region_area, "islands")
                new_masks.append(m2)
                unchanged.append(float(not (ch1 or ch2)))
            masks = np.stack(new_masks)
            boxes = masks_to_boxes(torch.from_numpy(masks)).numpy().astype(np.float32)
            keep = greedy_nms(boxes, np.asarray(unchanged), amg.box_nms_thresh)
            masks, iou, stab, boxes = masks[keep], iou[keep], stab[keep], boxes[keep]
            stages["regions_nms"] = len(keep)
        anns = []
        for m, i, st, b in zip(masks, iou, stab, boxes):
            area = int(m.sum())
            if area == 0:
                continue
            anns.append(dict(
                segmentation=m,
                bbox=[float(b[0]), float(b[1]), float(b[2] - b[0]), float(b[3] - b[1])],
                area=area, predicted_iou=float(i), stability_score=float(st)))
        stages["annotations"] = len(anns)
        return anns

    def annotations(self, per_scale):
        """(merged, small, medium, large) annotation lists of the
        candidates."""
        merged = {k: [a for sc in per_scale for a in sc[k]]
                  for k in ("masks", "iou", "stab", "boxes")}
        s, m, l = (self.finish(sc, name) for sc, name in zip(per_scale, "sml"))
        return self.finish(merged, "merged"), s, m, l

    def generate(self, image: np.ndarray):
        """image (H, W, 3) uint8 RGB -> (anns, anns_s, anns_m, anns_l):
        lists of dicts with segmentation / bbox / area / predicted_iou /
        stability_score (the reference generator's 4-tuple)."""
        return self.annotations(self.candidates(image))
