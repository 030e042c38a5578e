"""VLPart-style open-vocabulary predictor: detector proposals -> SAM box
refinement -> score-weighted CLIP text features per pixel.

Port of semantic_gaussians_tpu.models.vlpart. Detections scoring at least
box_threshold are refined into masks by SAM box prompts (single-mask
output), resampled to the image in one bilinear step (the JAX module's
`scale_and_translate`, vlpart.py:311: `automask.resample_logits`),
thresholded at 0, holes under 400 px filled; each pixel's feature is the
score-weighted sum of its detections' CLIP text embeddings, L2-normalized.
The detector is pluggable: a callable (RGB uint8 HxWx3) -> (boxes xyxy
[N, 4], scores [N], class ids [N]); `PrecomputedDetections` reads the
`.npz` exports that `save_detections` writes; `NativeOpenVocabDetector`
classifies SAM automatic-mask proposals with the CLIP image tower.
Output [H, W, 768] float32, channel-last.
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..utils.device import resolve_device
from .automask import remove_small_regions, resample_logits
from .predictors import load_image
from .sam import Sam, preprocess_image


def save_detections(path, boxes, scores, classes) -> None:
    """One image's detections in the `.npz` schema PrecomputedDetections
    reads: boxes [N, 4] float32 xyxy in image coordinates, scores [N]
    float32, classes [N] int64 indices into the export vocabulary."""
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    scores = np.asarray(scores, np.float32).reshape(-1)
    classes = np.asarray(classes, np.int64).reshape(-1)
    if not (len(boxes) == len(scores) == len(classes)):
        raise ValueError(f"ragged detections: {len(boxes)} boxes, {len(scores)} scores, "
                         f"{len(classes)} classes")
    if len(boxes) and not ((boxes[:, 0] <= boxes[:, 2]).all() and (boxes[:, 1] <= boxes[:, 3]).all()):
        raise ValueError("boxes must be xyxy with x1<=x2, y1<=y2")
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    np.savez(p, boxes=boxes, scores=scores, classes=classes)


class PrecomputedDetections:
    """Detector over offline `.npz` exports keyed by image stem."""

    def __init__(self, det_dir):
        self.dir = Path(det_dir)
        self._current: Optional[str] = None

    def set_current(self, img_path):
        self._current = Path(str(img_path)).stem

    def __call__(self, image: np.ndarray):
        if self._current is None:
            raise ValueError("call set_current(img_path) first")
        z = np.load(self.dir / f"{self._current}.npz")
        return (np.asarray(z["boxes"], np.float32), np.asarray(z["scores"], np.float32),
                np.asarray(z["classes"], np.int64))


def prompt_texts(vocab: Sequence[str], prefix_prompt: str = "a ") -> list:
    """Prompted class texts plus the trailing 'background' row."""
    return [prefix_prompt + v.lower().replace(":", " ").replace("_", " ")
            for v in vocab] + ["background"]


class NativeOpenVocabDetector:
    """Open-vocabulary detector: SAM automatic-mask proposals classified by
    the CLIP image tower against the vocabulary's text features and a
    'background' row (softmax at CLIP's logit scale 100). Proposals whose
    argmax is background are dropped; a score is p(class) x predicted IoU."""

    def __init__(self, automask, clip_encoder, text_encoder, *,
                 vocabulary: Optional[Sequence[str]] = None, logit_scale: float = 100.0,
                 clip_batch: int = 64, prefix_prompt: str = "a "):
        self.automask, self.clip_encoder, self.text_encoder = automask, clip_encoder, text_encoder
        self.logit_scale, self.clip_batch, self.prefix_prompt = logit_scale, clip_batch, prefix_prompt
        self.text_features: Optional[np.ndarray] = None
        if vocabulary is not None:
            self.set_vocabulary(vocabulary)

    def set_vocabulary(self, vocab: Sequence[str]):
        t = np.asarray(self.text_encoder.extract_text_feature(
            prompt_texts(vocab, self.prefix_prompt)))
        self.text_features = t / (np.linalg.norm(t, axis=-1, keepdims=True) + 1e-8)

    @torch.inference_mode()
    def __call__(self, image: np.ndarray):
        if self.text_features is None:
            raise ValueError("set_vocabulary first")
        from .samclip import pad_square_crop

        img = load_image(image)
        anns = self.automask.generate(img)[0]  # the merged multi-scale set
        if not anns:
            z = np.zeros((0,), np.float32)
            return np.zeros((0, 4), np.float32), z, z.astype(np.int64)
        dev = self.clip_encoder.device
        size = self.clip_encoder.tower.image_size
        fimg = img.astype(np.float32) / 255.0
        crops = torch.stack([pad_square_crop(fimg, a["segmentation"], a["bbox"], size, dev)
                             for a in anns])
        emb = torch.cat([self.clip_encoder.encode(crops[i: i + self.clip_batch])
                         for i in range(0, len(crops), self.clip_batch)]).float().cpu().numpy()
        emb = emb / (np.linalg.norm(emb, axis=-1, keepdims=True) + 1e-8)
        logits = self.logit_scale * (emb @ self.text_features.T)
        logits -= logits.max(axis=-1, keepdims=True)
        probs = np.exp(logits)
        probs /= probs.sum(axis=-1, keepdims=True)
        cls = np.argmax(probs[:, :-1], axis=-1)  # the best non-background class
        keep = np.argmax(probs, axis=-1) != probs.shape[1] - 1
        iou = np.array([a["predicted_iou"] for a in anns], np.float32)
        scores = probs[np.arange(len(anns)), cls] * iou
        boxes = np.array([[b[0], b[1], b[0] + b[2], b[1] + b[3]]
                          for b in (a["bbox"] for a in anns)], np.float32)
        return boxes[keep], scores[keep].astype(np.float32), cls[keep].astype(np.int64)


class VLPartPredictor:
    """Predictor2D provider: detections -> SAM box masks -> score-weighted
    text features (`predictors.make_predictor` loads SAM from a
    checkpoint); runs on CUDA unless `device` asks for the CPU."""

    embedding_dim = 768

    def __init__(self, detector: Callable, sam_model: Sam, *, text_encoder=None,
                 vocabulary: Optional[Sequence[str]] = None, box_threshold: float = 0.3,
                 min_hole_area: int = 400, sam_batch: int = 32, device=None):
        self.device = resolve_device(device)
        self.detector = detector
        self.model = sam_model.to(self.device).eval()
        self.cfg = self.model.cfg
        self.text_encoder = text_encoder
        self.box_threshold, self.min_hole_area, self.sam_batch = box_threshold, min_hole_area, sam_batch
        self.classes: Optional[str] = None
        self.text_features: Optional[np.ndarray] = None
        if vocabulary is not None:
            self.set_predefined_cls(vocabulary)

    # -- protocol surface ---------------------------------------------------

    def set_predefined_cls(self, cls: Sequence[str]):
        self.classes = ".".join(cls)
        self._refresh_text()

    def set_predefined_part(self, cls: str, parts: Sequence[str]):
        self.classes = ".".join(f"{cls}:{e}" for e in parts)
        self._refresh_text()

    def get_text(self, vocabulary: str, prefix_prompt: str = "a "):
        return prompt_texts(vocabulary.split("."), prefix_prompt)

    def _refresh_text(self):
        if self.text_encoder is not None and self.classes:
            self.text_features = np.asarray(
                self.text_encoder.extract_text_feature(self.get_text(self.classes)))
            self.embedding_dim = int(self.text_features.shape[-1])
        if hasattr(self.detector, "set_vocabulary") and self.classes:
            # the native detector's class ids index get_text()'s rows
            self.detector.set_vocabulary(self.classes.split("."))

    def extract_text_feature(self, labelset) -> np.ndarray:
        if self.text_encoder is None:
            raise ValueError("no text tower; pass text_encoder")
        return np.asarray(self.text_encoder.extract_text_feature(labelset))

    # -- image path ---------------------------------------------------------

    @torch.inference_mode()
    def box_masks(self, img: np.ndarray, boxes: np.ndarray) -> np.ndarray:
        """(N, H, W) bool masks of SAM box prompts at image size."""
        h, w = img.shape[:2]
        x, rhw = preprocess_image(img, self.cfg.img_size, self.device)
        emb = self.model.encode_image(x[None])[0]
        boxes_enc = torch.from_numpy(boxes * (self.cfg.img_size / max(h, w))).to(self.device)
        masks = []
        for i0 in range(0, len(boxes_enc), self.sam_batch):
            logits, _ = self.model.predict_boxes(emb, boxes_enc[i0: i0 + self.sam_batch])
            masks.append((resample_logits(logits, (h, w), rhw) > 0.0).cpu().numpy())
        return np.concatenate(masks)

    def extract_image_feature(self, img_path, img_size=None) -> np.ndarray:
        if self.text_features is None:
            raise ValueError("set_predefined_cls first (fusion.vocabulary)")
        if hasattr(self.detector, "set_current"):
            if isinstance(img_path, np.ndarray):
                raise ValueError("PrecomputedDetections needs an image PATH (detections "
                                 "are keyed by file stem); got an array")
            self.detector.set_current(img_path)
        img = load_image(img_path)
        h, w = img.shape[:2]
        out_hw = (int(img_size[1]), int(img_size[0])) if img_size is not None else (h, w)
        boxes, scores, classes = self.detector(img)
        keep = scores >= self.box_threshold
        boxes, scores, classes = boxes[keep], scores[keep], classes[keep]
        if len(boxes) == 0:
            return np.zeros((*out_hw, self.embedding_dim), np.float32)
        masks = np.stack([remove_small_regions(m, self.min_hole_area, "holes")[0]
                          for m in self.box_masks(img, boxes)])
        if out_hw != (h, w):  # nearest resize (skimage order=0 in the reference)
            yi = (np.arange(out_hw[0]) * h / out_hw[0]).astype(np.int64)
            xi = (np.arange(out_hw[1]) * w / out_hw[1]).astype(np.int64)
            masks = masks[:, yi][:, :, xi]
        class_sem = self.text_features[np.asarray(classes, np.int64)] * scores[:, None]
        with torch.inference_mode():
            sem = torch.einsum("nc,nhw->hwc",
                               torch.from_numpy(class_sem.astype(np.float32)).to(self.device),
                               torch.from_numpy(masks).to(self.device, torch.float32))
            sem = sem / (sem.norm(dim=-1, keepdim=True) + 1e-8)
        return sem.cpu().numpy()
