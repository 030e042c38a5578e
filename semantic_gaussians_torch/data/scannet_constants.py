"""ScanNet dataset metadata (public dataset constants).

Port of semantic_gaussians_tpu.data.scannet_constants: the class label sets
of ScanNet-20 and the COCO-Map subset, the visualization palette (first
entry = unlabeled/black), the raw-id -> train-id label mapping read from a
scannetv2-labels TSV, and the label-image helpers built on them.
"""
from __future__ import annotations

import csv
from typing import Dict

import numpy as np

SCANNET20_CLASS_LABELS = (
    "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door",
    "window", "bookshelf", "picture", "counter", "desk", "curtain",
    "refridgerator", "shower curtain", "toilet", "sink", "bathtub",
)

COCOMAP_CLASS_LABELS = (
    "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door",
    "window", "shelves", "counter", "curtain", "ceiling", "refridgerator",
    "television", "person", "toilet", "sink", "lamp", "bag",
)

COLORMAP = np.array(
    [
        (0.0, 0.0, 0.0), (174.0, 199.0, 232.0), (152.0, 223.0, 138.0),
        (31.0, 119.0, 180.0), (255.0, 187.0, 120.0), (188.0, 189.0, 34.0),
        (140.0, 86.0, 75.0), (255.0, 152.0, 150.0), (214.0, 39.0, 40.0),
        (197.0, 176.0, 213.0), (148.0, 103.0, 189.0), (196.0, 156.0, 148.0),
        (23.0, 190.0, 207.0), (247.0, 182.0, 210.0), (219.0, 219.0, 141.0),
        (255.0, 127.0, 14.0), (158.0, 218.0, 229.0), (44.0, 160.0, 44.0),
        (112.0, 128.0, 144.0), (227.0, 119.0, 194.0), (213.0, 92.0, 176.0),
        (94.0, 106.0, 211.0), (82.0, 84.0, 163.0), (100.0, 85.0, 144.0),
        (66.0, 188.0, 102.0), (140.0, 57.0, 197.0), (202.0, 185.0, 52.0),
        (51.0, 176.0, 203.0), (200.0, 54.0, 131.0), (92.0, 193.0, 61.0),
        (78.0, 71.0, 183.0), (172.0, 114.0, 82.0), (91.0, 163.0, 138.0),
        (153.0, 98.0, 156.0), (140.0, 153.0, 101.0), (100.0, 125.0, 154.0),
        (178.0, 127.0, 135.0), (146.0, 111.0, 194.0), (96.0, 207.0, 209.0),
    ],
    dtype=np.float32,
)


def read_label_mapping(
    tsv_path, label_from: str = "id", label_to: str = "scannetid"
) -> Dict[int, int]:
    """raw-id -> train-id mapping from a scannetv2-labels TSV; rows whose
    ids do not parse are skipped."""
    mapping = {}
    with open(tsv_path) as f:
        for row in csv.DictReader(f, delimiter="\t"):
            try:
                mapping[int(row[label_from])] = int(row[label_to])
            except (ValueError, KeyError):
                continue
    return mapping


def map_label_image(
    label_img: np.ndarray, mapping: Dict[int, int], num_classes: int
) -> np.ndarray:
    """Apply a raw->train mapping; unmapped ids, and raw ids outside the
    TSV's range, become num_classes (unlabeled)."""
    lut = np.full(int(max(mapping.keys(), default=0)) + 1, num_classes, np.int64)
    for k, v in mapping.items():
        lut[k] = v
    raw = label_img.astype(np.int64)
    out = lut[np.clip(raw, 0, len(lut) - 1)]
    return np.where((raw < 0) | (raw >= len(lut)), num_classes, out)


def render_palette(label_img: np.ndarray, num_classes: int) -> np.ndarray:
    """Label map -> RGB float image via the ScanNet palette; ids ==
    num_classes (unlabeled) map to black."""
    pal = COLORMAP[: num_classes + 1] / 255.0
    ids = np.clip(np.asarray(label_img, np.int64) + 1, 0, num_classes)
    ids = np.where(np.asarray(label_img) >= num_classes, 0, ids)
    return pal[ids].astype(np.float32)
