"""Open-vocabulary segmentation evaluation entry point (port of the root
eval_segmentation.py).

Usage:
    python -m semantic_gaussians_torch.cli.eval_segmentation \\
        semantic_gaussians_torch/config/yamls/eval.yaml \\
        scene.scene_path=... model.model_dir=... fusion.out_dir=... \\
        eval.eval_mode=2d [--device cpu]

Modes: 2d (fused per-Gaussian features), 3d (the distilled sparse UNet's
features: checkpoint `<distill.model_dir>/model_<distill.iteration>.npz`,
the Gaussians voxelized at `distill.voxel_size` into `distill.voxel_budget`
voxels), 2d_and_3d (both, `eval.feature_fusion` concat or argmax),
pretrained (the 2D provider run on each eval view), labelmap (precomputed
per-view label maps).
Ground truth: <scene>/label-filt/<frame>.png raw ids mapped through the
scene's scannetv2 TSV, or train-id label images in `eval.label_dir`.
Evaluates every 10th training view on CUDA (`eval.device`, default cuda);
raises if CUDA is absent unless the CPU was asked for. Appends the report
to `eval.log_file` (default eval_result.log).
"""
from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np
import torch

from ..config.config import load_config, pretty
from ..data.scannet_constants import (
    COCOMAP_CLASS_LABELS, SCANNET20_CLASS_LABELS, map_label_image, read_label_mapping,
)
from ..io.scene import load_scene
from ..models.predictors import RandomFeatureProvider, TorchCLIPTextEncoder, make_predictor
from ..pipelines.distill import load_distill_model, make_gaussian_features
from ..pipelines.eval_segmentation import (
    EvalAccumulator, ensemble_argmax_class, ensemble_features, eval_views, text_feature_matrix,
)
from ..pipelines.fusion import load_fused_features
from ..utils.camera import make_camera
from ..utils.device import resolve_device
from .fusion import load_model

DISTILL_MODES = ("3d", "2d_and_3d")
MODES = ("2d", "pretrained", "labelmap") + DISTILL_MODES


def _unit_rows(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-8)


def _load_label_map(lm_dir: pathlib.Path, name: str):
    """A predicted label map [H, W] int64 from <name>.pt (a tensor) or
    <name>.png, or None when neither exists."""
    from PIL import Image

    p_pt, p_png = lm_dir / f"{name}.pt", lm_dir / f"{name}.png"
    if p_pt.exists():
        return np.asarray(torch.load(p_pt, map_location="cpu", weights_only=True), np.int64)
    if p_png.exists():
        return np.asarray(Image.open(p_png), np.int64)
    return None


def distilled_features(cfg, params, alive, dim) -> torch.Tensor:
    """Per-Gaussian features [cap, dim] of the distilled UNet checkpoint
    `<distill.model_dir>/model_<distill.iteration>.npz`, on the Gaussians'
    device."""
    d = cfg.distill
    in_channels, features = make_gaussian_features(
        params, alive, d.get("feature_type", "all"), float(d.get("voxel_size", 0.02)),
        int(d.get("voxel_budget", 200_000)))
    ckpt = pathlib.Path(d.model_dir) / f"model_{d.iteration}.npz"
    return features(load_distill_model(ckpt, in_channels, dim, d.get("model_3d", "MinkUNet34A"),
                                       params.means.device))


def main(argv=None):
    """Evaluate as configured. Returns (mIoU, mAcc, confusion), or None when
    the scene has no ground-truth label images."""
    from PIL import Image

    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("config")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args, overrides = ap.parse_known_args(argv)
    cfg = load_config(args.config, overrides)
    e = cfg.eval
    device = resolve_device(args.device or e.get("device", "cuda"))
    print(pretty(cfg))
    mode = e.get("eval_mode", "2d")
    if mode not in MODES:
        raise ValueError(f"unknown eval_mode {mode!r}")
    dataset = cfg.scene.get("dataset_name", "cocomap")
    labels = SCANNET20_CLASS_LABELS if dataset == "scannet20" else COCOMAP_CLASS_LABELS
    fusion = cfg.get("fusion") or {}
    dim = int(fusion.get("embedding_dim", 768))

    # Text features; eval.model_2d selects a provider used for both the text
    # and the `pretrained` mode's per-view image features.
    if e.get("model_2d"):
        enc = make_predictor(e.model_2d, e)
    elif e.get("text_model_path"):
        enc = TorchCLIPTextEncoder(e.text_model_path, dim)
    else:
        print("WARNING: no local CLIP checkpoint; using random text features")
        enc = RandomFeatureProvider(dim)
    text = text_feature_matrix(enc, labels)

    scene = load_scene(cfg.scene.scene_path, eval_split=False)
    params, alive = load_model(cfg, device)
    scene_name = pathlib.Path(cfg.scene.scene_path).name
    gauss_feats = feats_2d = feats_3d = None
    if mode in ("2d", "2d_and_3d"):
        fused = sorted((pathlib.Path(fusion.out_dir) / scene_name).glob("*.pt"))[0]
        feats_2d, _ = load_fused_features(fused, capacity=params.capacity, device=device)
    if mode in DISTILL_MODES:
        feats_3d = distilled_features(cfg, params, alive, dim)
    if mode == "2d":
        gauss_feats = feats_2d
    elif mode == "3d":
        gauss_feats = feats_3d
    elif mode == "2d_and_3d":
        if e.get("feature_fusion", "concat") == "concat":
            gauss_feats = ensemble_features(feats_2d, feats_3d)
            text = np.concatenate([text, text], axis=-1)
        else:
            # each Gaussian's class by the larger of its two similarities,
            # evaluated as that class's exact text feature
            text_t = torch.from_numpy(text).to(device)
            gauss_feats = text_t[ensemble_argmax_class(feats_2d, feats_3d, text_t)]

    # eval views + ground-truth labels
    cams, gts, eval_infos = [], [], []
    label_dir = e.get("label_dir")
    wh = (int(e.get("width", 648)), int(e.get("height", 484)))
    mapping_tsv = pathlib.Path(cfg.scene.scene_path) / "scannetv2-labels.modified.tsv"
    mapping = (
        read_label_mapping(
            mapping_tsv, label_to="scannetid" if dataset == "scannet20" else "cocomapid"
        )
        if mapping_tsv.exists() else None
    )
    for ci in scene.train_cameras[::10]:
        if label_dir:
            lbl_path = pathlib.Path(label_dir) / f"{ci.image_name}.png"
        else:
            lbl_path = pathlib.Path(cfg.scene.scene_path) / "label-filt" / f"{ci.image_name}.png"
        if not lbl_path.exists():
            continue
        raw = np.asarray(Image.open(lbl_path).resize(wh, Image.NEAREST))
        gt = map_label_image(raw, mapping, len(labels)) if mapping else raw.astype(np.int64)
        gts.append(np.clip(gt, 0, len(labels)))
        cams.append(make_camera(ci.R, ci.T, ci.fov_x, ci.fov_y, wh[0], wh[1], device=device))
        eval_infos.append(ci)
    if not cams:
        print("no GT label images found — nothing to evaluate")
        return None

    log_file = e.get("log_file", "eval_result.log")
    if mode == "pretrained":
        # The 2D model run directly on each eval view, per-pixel similarity
        # against the text features.
        acc = EvalAccumulator(len(labels))
        tj = _unit_rows(text)
        for ci, gt in zip(eval_infos, gts):
            feat = _unit_rows(enc.extract_image_feature(ci.image_path, wh))
            pix = np.argmax(np.einsum("hwd,kd->hwk", feat, tj), axis=-1)
            acc.add_view(np.where(pix == 0, len(labels), pix - 1), gt)
        miou, macc = acc.report(labels, stdout=True, log_file=log_file,
                                dataset=f"pretrained/{dataset}")
        confusion = acc.confusion
    elif mode == "labelmap":
        lm_dir = pathlib.Path(e.get("labelmap_dir") or e.label_dir)
        acc = EvalAccumulator(len(labels))
        for ci, gt in zip(eval_infos, gts):
            lm = _load_label_map(lm_dir, ci.image_name)
            if lm is None:
                continue
            if lm.shape != gt.shape:
                lm = np.asarray(Image.fromarray(lm.astype(np.int32), mode="I").resize(
                    (gt.shape[1], gt.shape[0]), Image.NEAREST))
            acc.add_view(np.clip(lm, 0, len(labels)), gt)
        miou, macc = acc.report(labels, stdout=True, log_file=log_file,
                                dataset=f"labelmap/{dataset}")
        confusion = acc.confusion
    else:
        miou, macc, confusion = eval_views(
            cams, gts, params, alive, gauss_feats, text, labels,
            pred_on_3d=bool(e.get("pred_on_3d", True)),
            backend=(cfg.get("pipeline") or {}).get("backend", "tiled"),
            stdout=True, log_file=log_file, chunk_views=int(e.get("chunk_views", 8)),
        )
    print(f"mIoU {miou:.4f}  mAcc {macc:.4f}")
    return miou, macc, confusion


if __name__ == "__main__":
    main()
