"""Open-vocabulary segmentation evaluation (mIoU / mAcc).

Port of semantic_gaussians_tpu.pipelines.eval_segmentation. Two prediction
paths per view:
  pred_on_3d=True : per-Gaussian argmax -> render one-hot class vectors ->
                    per-pixel argmax
  pred_on_3d=False: render raw features -> normalize -> dot text -> argmax
The text matrix has 'other' prepended at row 0; predicted train-ids are the
argmax index - 1, with 'other' mapping to the confusion matrix's unlabeled
column. The confusion is summed on the device that holds the Gaussians;
`eval_views` takes full chunks of views in one dispatch each (`_eval_chunk`,
on CUDA one CUDA-graph replay, as the JAX package's lax.scan chunk).
`voxelize_for_net` makes the sparse UNet's input (modes 3d and 2d_and_3d,
and the distill trainer's eval render).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.gaussians import GaussianParams
from ..renderer import render_chn
from ..utils.camera import Camera
from ..utils.graphs import GraphRunner
from ..utils.metrics import confusion_matrix, confusion_matrix_device, evaluate_confusion


def text_feature_matrix(text_encoder, class_labels: Sequence[str]) -> np.ndarray:
    """[K+1, D] normalized text features with 'other' at row 0."""
    labelset = ["other"] + list(class_labels)
    return np.asarray(text_encoder.extract_text_feature(labelset), np.float32)


def _normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-8) -> torch.Tensor:
    return x / (torch.linalg.norm(x, dim=dim, keepdim=True) + eps)


def predict_label_image(
    camera: Camera,
    params: GaussianParams,
    alive: torch.Tensor,
    gauss_feats: torch.Tensor,  # [cap, D]
    text: torch.Tensor,  # [K+1, D] ('other' row 0)
    pred_on_3d: bool = False,
    backend: str = "tiled",
    tile_shape=None,
    pair_budget: Optional[int] = None,
) -> torch.Tensor:
    """[H, W] int32 predicted ids in [0, K]; K = unlabeled/other (class ids
    0-based, 'other' and empty pixels mapped to K)."""
    kp1 = text.shape[0]
    kw = dict(alive=alive, backend=backend, pair_budget=pair_budget)
    if tile_shape is not None:
        kw["tile_shape"] = tile_shape
    with torch.no_grad():
        if pred_on_3d:
            cls = torch.argmax(_normalize(gauss_feats) @ text.T, dim=-1)  # 0 = other
            classes = torch.arange(kp1, device=cls.device)
            onehot = (cls[:, None] == classes).to(torch.float32) * alive[:, None]
            pix = torch.argmax(render_chn(camera, params, onehot, **kw)["render"], dim=-1)
        else:
            out = render_chn(camera, params, gauss_feats, **kw)
            pix = torch.argmax(_normalize(out["render"]) @ text.T, dim=-1)
    # 0 ('other') -> K (the unlabeled column); else id - 1
    return torch.where(pix == 0, kp1 - 1, pix - 1).to(torch.int32)


def ensemble_features(feats_2d: torch.Tensor, feats_3d: torch.Tensor, mode: str = "concat"):
    """'concat' ensemble: stacked normalized features (the caller tiles the
    text); for 'argmax' use ensemble_argmax_class."""
    if mode != "concat":
        raise ValueError("use ensemble_argmax_class for argmax mode")
    return torch.cat([_normalize(feats_2d), _normalize(feats_3d)], dim=-1)


def ensemble_argmax_class(
    feats_2d: torch.Tensor, feats_3d: torch.Tensor, text: torch.Tensor
) -> torch.Tensor:
    """Per-Gaussian class by max similarity over both feature sets."""
    s2 = _normalize(feats_2d) @ text.T
    s3 = _normalize(feats_3d) @ text.T
    return torch.argmax(torch.maximum(s2, s3), dim=-1)


def voxel_feats_to_gaussians(
    voxel_feats: np.ndarray,
    inverse: np.ndarray,
    n_gaussians: int,
    cap: int,
    num_valid: Optional[int] = None,
    device="cpu",
) -> torch.Tensor:
    """Scatter per-voxel outputs back to per-Gaussian features [cap, F] via
    the voxelizer's point -> voxel map. Gaussians mapped to a voxel id >=
    num_valid (dropped by a static voxel budget) get a zero row."""
    vf = np.asarray(voxel_feats)
    inv = np.asarray(inverse[:n_gaussians])
    if num_valid is not None and inv.size and int(inv.max(initial=0)) >= num_valid:
        vf = np.concatenate([vf, np.zeros((1, vf.shape[-1]), vf.dtype)])
        inv = np.where(inv < num_valid, inv, len(vf) - 1)
    out = np.zeros((cap, vf.shape[-1]), np.float32)
    out[:n_gaussians] = vf[inv]
    return torch.from_numpy(out).to(device)


def voxelize_for_net(
    locs: np.ndarray,  # [N, 3] world positions (alive prefix)
    point_feats: np.ndarray,  # [N, F] packed Gaussian features
    voxel_size: float,
    voxel_budget: int,
    device,
):
    """Voxelize points and pad to the voxel budget for the sparse UNet.
    Returns (feats_in [budget, F] and the topology on `device`, inverse [N]
    numpy, num_valid). Voxels past the budget are DROPPED (with a warning);
    pass num_valid to voxel_feats_to_gaussians so that their Gaussians get
    zero features."""
    from ..data.fusion_utils import Voxelizer
    from ..models.unet3d import build_topology

    vc, vf, _, inverse, _ = Voxelizer(voxel_size=voxel_size).voxelize(locs, point_feats)
    v = min(len(vc), voxel_budget)
    if len(vc) > voxel_budget:
        print(f"WARNING: {len(vc) - voxel_budget} voxels over the {voxel_budget} budget "
              f"dropped (raise distill.voxel_budget)")
    coords = np.zeros((voxel_budget, 3), np.int32)
    coords[:v] = vc[:v]
    feats_in = np.zeros((voxel_budget, point_feats.shape[-1]), np.float32)
    feats_in[:v] = vf[:v]
    topo = build_topology(torch.from_numpy(coords).to(device),
                          torch.from_numpy(np.arange(voxel_budget) < v).to(device))
    return torch.from_numpy(feats_in).to(device), topo, inverse, v


@dataclasses.dataclass
class EvalAccumulator:
    num_classes: int
    confusion: np.ndarray = None

    def __post_init__(self):
        if self.confusion is None:
            self.confusion = np.zeros((self.num_classes, self.num_classes + 1), np.int64)

    def add_view(self, pred_ids: np.ndarray, gt_ids: np.ndarray):
        """pred / gt [H, W]; ids in [0, num_classes] (num_classes = unlabeled)."""
        self.confusion += confusion_matrix(
            pred_ids.reshape(-1), gt_ids.reshape(-1), self.num_classes
        )

    def report(self, class_names, stdout=True, log_file=None, dataset="eval"):
        return evaluate_confusion(
            self.confusion, class_names, stdout=stdout, dataset=dataset, log_file=log_file
        )


def _eval_chunk(
    runner: GraphRunner,
    cam_stack: Camera,  # tensors stacked with a leading K
    gt_stack: torch.Tensor,  # [K, H, W] int32 ids in [0, num_classes]
    conf: torch.Tensor,  # [num_classes, num_classes + 1] int64, the running sum
    params: GaussianParams,
    alive: torch.Tensor,
    gauss_feats: torch.Tensor,
    text: torch.Tensor,
    num_classes: int,
    pred_on_3d: bool,
    backend: str,
    pair_budget: Optional[int] = None,
) -> torch.Tensor:
    """K views added to the confusion sum in one dispatch (on CUDA one
    replay of a graph captured per K and statics; the per-view label
    images never leave the device). Returns the new sum."""
    from .train import camera_at, camera_statics, camera_tensors

    k = gt_stack.shape[0]

    def body(carry, inp):
        total = carry["conf"]
        for j in range(k):
            pred = predict_label_image(camera_at(cam_stack, inp, j), params, alive, gauss_feats,
                                       text, pred_on_3d, backend, pair_budget=pair_budget)
            total = total + confusion_matrix_device(pred, inp["gt"][j], num_classes)
        return {"conf": total}, {}

    key = ("eval", k, pred_on_3d, backend, pair_budget, camera_statics(cam_stack))
    carry, _ = runner.run(key, body, {"conf": conf},
                          dict(camera_tensors(cam_stack), gt=gt_stack))
    return carry["conf"]


def _stack_eval_views(cameras, gt_label_images, device):
    """(stacked camera, gt [K, H, W] int32) where all views share their
    camera statics and label-image shape; None otherwise (the caller then
    goes view by view)."""
    from .train import stack_camera_chunk

    gts = [np.asarray(g) for g in gt_label_images]
    if len({g.shape for g in gts}) != 1:
        return None
    cam_stack = stack_camera_chunk([c.to(device) for c in cameras])
    if cam_stack is None:
        return None
    return cam_stack, torch.from_numpy(np.stack(gts).astype(np.int32)).to(device)


def eval_views(
    cameras: Sequence[Camera],
    gt_label_images: Sequence[np.ndarray],
    params: GaussianParams,
    alive: torch.Tensor,
    gauss_feats: torch.Tensor,
    text: np.ndarray,
    class_labels: Sequence[str],
    pred_on_3d: bool = False,
    backend: str = "tiled",
    stdout: bool = False,
    log_file: Optional[str] = None,
    chunk_views: int = 8,
    pair_budget: Optional[int] = None,
):
    """Evaluate one scene over its views. Returns (mIoU, mAcc, confusion).
    Each view's label image and confusion stay on the device; only the
    summed [K, K+1] matrix comes back. Full chunks of `chunk_views` views go
    through `_eval_chunk` (one CUDA-graph replay a chunk on the card, the
    views one by one on the CPU); the remainder, and every view when
    `chunk_views` <= 1 or the views' camera statics or label shapes differ,
    go through the per-view loop, as in the JAX package."""
    num_classes = len(class_labels)
    dev = params.device
    text_t = torch.as_tensor(np.asarray(text, np.float32)).to(dev)
    conf = torch.zeros((num_classes, num_classes + 1), dtype=torch.int64, device=dev)
    todo = list(zip(cameras, gt_label_images))
    runner = GraphRunner(dev)
    while chunk_views > 1 and len(todo) >= chunk_views:
        chunk = todo[:chunk_views]
        stacked = _stack_eval_views([c for c, _ in chunk], [g for _, g in chunk], dev)
        if stacked is None:
            break
        todo = todo[chunk_views:]
        conf = _eval_chunk(runner, stacked[0], stacked[1], conf, params, alive, gauss_feats,
                           text_t, num_classes, pred_on_3d, backend, pair_budget)
    for cam, gt in todo:
        pred = predict_label_image(
            cam, params, alive, gauss_feats, text_t, pred_on_3d, backend,
            pair_budget=pair_budget,
        )
        gt_t = torch.as_tensor(np.asarray(gt)).to(dev)
        conf = conf + confusion_matrix_device(pred, gt_t, num_classes)
    acc = EvalAccumulator(num_classes, conf.cpu().numpy())
    miou, macc = acc.report(class_labels, stdout=stdout, log_file=log_file)
    return miou, macc, acc.confusion
