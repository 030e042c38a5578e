"""Segmentation metrics: confusion matrix, IoU, accuracy.

Port of semantic_gaussians_tpu.utils.metrics: a bincount confusion with an
"unlabeled" class appended at index num_classes whose row is dropped,
per-class IoU from the confusion matrix, and the eval_result.log style
report.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def confusion_matrix(pred_ids: np.ndarray, gt_ids: np.ndarray, num_classes: int):
    """[num_classes, num_classes+1] confusion; row = gt without unlabeled,
    col = pred. `pred_ids` / `gt_ids` are int arrays in [0, num_classes];
    id == num_classes means "unlabeled". The gt-unlabeled row is dropped; a
    predicted-unlabeled column is kept so totals still add up."""
    pred_ids = np.asarray(pred_ids).reshape(-1)
    gt_ids = np.asarray(gt_ids).reshape(-1)
    assert pred_ids.shape == gt_ids.shape
    idxs = gt_ids * (num_classes + 1) + pred_ids
    counts = np.bincount(idxs, minlength=(num_classes + 1) ** 2)
    return counts.reshape(num_classes + 1, num_classes + 1)[:num_classes, :]


def confusion_matrix_device(
    pred_ids: torch.Tensor, gt_ids: torch.Tensor, num_classes: int
) -> torch.Tensor:
    """`confusion_matrix` on tensors, on their device (int64 counts): the
    evaluation sums these per view, so only a [num_classes, num_classes+1]
    matrix leaves the device instead of a label image per view. The counts
    are an integer scatter-add into a fixed [(K+1)^2] (bincount reads the
    largest id back to the host, which a CUDA graph cannot hold)."""
    idxs = gt_ids.reshape(-1).long() * (num_classes + 1) + pred_ids.reshape(-1).long()
    counts = torch.zeros((num_classes + 1) ** 2, dtype=torch.int64, device=idxs.device)
    counts.index_add_(0, idxs, torch.ones_like(idxs))
    return counts.reshape(num_classes + 1, num_classes + 1)[:num_classes, :]


def get_iou(label_id: int, confusion: np.ndarray):
    """(iou, tp, denom) for one class, or False when the class never occurs."""
    tp = np.longlong(confusion[label_id, label_id])
    fn = np.longlong(confusion[label_id, :].sum()) - tp
    fp = np.longlong(confusion[:, label_id].sum()) - tp
    denom = tp + fp + fn
    if denom == 0:
        return False
    return float(tp) / denom, tp, denom


def evaluate_confusion(
    confusion: np.ndarray,
    class_names: Sequence[str],
    stdout: bool = False,
    dataset: str = "scannet_3d",
    log_file: Optional[str] = None,
):
    """Per-class IoU / accuracy and their means; returns (mean_iou,
    mean_acc). Classes with no ground-truth pixels are skipped entirely (a
    predicted-but-absent class must not drag a 0 into the means), as in the
    reference protocol."""
    num_classes = len(class_names)
    ious, accs = np.zeros(num_classes), np.zeros(num_classes)
    valid = np.zeros(num_classes, dtype=bool)
    lines = [f"classes  IoU  Acc  ({dataset})"]
    for i in range(num_classes):
        out = get_iou(i, confusion)
        row_sum = confusion[i, :].sum()
        accs[i] = confusion[i, i] / max(float(row_sum), 1.0)
        if out is not False and row_sum > 0:
            ious[i], tp, denom = out
            valid[i] = True
            lines.append(
                f"{class_names[i]:<14s}: {ious[i]:>5.3f}   "
                f"({tp:>6d}/{denom:<6d})  acc {accs[i]:>5.3f}"
            )
        else:
            lines.append(f"{class_names[i]:<14s}: -")
    mean_iou = float(ious[valid].mean()) if valid.any() else 0.0
    mean_acc = float(accs[valid].mean()) if valid.any() else 0.0
    lines.append(f"mean IoU: {mean_iou:.4f}  mean Acc: {mean_acc:.4f}")
    report = "\n".join(lines)
    if stdout:
        print(report)
    if log_file:
        with open(log_file, "a") as f:
            f.write(report + "\n")
    return mean_iou, mean_acc
