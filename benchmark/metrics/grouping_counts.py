"""Operation counts of a Gaussian Grouping training step (an identity
field of D channels composited with the colour, C = 3 + D; a classifier of
K classes), on top of counts.py's RGB step, whose functions take the
channel count. Frozen like counts.py: each count is of the work the inputs
need.
"""
from __future__ import annotations

from typing import Dict

from benchmark.metrics.counts import ADAM_OPS, train_step_ops

# a logit both ways beyond its products: log-softmax (max, exp, sum, log,
# subtract) and the cross-entropy's gradient (softmax, less the one-hot,
# scale)
CE_LOGIT_OPS = 8
# a probability of the 3D term both ways beyond its products: softmax over
# every Gaussian (5) and its backward (3)
SOFTMAX_OPS = 8
# a (sample, neighbour, class) entry of the KL both ways: two logs, the
# difference, the product, the sum; and their gradients
KL_OPS = 10
# a (sample, candidate) distance: three differences, squares and adds
DISTANCE_OPS = 8


def classifier_ops(rows: float, dim: int, classes: int) -> float:
    """The 1x1 convolution over `rows` vectors both ways: the logits, the
    input's gradient and the weight's, 2 D K each."""
    return 3 * 2 * rows * dim * classes


def identity_ops(pixels: int, dim: int, classes: int) -> float:
    """L_2d both ways over a view's pixels."""
    return classifier_ops(pixels, dim, classes) + pixels * classes * CE_LOGIT_OPS


def reg3d_ops(gaussians: int, dim: int, classes: int, g: Dict) -> float:
    """L_3d both ways on a step that adds it: the classifier and the
    softmax over every Gaussian, the distances from each sample to every
    candidate, the KL over the samples' neighbours."""
    cand = min(g["reg3d_max_points"], gaussians)
    samples = min(g["reg3d_sample"], cand)
    return (classifier_ops(gaussians, dim, classes) + gaussians * classes * SOFTMAX_OPS
            + samples * cand * DISTANCE_OPS + samples * g["reg3d_k"] * classes * KL_OPS)


def grouping_step_ops(c: Dict, gaussians: int, pixels: int, dim: int, g: Dict,
                      reg3d_share: float) -> float:
    """float32 operations of one step on average: the RGB step's count with
    the composite and segment sum at 3 + D channels, plus L_2d, the 3D term
    on `reg3d_share` of the steps, and Adam on the field's D parameters a
    Gaussian and the classifier's (D + 1) K."""
    k = g["num_classes"]
    return (train_step_ops(c, gaussians, pixels, 3 + dim) + identity_ops(pixels, dim, k)
            + reg3d_share * reg3d_ops(gaussians, dim, k, g)
            + (gaussians * dim + (dim + 1) * k) * ADAM_OPS)
