"""Operation counts of a Feature 3DGS training step (a field of D channels
composited with the colour, C = 3 + D), on top of counts.py's RGB step,
whose functions take the channel count. Frozen like counts.py: each count
is of the work the inputs need.
"""
from __future__ import annotations

from typing import Dict

from benchmark.metrics.counts import ADAM_OPS, PARAMS_PER_GAUSSIAN, train_step_ops

# a pixel and channel of the feature L1, forward and backward: the
# difference, its absolute value and the sum; the sign and the scale
FEATURE_L1_OPS = 5


def params_per_gaussian(dim: int) -> int:
    """Parameters Adam updates a Gaussian: 59 of 3DGS and the field's D."""
    return PARAMS_PER_GAUSSIAN + dim


def feature_step_ops(c: Dict, gaussians: int, pixels: int, dim: int) -> float:
    """float32 operations of one step: the RGB step's count with the
    composite and segment sum at 3 + D channels, plus the feature L1 over
    D channels a pixel and Adam on the field's D parameters a Gaussian."""
    return (train_step_ops(c, gaussians, pixels, 3 + dim)
            + pixels * dim * FEATURE_L1_OPS
            + gaussians * dim * ADAM_OPS)
