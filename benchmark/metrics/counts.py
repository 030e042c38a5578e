"""Operation and byte counts of the port's kernels and steps, and the
card's peaks: the yardstick the roofline and MFU metrics divide by.

Frozen from PERF.md's kernel bounds. Each count is of the work the inputs
need, not of what a kernel happens to do, so it reads the same whatever
implements the kernel. A bound is the larger of bytes over the memory
bandwidth (each input read once, each output written once) and float32
operations over the float32 peak.
"""
from __future__ import annotations

from typing import Dict, Optional

# NVIDIA's data sheet, H100 SXM, dense, at 700 W
PEAK_F32 = 67e12  # FLOP/s, float32 outside the tensor cores
PEAK_TF32 = 495e12  # FLOP/s, TF32 tensor cores
PEAK_BYTES = 3.35e12  # B/s, HBM3

# float32 operations a Gaussian costs in the projection (view and clip
# transforms, the EWA Jacobian, the 2D covariance, its inverse, eigenvalue
# and rect) and in degree-3 SH colour (16 basis values, 48 multiply-adds,
# the view direction); a backward costs twice its forward
PROJECT_OPS = 190
SH_OPS = 150
# a pixel of the loss: L1 (3 channels) and SSIM's five maps blurred by
# 11 + 11 taps (two operations a tap) on 3 channels, plus its formula
LOSS_PIXEL_OPS = 3 * 3 + 5 * 22 * 2 * 3 + 20 * 3
ADAM_OPS = 12  # per parameter: both moments, the bias corrections, the step
PARAMS_PER_GAUSSIAN = 3 + 3 + 45 + 3 + 4 + 1  # means, SH (48 with the DC), scales, quat, opacity


def bound_s(ops: float, nbytes: float, peak: float = PEAK_F32) -> float:
    return max(ops / peak, nbytes / PEAK_BYTES)


def expand_bound_s(dense: float, budget: float) -> float:
    """The pair expand: (32 num_dense + 12 budget) bytes."""
    return bound_s(0.0, 32 * dense + 12 * budget)


def composite_fwd_bound_s(c: Dict, channels: int, pixels: int) -> float:
    """18 operations a (pixel, pair) evaluated, 2C a contribution; bytes:
    the dense Gaussians' geometry (8 floats) and colours, the pair list,
    and the C + 3 output planes."""
    ops = 18 * c["evaluated"] + 2 * channels * c["contributing"]
    nbytes = c["dense"] * (8 + channels) * 4 + c["pairs"] * 4 + pixels * (channels + 3) * 4
    return bound_s(ops, nbytes)


def composite_bwd_bound_s(c: Dict, channels: int, pixels: int) -> float:
    """18 operations an alpha up to each pixel's last contribution, 20 + 4C
    a contribution; bytes: the forward's inputs, the output gradient, and
    a (6 + C)-float gradient row a pair."""
    ops = 18 * c["up_to_last"] + (20 + 4 * channels) * c["contributing"]
    nbytes = (c["dense"] * (8 + channels) * 4 + c["pairs"] * 4 + pixels * (channels + 2) * 4
              + c["pairs"] * (6 + channels) * 4)
    return bound_s(ops, nbytes)


def segsum_bound_s(live: float, rows: float, width: int) -> float:
    """The segment sum: live D 4 + live 4 + rows D 4 bytes."""
    return bound_s(0.0, live * width * 4 + live * 4 + rows * width * 4)


def train_step_ops(c: Dict, gaussians: int, pixels: int, channels: int = 3) -> float:
    """float32 operations of one training step: projection and SH forward
    and backward for every Gaussian, the composite both ways by its
    events, the loss both ways by pixel, the segment sum's adds, Adam."""
    return (3 * gaussians * (PROJECT_OPS + SH_OPS)
            + 18 * c["evaluated"] + 2 * channels * c["contributing"]
            + 18 * c["up_to_last"] + (20 + 4 * channels) * c["contributing"]
            + 3 * pixels * LOSS_PIXEL_OPS
            + c["live"] * (6 + channels)
            + gaussians * PARAMS_PER_GAUSSIAN * ADAM_OPS)


def share(bound: float, seconds: float) -> Optional[float]:
    """A bound's share of the time measured, in percent; None where no
    time was measured (nothing to read)."""
    if seconds <= 0:
        return None
    return 100.0 * bound / seconds


def idle_share(rec: Dict) -> Optional[float]:
    layer = rec.get("layer")
    if not layer or layer.get("trace") is None:
        return None
    tr = layer["trace"]
    if tr.window_s <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
