"""feat.mfu: the Feature 3DGS step's float32 operations, counted from its
inputs (feature_counts.feature_step_ops at 3 + D channels), over the traced
window's wall time a step, as a share of the card's float32 peak."""
from benchmark.metrics.counts import PEAK_F32
from benchmark.metrics.feature_counts import feature_step_ops


def read(rec):
    layer = rec.get("layer")
    if not layer or layer.get("steps", 0) <= 0 or not layer.get("feature_dim"):
        return None
    ops = feature_step_ops(layer["counts"], layer["gaussians"], layer["pixels"],
                           layer["feature_dim"])
    return 100.0 * ops / (layer["wall_s"] / layer["steps"]) / PEAK_F32
