"""group.mfu: the Gaussian Grouping step's float32 operations, counted
from its inputs (grouping_counts.grouping_step_ops at 3 + D channels, the
3D term on the traced steps that took it), over the traced window's wall
time a step, as a share of the card's float32 peak."""
from benchmark.metrics.counts import PEAK_F32
from benchmark.metrics.grouping_counts import grouping_step_ops


def read(rec):
    layer = rec.get("layer")
    if not layer or layer.get("steps", 0) <= 0 or not layer.get("num_objects"):
        return None
    g = layer["grouping"]
    ops = grouping_step_ops(layer["counts"], layer["gaussians"], layer["pixels"],
                            layer["num_objects"], g, g["reg3d_steps"] / layer["steps"])
    return 100.0 * ops / (layer["wall_s"] / layer["steps"]) / PEAK_F32
