"""train.mfu: the whole training step's float32 operations, counted from
its inputs (counts.train_step_ops), over the traced window's wall time a
step, as a share of the card's float32 peak."""
from benchmark.metrics.counts import PEAK_F32, train_step_ops


def read(rec):
    layer = rec.get("layer")
    if not layer or layer.get("steps", 0) <= 0:
        return None
    ops = train_step_ops(layer["counts"], layer["gaussians"], layer["pixels"], layer["channels"])
    step_s = layer["wall_s"] / layer["steps"]
    return 100.0 * ops / step_s / PEAK_F32
