"""distill.mfu: the sparse UNet's float32 operations a step (forward and
backward, three times the forward's count of neighbour pairs times
channels on the step's voxels) over the traced window's wall time a step,
as a share of the float32 peak (the port's matmuls run in float32, TF32
off)."""
from benchmark.metrics.counts import PEAK_F32


def read(rec):
    layer = rec.get("layer")
    if not layer or not layer.get("step_ops") or layer.get("steps", 0) <= 0:
        return None
    return 100.0 * layer["step_ops"] / (layer["wall_s"] / layer["steps"]) / PEAK_F32
