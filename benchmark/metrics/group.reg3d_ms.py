"""group.reg3d_ms: the device's busy time in Gaussian Grouping's 3D term
and its backward (the draws, the neighbours, the classifier and softmax
over every Gaussian, the KL), phases `reg3d` and `reg3d_bwd`, over every
step of the traced window: with the term on every second iteration, half
of what one step that adds it costs."""
from benchmark.common.phases import read_phases


def read(rec):
    return read_phases(rec, lambda s, steps: s.busy_ms("reg3d", "reg3d_bwd", steps=steps))
