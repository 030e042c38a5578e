"""train.loss_ms: the device's busy time a step in the loss (L1 and SSIM)
and its backward: phases `loss` and `loss_bwd` of the program's markers
(common/phases.py)."""
from benchmark.common.phases import read_phases


def read(rec):
    return read_phases(rec, lambda s, steps: s.busy_ms("loss", "loss_bwd", steps=steps))
