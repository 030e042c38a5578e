"""feat.loss_ms: the device's busy time a step in the feature L1 and its
backward: phases `feat_loss` and `feat_loss_bwd` of the program's markers
(common/phases.py)."""
from benchmark.common.phases import read_phases


def read(rec):
    return read_phases(rec, lambda s, steps: s.busy_ms("feat_loss", "feat_loss_bwd",
                                                       steps=steps))
