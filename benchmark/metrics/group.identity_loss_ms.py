"""group.identity_loss_ms: the device's busy time a step in Gaussian
Grouping's identity terms outside the 3D one: the classifier over the
rendered identity, the cross-entropy and their backward, phases
`obj_loss` and `obj_loss_bwd` of the program's markers (common/phases.py)."""
from benchmark.common.phases import read_phases


def read(rec):
    return read_phases(rec, lambda s, steps: s.busy_ms("obj_loss", "obj_loss_bwd",
                                                       steps=steps))
