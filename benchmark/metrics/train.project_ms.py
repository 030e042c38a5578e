"""train.project_ms: the device's busy time a step in the projection and
SH colour, forward and backward: phases `project` and `project_bwd` of the
program's markers (common/phases.py)."""
from benchmark.common.phases import read_phases


def read(rec):
    return read_phases(rec, lambda s, steps: s.busy_ms("project", "project_bwd", steps=steps))
