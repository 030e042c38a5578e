"""train.inner_gap_ms: the device's idle time a step inside a dispatch (a
graph replay's node-to-node gaps, or an eager step's), by the program's
markers (common/phases.py)."""
from benchmark.common.phases import read_phases


def read(rec):
    return read_phases(rec, lambda s, steps: s.inner_ms(steps))
