"""train.update_ms: the device's busy time a step in the update (densify
statistics, learning rates, Adam, the step's metrics): phase `update` of
the program's markers (common/phases.py)."""
from benchmark.common.phases import read_phases


def read(rec):
    return read_phases(rec, lambda s, steps: s.busy_ms("update", steps=steps))
