"""feat.update_ms: the device's busy time a step in the update of a
Feature 3DGS step (densify statistics, learning rates, Adam on the 3DGS
leaves and the feature field, the step's metrics): phase `update`
(common/phases.py)."""
from benchmark.common.phases import read_phases


def read(rec):
    return read_phases(rec, lambda s, steps: s.busy_ms("update", steps=steps))
