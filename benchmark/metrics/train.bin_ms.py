"""train.bin_ms: the device's busy time a step in binning (sort,
searchsorted, the expand kernel, the packed geometry): phase `bin` of the
program's markers (common/phases.py)."""
from benchmark.common.phases import read_phases


def read(rec):
    return read_phases(rec, lambda s, steps: s.busy_ms("bin", steps=steps))
