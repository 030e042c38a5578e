"""train.dispatch_gap_ms: the device's idle time a step between dispatches
(phase `between` of the program's markers, and the window's edges), where
the host's loop and graph runner hold the card back (common/phases.py)."""
from benchmark.common.phases import read_phases


def read(rec):
    return read_phases(rec, lambda s, steps: s.dispatch_ms(steps))
