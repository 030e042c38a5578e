"""A traced window's device time by the program's phases.

The port opens each phase of its train step with an empty kernel named
`sgt_phase_<phase>` (semantic_gaussians_torch/utils/tracing.py, launched
on the stream and captured into its CUDA graphs); a phase lasts on the
stream until the next marker. Its host spans, `sgt.` record_function
ranges, are on the trace's clock too. Pure arithmetic over a Trace
(common/trace.py):

- busy time and device operations by phase: each device event belongs to
  the phase of the last marker that started before it (before the first
  marker: `between`). An event's time that an earlier event already
  covers is not counted again, so the phases' busy time sums to
  Trace.busy_s(). Markers are counted in busy time, not as operations.
- inner gaps: idle time inside a dispatch, by the phase in force at the
  gap's start;
- dispatch gaps: idle time while `between` is in force (from the end of a
  dispatch to the next), by the innermost `sgt.` host span running at the
  gap's middle.

The trace's device timestamps are put on the host's clock first: the
window opens on an idle device (the harness synchronises), so its first
device event cannot start before the host's first launch call; where it
seems to, the device clock is read that much later (offsets of ~0.8 ms
are seen).

The idle time at the window's edges (its wall less the time from the
first device event's start to the last one's end) is split so: from the
first `sgt.` span's start to the first device event, a dispatch gap by
the span at its middle; the rest, the harness's own time before the
first call and after the last device event, a dispatch gap labelled
EDGE (or, if the window ends inside a dispatch, an inner gap of the
phase then in force). So every idle microsecond of the window is
counted once: busy + inner gaps + dispatch gaps = the window's wall.
Where the device events span more than the window's wall (the two
clocks' rates differ by some 30 ppm), the gaps are scaled down together
to the window's idle time. A trace without markers gives None.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

MARKER = "sgt_phase_"
SPAN = "sgt."
BETWEEN = "between"
OUTSIDE = "outside any sgt. span"
EDGE = "window edge, outside the program"
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch", "cudaMemcpyAsync",
            "cudaMemsetAsync")


@dataclasses.dataclass
class Split:
    """Microseconds (and counts) of one traced window."""

    window_us: float
    busy_us: Dict[str, float]  # by phase, markers included
    ops: Dict[str, int]  # device events by phase, markers left out
    inner_us: Dict[str, float]  # idle inside a dispatch, by phase
    dispatch_us: Dict[str, float]  # idle between dispatches, by host span
    markers: List[str]  # the phases the markers opened, in stream order
    dispatch_gaps: List[Tuple[float, float, str]]  # each (start, end, host span)
    inner_gaps: List[Tuple[float, float, str]]  # each (start, end, phase)
    shift_us: float = 0.0  # added to a device time to put it on the host's clock

    def busy_ms(self, *phases: str, steps: int = 1) -> float:
        return sum(self.busy_us.get(p, 0.0) for p in phases) / steps / 1e3

    def inner_ms(self, steps: int = 1) -> float:
        return sum(self.inner_us.values()) / steps / 1e3

    def dispatch_ms(self, steps: int = 1) -> float:
        return sum(self.dispatch_us.values()) / steps / 1e3


def phased(device: List[Tuple[float, float, str]]) -> Iterator[Tuple[str, float, float, str]]:
    """(phase, ts, dur, name) for each device event, in time order."""
    current = BETWEEN
    for ts, dur, name in device:
        if name.startswith(MARKER):
            current = name[len(MARKER):]
        yield current, ts, dur, name


class _Spans:
    """The innermost `sgt.` host span running at a device time."""

    def __init__(self, host: List[Tuple[float, float, str]], first_device: float):
        self.spans = sorted((s for s in host if s[2].startswith(SPAN)), key=lambda s: s[0])
        self.starts = [s[0] for s in self.spans]
        launches = [ts for ts, _, name in host if name in LAUNCHES]
        self.shift = max(0.0, min(launches) - first_device) if launches else 0.0

    def at(self, t: float) -> str:
        t += self.shift
        for j in range(bisect.bisect_right(self.starts, t) - 1, -1, -1):
            ts, dur, name = self.spans[j]
            if ts + dur >= t:
                return name
        return OUTSIDE


def _add(d: Dict, key, v) -> None:
    d[key] = d.get(key, 0) + v


def split(trace) -> Optional[Split]:
    """The window's phases and gaps, or None where no marker ran."""
    if not any(name.startswith(MARKER) for _, _, name in trace.device):
        return None
    spans = _Spans(trace.host, trace.device[0][0])
    out = Split(trace.window_s * 1e6, {}, {}, {}, {}, [], [], [], spans.shift)

    def gap(phase: str, a: float, b: float, label: Optional[str] = None) -> None:
        if b <= a:
            return
        if phase == BETWEEN:
            label = label or spans.at(0.5 * (a + b))
            _add(out.dispatch_us, label, b - a)
            out.dispatch_gaps.append((a, b, label))
        else:
            _add(out.inner_us, phase, b - a)
            out.inner_gaps.append((a, b, phase))

    covered, first, last_phase = None, None, BETWEEN
    for phase, ts, dur, name in phased(trace.device):
        if covered is None:
            first = covered = ts
        gap(last_phase, covered, ts)
        _add(out.busy_us, phase, max(0.0, ts + dur - max(ts, covered)))
        covered = max(covered, ts + dur)
        if name.startswith(MARKER):
            out.markers.append(phase)
        else:
            _add(out.ops, phase, 1)
        last_phase = phase
    # the window's edges: idle before the first device event and after the last
    edge = out.window_us - (covered - first)
    if edge >= 0:
        start = spans.starts[0] - spans.shift if spans.starts else first
        lead = min(max(0.0, first - start), edge)
        gap(BETWEEN, first - lead, first)
        gap(last_phase, covered, covered + edge - lead, EDGE)
    else:
        idle = max(0.0, out.window_us - sum(out.busy_us.values()))
        f = idle / max(idle - edge, 1e-9)
        for d in (out.inner_us, out.dispatch_us):
            for k in d:
                d[k] *= f
    return out


def read_phases(rec: Dict, value) -> Optional[float]:
    """A per-layer reader's number: value(split, steps) over the record's
    traced window, or None where there is nothing to read (no traced
    window, or no marker in it)."""
    layer = rec.get("layer")
    if not layer or layer.get("trace") is None or layer.get("steps", 0) <= 0:
        return None
    s = split(layer["trace"])
    return None if s is None else value(s, layer["steps"])
