"""Reading a window's device time from torch.profiler's trace.

The arithmetic is a frozen copy of the port's `utils/logging_utils`
(`device_busy_ms`, `top_ops`): the device's events are the Chrome trace's
"kernel", "gpu_memcpy" and "gpu_memset" complete events; busy time is the
union of their intervals over all streams. Added here: the idle gaps
between those intervals, each named by the host operation that was
running at the gap's middle.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import shutil
import tempfile
from pathlib import Path
from typing import Dict, List, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "python_function", "cuda_runtime")


class Trace:
    """The complete events of one traced window."""

    def __init__(self, events: List[Dict], window_s: float):
        self.window_s = window_s
        self.device = sorted(((float(e["ts"]), float(e["dur"]), e.get("name", "?"))
                              for e in events if e.get("ph") == "X" and "dur" in e
                              and e.get("cat") in DEVICE_CATEGORIES), key=lambda t: t[0])
        self.host = sorted(((float(e["ts"]), float(e["dur"]), e.get("name", "?"))
                            for e in events if e.get("ph") == "X" and "dur" in e
                            and e.get("cat") in HOST_CATEGORIES), key=lambda t: t[0])

    def intervals(self) -> List[Tuple[float, float]]:
        """The union of the device's busy intervals, in microseconds."""
        out: List[Tuple[float, float]] = []
        for ts, dur, _ in self.device:
            a, b = ts, ts + dur
            if out and a <= out[-1][1]:
                if b > out[-1][1]:
                    out[-1] = (out[-1][0], b)
            else:
                out.append((a, b))
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.intervals()) / 1e6

    def kernel_s(self, *substrings: str) -> float:
        """Seconds of device events whose name holds any of `substrings`."""
        return sum(dur for _, dur, name in self.device
                   if any(s in name for s in substrings)) / 1e6

    def top_ops(self, k: int = 10) -> List[List]:
        totals: Dict[str, float] = {}
        for _, dur, name in self.device:
            totals[name] = totals.get(name, 0.0) + dur
        top = sorted(totals.items(), key=lambda kv: -kv[1])[:k]
        return [[name[:120], dur / 1e6] for name, dur in top]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """The device's idle time between its busy intervals, summed by the
        innermost host operation running at each gap's middle, largest
        first."""
        iv = self.intervals()
        gaps = [(iv[i][1], iv[i + 1][0]) for i in range(len(iv) - 1) if iv[i + 1][0] > iv[i][1]]
        totals: Dict[str, float] = {}
        starts = [h[0] for h in self.host]
        for a, b in gaps:
            mid = 0.5 * (a + b)
            label = "host, outside any traced op"
            best = None
            i = bisect.bisect_right(starts, mid)
            # the innermost (latest-starting) host op that covers mid
            for j in range(i - 1, max(-1, i - 400), -1):
                ts, dur, name = self.host[j]
                if ts + dur >= mid:
                    best = name
                    break
            if best is not None:
                label = best
            totals[label] = totals.get(label, 0.0) + (b - a)
        top = sorted(totals.items(), key=lambda kv: -kv[1])[:k]
        return [[name[:120], dur / 1e6] for name, dur in top]


@contextlib.contextmanager
def profiled(out: Dict):
    """Trace the block with torch.profiler (host and CUDA); on exit
    `out["trace"]` holds its Trace over the block's wall time. The Chrome
    trace goes to a temporary directory under TMPDIR and is deleted."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    tmp = Path(tempfile.mkdtemp(prefix="bench_trace_", dir=os.environ.get("TMPDIR")))
    try:
        with profile(activities=acts) as prof:
            sync()
            t0 = time.perf_counter()
            yield
            sync()
            wall = time.perf_counter() - t0
        path = tmp / "trace.json"
        prof.export_chrome_trace(str(path))
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        out["trace"] = Trace(events, wall)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
