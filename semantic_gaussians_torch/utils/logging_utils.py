"""Step timing, TensorBoard logging and device traces.

Port of semantic_gaussians_tpu.utils.logging_utils: StepTimer, TBLogger,
and the profiler helpers on torch.profiler (`profile_trace` writes a
Chrome trace, `top_ops` ranks its events by time a step).
"""
from __future__ import annotations

import contextlib
import gzip
import json
import time
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np


def _summary_writer(log_dir):
    """torch's SummaryWriter on `log_dir`, or None where tensorboard is not
    installed."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    return SummaryWriter(str(log_dir))


class TBLogger:
    """Thin SummaryWriter wrapper; a no-op (`active` false) without
    tensorboard. Values may be device tensors: they are read only when a
    writer takes them."""

    def __init__(self, log_dir):
        self.writer = _summary_writer(log_dir)

    @property
    def active(self) -> bool:
        return self.writer is not None

    def scalar(self, tag, value, step):
        if self.writer:
            self.writer.add_scalar(tag, float(value), int(step))

    def histogram(self, tag, values, step):
        if self.writer:
            self.writer.add_histogram(tag, np.asarray(values), int(step))

    def close(self):
        if self.writer:
            self.writer.close()


class StepTimer:
    """EMA of per-step wall time, in seconds (host clock: on the card it
    measures enqueue time unless the timed block synchronizes)."""

    def __init__(self, ema: float = 0.6):
        self.ema = ema
        self.value: Optional[float] = None
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self.value = dt if self.value is None else (
            self.ema * self.value + (1 - self.ema) * dt
        )
        return False


# Chrome-trace categories of the device's own timeline in torch.profiler's
# export (kernels, copies and fills on a CUDA stream); host threads carry
# cpu_op, cuda_runtime, python_function and the like.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def profile_trace(log_dir):
    """Trace the block with torch.profiler (the host, and the CUDA device
    where there is one) and write it to `<log_dir>/trace.pt.trace.json`
    as a Chrome trace that top_ops reads. Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.pt.trace.json"))


def _trace_files(trace_dir) -> List[Path]:
    root = Path(trace_dir)
    return sorted(root.glob("**/*.trace.json")) + sorted(root.glob("**/*.trace.json.gz"))


def _trace_events(trace_dir):
    for f in _trace_files(trace_dir):
        opener = gzip.open if f.suffix == ".gz" else open
        with opener(f, "rt") as fh:
            yield from json.load(fh).get("traceEvents", [])


def device_busy_ms(trace_dir) -> float:
    """Milliseconds in which the device ran anything (the union of its
    events' intervals over all streams) in the traces under `trace_dir`."""
    spans = sorted((float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]))
                   for ev in _trace_events(trace_dir)
                   if ev.get("ph") == "X" and "dur" in ev
                   and ev.get("cat") in DEVICE_CATEGORIES)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def top_ops(trace_dir, k: int = 20, steps: int = 1,
            device_only: bool = True) -> List[Tuple[float, str]]:
    """[(ms a step, op name)] summed over the complete ("X") events of every
    Chrome trace under `trace_dir`, largest first, at most `k`. With
    `device_only` only the device's events count (DEVICE_CATEGORIES): the
    host's threads would drown the listing in dispatch and Python frames."""
    totals: dict = {}
    for ev in _trace_events(trace_dir):
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        if device_only and ev.get("cat") not in DEVICE_CATEGORIES:
            continue
        name = ev.get("name", "?")
        totals[name] = totals.get(name, 0.0) + float(ev["dur"])
    out = sorted(((dur / 1e3 / steps, name) for name, dur in totals.items()), reverse=True)
    return out[:k]
