"""Step timing and TensorBoard logging (port of StepTimer and TBLogger from
semantic_gaussians_tpu.utils.logging_utils; the JAX profiler helpers are
not ported: torch.profiler serves on the card)."""
from __future__ import annotations

import time
from pathlib import Path
from typing import Optional

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
