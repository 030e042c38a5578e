"""Step timing (port of StepTimer from semantic_gaussians_tpu.utils
.logging_utils). TensorBoard logging is not ported yet."""
from __future__ import annotations

import time
from typing import Optional


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
