"""What the two segment-sum probe tools share: the data law, the timer and
the table lines."""
from __future__ import annotations

import argparse
import time
from typing import Callable, List

import numpy as np
import torch

from ..ops.segsum_probe import CHUNK
from ..utils.device import card_stamp, resolve_device

D = 16
P_FULL = 3_670_016  # 7168 chunks of 512 pairs
ROWS_FULL = 1_000_000
REPS = 10


def parse_args(doc: str, argv):
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="shrink p and rows by this factor (1.0 = the full ladder)")
    args = ap.parse_args(argv)
    if not 0 < args.scale <= 1:
        ap.error("--scale must be in (0, 1]")
    return resolve_device(args.device), args.scale


def scaled(p: int, rows: int, scale: float):
    """(p, rows) shrunk by `scale`: p stays a positive multiple of CHUNK."""
    return max(CHUNK, int(round(p * scale / CHUNK)) * CHUNK), max(2, int(rows * scale))


def make_cot(rng: np.random.Generator, p: int, device) -> torch.Tensor:
    """The cotangent stream: the JAX tools draw normal (D, p) and keep pairs
    on the lanes; the port lays the same numbers out as [p, D] rows."""
    cot = rng.normal(size=(D, p)).astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(cot.T)).to(device)


def make_owners(rng: np.random.Generator, rows: int, p: int) -> np.ndarray:
    """Non-decreasing owners with steps of at most 1: a step with
    probability 0.95 rows / p, capped at rows - 1."""
    steps = (rng.uniform(size=p) < min(1.0, rows / p * 0.95)).astype(np.int32)
    steps[0] = 0
    return np.minimum(np.cumsum(steps), rows - 1).astype(np.int32)


class Table:
    """The tool's lines: each timed call is printed as it is measured and
    kept as a dict (label, ms, card)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.card = card_stamp(device)
        self.lines: List[dict] = []

    def timeit(self, label: str, fn: Callable[[], torch.Tensor], **extra) -> torch.Tensor:
        """Mean ms of fn() over REPS calls after one warm-up: CUDA events on
        the card, the host clock on the CPU."""
        out = fn()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(REPS):
                out = fn()
            end.record()
            torch.cuda.synchronize(self.device)
            ms = start.elapsed_time(end) / REPS
        else:
            t0 = time.perf_counter()
            for _ in range(REPS):
                out = fn()
            ms = (time.perf_counter() - t0) / REPS * 1e3
        self.lines.append(dict(label=label, ms=ms, card=self.card, **extra))
        print(f"{label}: {ms:.3f} ms  [{self.card}]", flush=True)
        return out

    def note(self, label: str, value: float) -> None:
        self.lines.append(dict(label=label, value=value, card=self.card))
        print(f"  {label}: {value}", flush=True)


def index_add(cot: torch.Tensor, owners: torch.Tensor, rows: int) -> Callable[[], torch.Tensor]:
    """The library call that computes the production segment sum: one
    `index_add_` of the rows onto their owners (float atomics on the card)."""
    idx = owners.long()

    def run():
        return torch.zeros((rows, cot.shape[1]), device=cot.device).index_add_(0, idx, cot)

    return run
