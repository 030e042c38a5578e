"""Checkpoint directory helpers (port of the part of
semantic_gaussians_tpu.utils.checkpoint the viewer needs)."""
from __future__ import annotations

from pathlib import Path
from typing import Optional


def latest_iteration(model_dir, prefix: str = "iteration_") -> Optional[int]:
    """Largest N among `<model_dir>/<prefix>N` entries, or None."""
    model_dir = Path(model_dir)
    if not model_dir.exists():
        return None
    iters = []
    for p in model_dir.iterdir():
        if p.name.startswith(prefix):
            try:
                iters.append(int(p.name[len(prefix):]))
            except ValueError:
                pass
    return max(iters) if iters else None
