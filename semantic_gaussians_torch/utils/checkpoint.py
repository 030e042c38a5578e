"""Train-state checkpoints and checkpoint directory helpers.

Port of semantic_gaussians_tpu.utils.checkpoint. `save_state` writes any
tree of frozen dataclasses of tensors (a TrainState: params, alive mask,
Adam moments, densify statistics, step) with torch.save, as a nested dict
of CPU tensors keyed by field name; `load_state` rebuilds it on a device
with the structure of a `like` tree.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Optional

import torch


def _to_tree(x: Any) -> Any:
    if dataclasses.is_dataclass(x):
        return {f.name: _to_tree(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    raise TypeError(f"cannot checkpoint a {type(x).__name__}")


def _from_tree(tree: Any, like: Any, device) -> Any:
    if dataclasses.is_dataclass(like):
        return type(like)(**{
            f.name: _from_tree(tree[f.name], getattr(like, f.name), device)
            for f in dataclasses.fields(like)
        })
    return tree.to(device)


def save_state(path, state: Any) -> None:
    """Save a dataclass tree of tensors to `path` (one torch.save file)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(_to_tree(state), path)


def load_state(path, like: Any, device="cpu") -> Any:
    """Load a tree saved by save_state; `like` gives its structure."""
    return _from_tree(torch.load(Path(path), map_location="cpu"), like, device)


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
