"""Device selection for the port's entry points.

The card is the default: an entry point runs on CUDA unless the caller asks
for the CPU (`device="cpu"`). Without CUDA and without that request it
raises — there is no silent CPU fallback.
"""
from __future__ import annotations

import subprocess
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (render.device: cpu, "
            "or --device cpu) to run on the CPU"
        )
    return dev


def card_stamp(device: Union[str, torch.device]) -> str:
    """What a measurement is stamped with: for a CUDA device its name and
    power limit as `nvidia-smi --query-gpu=name,power.limit` prints them
    (a card set below its maximum limit runs slower under load), else the
    device's type."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[dev.index or 0] if out else torch.cuda.get_device_name(dev)


def synchronize(device: Union[str, torch.device]) -> None:
    """Wait for the work queued on a CUDA device; nothing on the CPU (its
    ops finish before they return). Timers call it around timed work."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
