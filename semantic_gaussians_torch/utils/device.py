"""Device selection for the port's entry points.

The card is the default: an entry point runs on CUDA unless the caller asks
for the CPU (`device="cpu"`). Without CUDA and without that request it
raises — there is no silent CPU fallback.
"""
from __future__ import annotations

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
