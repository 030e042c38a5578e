"""ReLU sign flips: why a float32 gradient of the sparse UNet parts from its
float64 value, and a float64 reference that shares float32's ReLU masks.

A pre-activation that float64 puts within rounding of zero can land on the
other side of zero in float32. The ReLU's gradient mask then differs at
that one entry, and a leaf whose gradient is a sum with cancellation over
the voxels moves by that entry's whole term: a few percent of the leaf's
largest magnitude for one flip in a deep level of MinkUNet34A. Which
entries flip follows the order of the float32 sums, so two devices flip
different entries. Run float64 through float32's masks (`relu_calls(masks)`)
and what is left between the two is rounding alone.

`relu_calls` swaps `torch.relu`, which the port's MinkUNet calls for every
activation, for the length of a `with` block.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import torch


@contextlib.contextmanager
def relu_calls(masks: Optional[Sequence[torch.Tensor]] = None):
    """Within the block every torch.relu call appends its input (detached)
    to the yielded list. With `masks`, one bool tensor a call in call
    order, a call returns its input times the call's mask instead of
    testing the sign, so the backward passes where the mask is set."""
    inputs: List[torch.Tensor] = []
    relu = torch.relu

    def patched(x):
        inputs.append(x.detach().clone())
        if masks is None:
            return relu(x)
        return x * masks[len(inputs) - 1].to(x.dtype)

    torch.relu = patched
    try:
        yield inputs
    finally:
        torch.relu = relu


def sign_flips(inputs: Sequence[torch.Tensor],
               reference: Sequence[torch.Tensor]) -> List[Tuple[int, int, float]]:
    """(call, entries whose sign differs, the largest |reference| at such an
    entry over the call's largest |reference|) for every ReLU call where
    `inputs` and `reference` (the same calls in another precision) differ
    in sign."""
    if len(inputs) != len(reference):
        raise ValueError(f"{len(inputs)} ReLU calls against {len(reference)}")
    out = []
    for i, (a, b) in enumerate(zip(inputs, reference)):
        b = b.to(a.device, torch.float64)
        flip = (a > 0) != (b > 0)
        n = int(flip.sum())
        if n:
            out.append((i, n, float(b[flip].abs().max() / b.abs().max().clamp_min(1e-300))))
    return out
