"""Phase markers on the device and spans on the host, for torch.profiler.

Both kinds of mark land in one torch.profiler trace, on the clock of its
device events, and nothing else records them:

* `phase(name, device)` launches the empty kernel `sgt_phase_<name>`
  (csrc/phase.cu) <<<1, 1>>> on the current stream. A phase lasts on the
  stream from its marker to the next one, so phases are flat and in stream
  order. A stream that is being captured into a CUDA graph always gets the
  marker, so that every replay of the graph carries it; eagerly a marker is
  launched only while a profiler records; on the CPU never.
* `span(name)` is a `torch.profiler.record_function` while a profiler
  records (a `user_annotation` event of the trace), else one shared no-op
  context, so an untraced run allocates nothing.

The phases of a train step, in stream order (PHASES): `project` (the
leaves, projection and SH colour), `bin` (sort, searchsorted, expand, the
packed geometry), `composite` (the forward kernel, untiling), `loss` (L1
and SSIM), with a feature field (Feature 3DGS) `feat_loss` (the feature
L1) and `feat_loss_bwd` (its backward, which runs first), with Gaussian
Grouping's identity field `obj_loss` (the classifier over the rendered
identity and the cross-entropy), on the steps with the 3D term `reg3d`
(the draws, the neighbours, the classifier over every Gaussian, the KL)
and `reg3d_bwd` (its backward, which runs first), then `obj_loss_bwd`
(the cross-entropy's backward), `loss_bwd` (the
photometric backward and the untiling's), `composite_bwd`
(the backward kernel and the background's gradient), `segsum` (pair rows
to Gaussians), `project_bwd` (the packed geometry's, projection's and SH
backward), `update` (densify statistics, learning rates, Adam, the step's
metrics); then, once a dispatch, `carry` (a graph's copy of its new carry
into its buffers) and `between` (from the end of a dispatch to the next
one: the runner's copies in, and idle).

`recording()` lists the phases asked for, markers launched or not.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Iterator, List

import torch

from ..ops import kernels

PHASES = ("project", "bin", "composite", "loss", "feat_loss", "feat_loss_bwd", "obj_loss",
          "reg3d", "reg3d_bwd", "obj_loss_bwd", "loss_bwd", "composite_bwd", "segsum",
          "project_bwd", "update", "carry", "between")
_INDEX = {name: i for i, name in enumerate(PHASES)}
_SIGNATURES = {"sgt_phase": (ctypes.c_int, ctypes.c_void_p)}
_NULL = contextlib.nullcontext()
_recorders: List[List[str]] = []


@contextlib.contextmanager
def recording() -> Iterator[List[str]]:
    """Yields a list that receives the name of every phase() call made
    inside the block, from any thread, in call order."""
    names: List[str] = []
    _recorders.append(names)
    try:
        yield names
    finally:
        _recorders.remove(names)


def phase(name: str, device: torch.device) -> None:
    """Open phase `name` on `device`'s current stream (see the module
    docstring for when a marker is launched)."""
    which = _INDEX[name]
    for names in _recorders:
        names.append(name)
    if device.type != "cuda":
        return
    if not (torch.cuda.is_current_stream_capturing() or torch.autograd._profiler_enabled()):
        return
    lib = kernels.load("phase", _SIGNATURES)
    with kernels.on_device(device):
        err = lib.sgt_phase(which, kernels.current_stream(device))
    kernels.check(lib, err, f"sgt_phase_{name}")


class _BackwardPhase(torch.autograd.Function):
    """The identity; its backward opens a phase."""

    @staticmethod
    def forward(ctx, x, name):
        ctx.name = name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        phase(ctx.name, g.device)
        return g, None


def phase_in_backward(x: torch.Tensor, name: str) -> torch.Tensor:
    """`x` as it is, whose gradient opens phase `name` where the backward
    reaches it (autograd runs the nodes made last first)."""
    return _BackwardPhase.apply(x, name)


def span(name: str):
    """A host span named `name` while a profiler records, else a no-op."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL


def spanned(name: str):
    """Decorate a function so that each call runs inside span(name)."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return call

    return wrap
