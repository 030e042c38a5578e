"""CUDA-graph replays of a chunk of dependent steps.

The PyTorch counterpart of the JAX package's multi-step dispatch (its
`lax.scan` over K stacked cameras or views in one jitted call:
pipelines/train.py `train_scan_step`, eval_segmentation.py `_eval_chunk`,
fusion.py `_fuse_chunk`). Eager PyTorch pays the host's launch of every
small kernel, hundreds a training step; one replay of a graph that captured
K steps launches them all at once.

`GraphRunner.run(key, body, carry, inputs)` computes `body(carry, inputs)`,
where `body` runs the K steps of a chunk and returns (new carry, outputs),
all dicts of tensors. On a CUDA device the first call for a `key` (the
statics that make the JAX package recompile: K, shapes, the pair budget,
the SH degree, ...) copies `carry` and `inputs` into static buffers that
the runner owns, warms up on a side stream by running the body once on
copies of the carry (so that the warm-up advances no state: training state,
fusion accumulators and confusion sums are untouched by it), captures one
call of the body into a `torch.cuda.CUDAGraph`, whose last act copies the
new carry into the carry's buffers, and replays it. Later calls copy their
carry (where it is not already the buffers) and inputs into the buffers and
replay. The carry returned is the buffers themselves: hand it back to the
next call and nothing is copied; it is overwritten by the next replay of
that key's graph. Outputs are cloned out of the graph's pool.

A capture that fails raises; the runner never runs the body eagerly on a
CUDA device instead. On any other device it calls the body eagerly, step
by step: the plain version of a chunk, which the CPU tests run.

Kernel wrappers count a launch when they enqueue it (ops.kernels), and a
replay enqueues nothing on the host: the runner takes back what every
counter gained during the capture (the capture launches nothing) and adds
that gain again on every replay.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Hashable, List, Sequence, Tuple, Union

import torch

from ..ops import kernels

Tensors = Dict[str, torch.Tensor]
# An input is a tensor [K, ...], or K tensors, one a slot of the chunk.
Inputs = Dict[str, Union[torch.Tensor, Sequence[torch.Tensor]]]
Body = Callable[[Tensors, Tensors], Tuple[Tensors, Tensors]]


@dataclasses.dataclass
class _Captured:
    graph: "torch.cuda.CUDAGraph"
    carry: Tensors  # static buffers the graph reads and, at its end, writes
    inputs: Tensors  # static buffers the graph reads
    outputs: Tensors  # in the graph's pool, rewritten by each replay
    gains: List[Tuple[kernels.LaunchCounter, tuple]]  # launches counted a replay


def _stacked(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.stack(list(x))


def _fill(dst: torch.Tensor, src) -> None:
    if isinstance(src, torch.Tensor):
        if src is not dst:
            dst.copy_(src)
        return
    for j, x in enumerate(src):
        dst[j].copy_(x)


def _signature(tensors: Inputs) -> tuple:
    """Names, shapes and types: part of every key, so that a chunk of other
    shapes is captured anew."""

    def sig(x):
        if isinstance(x, torch.Tensor):
            return tuple(x.shape), x.dtype
        return (len(x),) + tuple(x[0].shape), x[0].dtype

    return tuple((k,) + sig(v) for k, v in sorted(tensors.items()))


def _empty_like_input(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return torch.empty(x.shape, dtype=x.dtype, device=device)
    return torch.empty((len(x),) + tuple(x[0].shape), dtype=x[0].dtype, device=device)


class GraphRunner:
    """Chunks of a body, replayed from CUDA graphs cached by key (see the
    module docstring). `captures` and `replays` count what it did."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._graphs: Dict[Hashable, _Captured] = {}
        self.captures = 0
        self.replays = 0

    def drop(self, stale: Callable[[Hashable], bool]) -> None:
        """Forget the graphs whose key cannot recur (and their memory)."""
        for key in [k for k in self._graphs if stale(k[0])]:
            del self._graphs[key]

    def run(self, key: Hashable, body: Body, carry: Tensors, inputs: Inputs):
        """body(carry, inputs) -> (new carry, outputs); see the module
        docstring for what a CUDA device does with it."""
        if self.device.type != "cuda":
            return body(carry, {k: _stacked(v) for k, v in inputs.items()})
        key = (key, _signature(carry), _signature(inputs))
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._graphs[key] = self._capture(body, carry, inputs)
        else:
            for k, v in carry.items():
                _fill(entry.carry[k], v)
            for k, v in inputs.items():
                _fill(entry.inputs[k], v)
        entry.graph.replay()
        self.replays += 1
        for counter, gain in entry.gains:
            counter.add_gain(gain)
        return dict(entry.carry), {k: v.clone() for k, v in entry.outputs.items()}

    def _capture(self, body: Body, carry: Tensors, inputs: Inputs) -> _Captured:
        dev = self.device
        static_carry = {k: v.detach().clone() for k, v in carry.items()}
        static_in = {k: _empty_like_input(v, dev) for k, v in inputs.items()}
        for k, v in inputs.items():
            _fill(static_in[k], v)
        # Warm-up on a side stream, on copies of the carry: it claims every
        # lazily made resource (kernel libraries, the segment sum's scratch,
        # shared-memory opt-ins, library handles) outside the capture.
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            body({k: v.clone() for k, v in static_carry.items()}, static_in)
        torch.cuda.current_stream(dev).wait_stream(side)

        graph = torch.cuda.CUDAGraph()
        before = [(c, c.snapshot()) for c in kernels.COUNTERS]
        with torch.cuda.graph(graph):
            new_carry, outputs = body(static_carry, static_in)
            for k, v in new_carry.items():
                static_carry[k].copy_(v)
        gains = []
        for counter, snap in before:
            gain = counter.since(snap)
            if gain[0] or gain[1]:
                counter.add_gain(gain, -1)  # the capture launched nothing
                gains.append((counter, gain))
        self.captures += 1
        return _Captured(graph, static_carry, static_in, dict(outputs), gains)
