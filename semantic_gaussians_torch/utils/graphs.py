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
the runner owns, warms up on a side stream by running the body once on the
carry's buffers and then copying the carry into them again (so that the
warm-up advances no state: training state, fusion accumulators and
confusion sums are untouched by it), captures one call of the body into a
`torch.cuda.CUDAGraph`, whose last act copies the new carry into the
carry's buffers, and replays it. Later calls copy their carry (where it is
not already the buffers) and inputs into the buffers and replay. Graphs
whose carries have the same names, shapes and types share one set of
buffers. The carry returned is the buffers themselves: hand it back to the
next call and nothing is copied; it is overwritten by the next replay of a
graph that shares them. Outputs are cloned out of the graph's pool.
Captures that a caller gives one `warm_key` run the same step and differ
only in how many of them (train_scan_step gives every train chunk the key
of its statics without K): the first warms up, the others find every
lazily made resource made already and skip the warm-up. The body's end is
marked for a profiler's trace (utils.tracing): phase `carry`
before the carry's copy, `between` after it, captured into the graph so
that every replay shows where its dispatch ends.

All graphs of a runner share one memory pool: they never run at once, and
what outlives a replay is in buffers outside the pool (the carry) or
cloned out of it (the outputs), so a later capture may reuse what an
earlier graph only needs while it runs. Once `drop` has forgotten every
graph, the next capture opens a new pool. The allocator's cache is emptied
between the warm-up and the capture, so that the capture can take the
memory the warm-up left cached (a feature field's steps need tens of GB).

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
from . import tracing

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
        self._pool = None  # the graphs' shared memory pool, made at the first capture
        self._carries: Dict[tuple, Tensors] = {}  # carry buffers, by the carry's signature
        self._warmed: set = set()  # warm keys whose first capture warmed up
        self.captures = 0
        self.replays = 0

    def drop(self, stale: Callable[[Hashable], bool]) -> None:
        """Forget the graphs whose key cannot recur (and their memory)."""
        for key in [k for k in self._graphs if stale(k[0])]:
            del self._graphs[key]
        used = {k[1] for k in self._graphs}
        for sig in [s for s in self._carries if s not in used]:
            del self._carries[sig]
        if not self._graphs:  # a pool that outlived its graphs cannot be shared again
            self._pool = None

    def run(self, key: Hashable, body: Body, carry: Tensors, inputs: Inputs,
            warm_key: Hashable = None):
        """body(carry, inputs) -> (new carry, outputs); see the module
        docstring for what a CUDA device does with it. Captures that share
        a `warm_key` warm up once; None warms up every capture."""
        if self.device.type != "cuda":
            out = body(carry, {k: _stacked(v) for k, v in inputs.items()})
            tracing.phase("carry", self.device)
            tracing.phase("between", self.device)
            return out
        key = (key, _signature(carry), _signature(inputs))
        entry = self._graphs.get(key)
        if entry is None:
            with tracing.span("sgt.graph.capture"):
                entry = self._graphs[key] = self._capture(body, carry, inputs, key[1], warm_key)
        else:
            with tracing.span("sgt.graph.fill"):
                for k, v in carry.items():
                    _fill(entry.carry[k], v)
                for k, v in inputs.items():
                    _fill(entry.inputs[k], v)
        with tracing.span("sgt.graph.replay"):
            entry.graph.replay()
            self.replays += 1
            for counter, gain in entry.gains:
                counter.add_gain(gain)
            return dict(entry.carry), {k: v.clone() for k, v in entry.outputs.items()}

    def _capture(self, body: Body, carry: Tensors, inputs: Inputs, sig: tuple,
                 warm_key: Hashable) -> _Captured:
        dev = self.device
        static_carry = self._carries.get(sig)
        if static_carry is None:
            static_carry = self._carries[sig] = {k: v.detach().clone() for k, v in carry.items()}
        else:
            for k, v in carry.items():
                _fill(static_carry[k], v)
        static_in = {k: _empty_like_input(v, dev) for k, v in inputs.items()}
        for k, v in inputs.items():
            _fill(static_in[k], v)
        if warm_key is None or warm_key not in self._warmed:
            # Warm-up on a side stream: it claims every lazily made resource
            # (kernel libraries, the segment sum's scratch, shared-memory
            # opt-ins, library handles) outside the capture. It runs on the
            # carry's buffers, which are then filled again, or on copies
            # where the carry handed in is the buffers.
            own = any(carry[k] is static_carry[k] for k in carry)
            warm = {k: v.clone() for k, v in static_carry.items()} if own else static_carry
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                body(warm, static_in)
            torch.cuda.current_stream(dev).wait_stream(side)
            del warm
            if not own:
                for k, v in carry.items():
                    _fill(static_carry[k], v)
            self._warmed.add(warm_key)
            with torch.cuda.device(dev):
                torch.cuda.empty_cache()

        graph = torch.cuda.CUDAGraph()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        before = [(c, c.snapshot()) for c in kernels.COUNTERS]
        with torch.cuda.graph(graph, pool=self._pool):
            new_carry, outputs = body(static_carry, static_in)
            tracing.phase("carry", dev)
            for k, v in new_carry.items():
                static_carry[k].copy_(v)
            tracing.phase("between", dev)
        gains = []
        for counter, snap in before:
            gain = counter.since(snap)
            if gain[0] or gain[1]:
                counter.add_gain(gain, -1)  # the capture launched nothing
                gains.append((counter, gain))
        self.captures += 1
        return _Captured(graph, static_carry, static_in, dict(outputs), gains)
