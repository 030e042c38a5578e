"""The shard_map collectives, as functions of (tensor, mesh, axis).

Each runs over the process group of one mesh axis (parallel.mesh) and is
called by every rank of that group in the same order, as the JAX package's
collectives are traced into one program:
  psum / pmean / pmax   all-reduce (sum, sum / size, max)
  psum_scatter          reduce-scatter of rows: this rank keeps rows
                        [coord * n / size, (coord + 1) * n / size)
  all_gather            rows of every rank, in coordinate order
  gather_bands          all_gather whose backward hands this rank its own
                        rows of the cotangent (the transpose of JAX's
                        all_gather when every rank computes the same loss
                        from the gathered tensor)
The functional ones return new tensors. An axis without a process group
(a one-rank mesh of a process that no launcher started) hands back its
input.

The gloo backend, which runs the CPU ranks and ranks that share one card,
takes host tensors: for a CUDA tensor on a gloo group the tensor is staged
through the host here, chosen from the group's backend. Staging is the only
difference between the backends: both run the same collective calls.

Every call adds the bytes of the tensor it hands to the collective to the
mesh's `comm_bytes` under the operation's name.
"""
from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.distributed as dist

SUM, MAX = dist.ReduceOp.SUM, dist.ReduceOp.MAX


def _staged(group, t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _run(collective, out: torch.Tensor, src: torch.Tensor, group) -> torch.Tensor:
    """collective(out, src) on the group, through host copies of both when
    the group cannot take the device's tensors (gloo with CUDA tensors)."""
    if not _staged(group, src):
        collective(out, src)
        return out
    host_src = src.cpu()
    host_out = host_src if src is out else torch.empty_like(out, device="cpu")
    collective(host_out, host_src)
    return out.copy_(host_out)


def _all_reduce_(buf: torch.Tensor, mesh, axis: str, op) -> torch.Tensor:
    """All-reduce `buf` in place over the axis."""
    group = mesh.group(axis)
    if group is None:
        return buf
    mesh.count("all_reduce", buf.numel() * buf.element_size())
    return _run(lambda out, _: dist.all_reduce(out, op=op, group=group), buf, buf, group)


def psum(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return _all_reduce_(t.detach().clone(), mesh, axis, SUM)


def pmean(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return psum(t, mesh, axis) / mesh.size(axis)


def pmax(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return _all_reduce_(t.detach().clone(), mesh, axis, MAX)


def flat_rows(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Tensors with a common leading dim n -> one [n, D] float32 matrix
    (each flattened to [n, D_i], side by side)."""
    n = tensors[0].shape[0]
    return torch.cat([t.reshape(n, -1).to(torch.float32) for t in tensors], dim=1)


def split_rows(flat: torch.Tensor, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The inverse of flat_rows, for `flat`'s own row count."""
    n = flat.shape[0]
    widths = [math.prod(t.shape[1:]) for t in like]
    parts = torch.split(flat, widths, dim=1)
    return [p.reshape((n,) + tuple(t.shape[1:])) for p, t in zip(parts, like)]


def psum_many(tensors: Sequence[torch.Tensor], mesh, axes) -> List[torch.Tensor]:
    """psum of several tensors with one leading dim, in one all-reduce per
    axis of `axes` (a name or a sequence of names, summed in turn)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    flat = flat_rows(tensors)
    for axis in axes:
        _all_reduce_(flat, mesh, axis, SUM)
    return split_rows(flat, tensors)


def psum_scatter(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Reduce-scatter of the rows of `t` [n, ...] (n divisible by the axis
    size): the sum over the axis of this rank's n / size rows."""
    group = mesh.group(axis)
    size = mesh.size(axis)
    if t.shape[0] % size:
        raise ValueError(f"{t.shape[0]} rows do not divide over {size} ranks")
    blk = t.shape[0] // size
    if group is None:
        return t.detach().clone()
    mesh.count("reduce_scatter", t.numel() * t.element_size())
    out = torch.empty((blk,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    return _run(lambda o, src: dist.reduce_scatter_tensor(o, src, op=SUM, group=group), out,
                t.detach().contiguous(), group)


def all_gather(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Rows of every rank of the axis, concatenated in coordinate order."""
    group = mesh.group(axis)
    if group is None:
        return t.detach().clone()
    size = mesh.size(axis)
    mesh.count("all_gather", t.numel() * t.element_size())
    out = torch.empty((size * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    return _run(lambda o, src: dist.all_gather_into_tensor(o, src, group=group), out,
                t.detach().contiguous(), group)


def broadcast(t: torch.Tensor, mesh) -> torch.Tensor:
    """The world's rank-0 copy of `t`, on every rank."""
    if all(g is None for g in mesh.groups):
        return t.detach().clone()
    mesh.count("broadcast", t.numel() * t.element_size())
    buf = t.detach().clone()
    return _run(lambda out, _: dist.broadcast(out, src=0), buf, buf, None)


class _GatherBands(torch.autograd.Function):
    """all_gather forward; the backward keeps this rank's rows of the
    cotangent. Every rank computes the same loss from the gathered tensor,
    so each holds the same full cotangent and its own rows are exactly its
    band's share (no collective in the backward)."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.rows, ctx.start = t.shape[0], mesh.coord(axis) * t.shape[0]
        return all_gather(t, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.start:ctx.start + ctx.rows], None, None


def gather_bands(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return _GatherBands.apply(t, mesh, axis)


class _Replicated(torch.autograd.Function):
    """Identity forward over tensors every rank holds alike; the backward
    sums their cotangents over the axis in one all-reduce, as shard_map's
    transpose does for a replicated (P()) input."""

    @staticmethod
    def forward(ctx, mesh, axis, *xs):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.shapes = [x.shape for x in xs]
        ctx.dtypes = [x.dtype for x in xs]
        ctx.device = xs[0].device
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        flat = torch.cat([
            (torch.zeros(shape, device=ctx.device) if g is None else g).reshape(-1)
            .to(torch.float32)
            for g, shape in zip(grads, ctx.shapes)
        ])
        _all_reduce_(flat, ctx.mesh, ctx.axis, SUM)
        sizes = [shape.numel() for shape in ctx.shapes]
        out = [part.reshape(shape).to(dtype) for part, shape, dtype in
               zip(torch.split(flat, sizes), ctx.shapes, ctx.dtypes)]
        return (None, None, *out)


def replicated(tensors: Sequence, mesh, axis: str) -> list:
    """`tensors` (None allowed) as replicated inputs of the axis: the same
    values, whose gradients come out summed over the axis. Without
    autograd, or with no tensor that needs a gradient, they pass through."""
    need = [i for i, t in enumerate(tensors) if t is not None and t.requires_grad]
    out = list(tensors)
    if need and torch.is_grad_enabled():
        for i, t in zip(need, _Replicated.apply(mesh, axis, *[tensors[i] for i in need])):
            out[i] = t
    return out
