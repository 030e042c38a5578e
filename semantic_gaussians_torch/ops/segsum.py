"""Contiguous segment sum: the reduction of the pair-gather's backward.

Port of semantic_gaussians_tpu.ops.segsum (`segsum_contiguous`, whose two
TPU kernels differ only in where VMEM keeps the accumulator).
`segsum_contiguous` launches the CUDA kernel (csrc/segsum.cu) for CUDA
tensors and runs the plain torch version, `segsum_contiguous_plain`, for
CPU tensors.

The JAX package lays the cotangent out as (D, P), pairs on the TPU's
128-wide lanes. Here it is [P, D], rows per pair: the composite backward
writes each pair's row contiguously, a segment is then a contiguous block
of rows, and the kernel's neighbouring threads read neighbouring floats.
The owners must be non-decreasing (generation-order pair owners).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import kernels

LAUNCHES = kernels.LaunchCounter("segsum")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"sgt_segsum": (_P, _P, _P, _I, _I, _I, _P, _P)}


def segsum_contiguous_plain(
    cot: torch.Tensor, owners: torch.Tensor, num_rows: int,
    limit: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain torch version of `segsum_contiguous` (rows added in row order)."""
    if limit is not None:
        n = int(limit)
        cot, owners = cot[:n], owners[:n]
    out = torch.zeros((num_rows, cot.shape[1]), dtype=torch.float32, device=cot.device)
    return out.index_add_(0, owners.long(), cot.to(torch.float32))


def _segsum_cuda(cot, owners, num_rows, limit):
    dev = cot.device
    if cot.dtype != torch.float32 or cot.dim() != 2 or not cot.is_contiguous():
        raise ValueError(f"cot: expected contiguous float32 [P, D], got {cot.dtype} "
                         f"{tuple(cot.shape)}")
    p, d = cot.shape
    if owners.dtype != torch.int32 or owners.shape != (p,) or not owners.is_contiguous():
        raise ValueError(f"owners: expected contiguous int32 [{p}]")
    if limit is not None and (limit.dtype != torch.int32 or limit.numel() != 1):
        raise ValueError("limit: expected an int32 scalar")
    if any(t.device != dev for t in (owners,) + (() if limit is None else (limit,))):
        raise ValueError("segsum_contiguous: all tensors must be on one device")
    out = torch.empty((num_rows, d), dtype=torch.float32, device=dev)
    lib = kernels.load("segsum", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sgt_segsum(
            cot.data_ptr(), owners.data_ptr(), None if limit is None else limit.data_ptr(),
            p, d, num_rows, out.data_ptr(), stream,
        )
    kernels.check(lib, err, "sgt_segsum")
    LAUNCHES.add()
    return out


def segsum_contiguous(
    cot: torch.Tensor,  # [P, D] float32
    owners: torch.Tensor,  # [P] int32, non-decreasing
    num_rows: int,  # output rows (every owner < num_rows)
    limit: Optional[torch.Tensor] = None,  # [] int32: rows >= limit count as zero
) -> torch.Tensor:
    """out[g] = sum of the rows of `cot` whose owner is g: [num_rows, D].
    Deterministic: each output element is summed in row order by one
    thread. CUDA tensors launch the kernel; CPU tensors take the plain
    version."""
    fn = {"cuda": _segsum_cuda, "cpu": segsum_contiguous_plain}.get(cot.device.type)
    if fn is None:
        raise ValueError(f"segsum_contiguous: unsupported device {cot.device}")
    return fn(cot, owners, num_rows, limit)
