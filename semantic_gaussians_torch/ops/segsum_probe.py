"""Segment-sum cost probe: the windowed chunk fold of the segment-sum
experiments.

Port of the two probe kernels of the JAX package's tools
(tools/exp_panel.py::_k_noslide and tools/exp_panel2.py::kern_a, one
function with one switch). With CHUNK = 512, WIN = 640, PANEL = 4096 and
STRIDE = PANEL - WIN (the port's own copy of the JAX segment sum's
constants), for chunk c of 512 consecutive pairs:

  base_c = 128 * (owners[512 c] // 128)
  off_c  = 0                                  (mode "fold")
         = 128 * (base_blk_c - pb_blk_c)      (mode "window"; pb_blk is the
           STRIDE-quantised panel base of the rolling-panel segment sum)
  out[off_c + j, :] += sum_i cot[i, :] * [owners[i] - base_c == j],  0 <= j < WIN

summed over all chunks into one [PANEL, D] panel. The result is not a
segment sum: it is a probe that reads and folds the whole cotangent stream,
whose time is the per-chunk cost of a windowed accumulate.

`segsum_probe` launches the CUDA kernels (csrc/segsum_probe.cu) for CUDA
tensors and runs the plain torch version, `segsum_probe_plain`, for CPU
tensors. The per-chunk scalars are computed in plain torch outside the
kernel, as the JAX tools compute them outside theirs. Layout: cot is
[P, D], rows per pair (see ops/segsum.py), the output [PANEL, D].
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import kernels

CHUNK = 512
WIN = CHUNK + 128  # output window rows per chunk
PANEL = 4096  # panel rows (a multiple of 128)
STRIDE = PANEL - WIN
MODES = ("fold", "window")
# Chunk groups (blocks) of the first kernel: four per SM of an H100. Each
# group owns a [PANEL, D] partial panel in scratch memory, so more groups
# hide more of the fold's load latency but zero and reduce more scratch; on
# an H100 the time is flat between four and eight per SM and rises outside.
MAX_GROUPS = 4 * 132

# One count per mode; a call launches two kernels (partial panels, reduce)
# and counts both.
LAUNCHES = {m: kernels.LaunchCounter(f"segsum_probe_{m}") for m in MODES}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"sgt_segsum_probe": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P)}


def probe_scalars(owners: torch.Tensor, mode: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-chunk (base, off) int32 rows: the window base of each chunk and
    its offset inside the panel (0 in fold mode)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}: expected one of {MODES}")
    base_blk = torch.div(owners[::CHUNK], 128, rounding_mode="floor")
    if mode == "fold":
        return (base_blk * 128).to(torch.int32), torch.zeros_like(base_blk, dtype=torch.int32)
    blk_w, blk_p, blk_s = WIN // 128, PANEL // 128, STRIDE // 128
    need = base_blk + blk_w - blk_p
    # STRIDE-quantised ceil of (window end - PANEL), never negative
    pb_blk = torch.clamp(-torch.div(-need, blk_s, rounding_mode="floor"), min=0) * blk_s
    return (base_blk * 128).to(torch.int32), ((base_blk - pb_blk) * 128).to(torch.int32)


def _check(cot: torch.Tensor, owners: torch.Tensor) -> Tuple[int, int]:
    if cot.dtype != torch.float32 or cot.dim() != 2 or not cot.is_contiguous():
        raise ValueError(f"cot: expected contiguous float32 [P, D], got {cot.dtype} "
                         f"{tuple(cot.shape)}")
    p, d = cot.shape
    if p == 0 or p % CHUNK:
        raise ValueError(f"cot: P = {p} must be a positive multiple of {CHUNK}")
    if owners.dtype != torch.int32 or owners.shape != (p,) or not owners.is_contiguous():
        raise ValueError(f"owners: expected contiguous int32 [{p}]")
    if owners.device != cot.device:
        raise ValueError("segsum_probe: all tensors must be on one device")
    return p, d


def segsum_probe_plain(
    cot: torch.Tensor, owners: torch.Tensor, mode: str, acc_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Plain torch version of `segsum_probe`: each pair's target row
    off_c + owners - base_c, then one scatter-add of the rows whose column
    falls in the window. `acc_dtype=torch.float64` sums in double, for a
    reference whose own rounding does not show."""
    _check(cot, owners)
    base, off = probe_scalars(owners, mode)
    col = owners - base.repeat_interleave(CHUNK)
    row = (off.repeat_interleave(CHUNK) + col).long()
    keep = (col >= 0) & (col < WIN)
    out = torch.zeros((PANEL, cot.shape[1]), dtype=acc_dtype, device=cot.device)
    return out.index_add_(0, row[keep], cot[keep].to(acc_dtype))


def _segsum_probe_cuda(cot, owners, mode):
    p, d = _check(cot, owners)
    base, off = probe_scalars(owners, mode)
    n_chunks = p // CHUNK
    per_block = -(-n_chunks // min(n_chunks, MAX_GROUPS))
    groups = -(-n_chunks // per_block)
    dev = cot.device
    partial = torch.empty((groups, PANEL, d), dtype=torch.float32, device=dev)
    out = torch.empty((PANEL, d), dtype=torch.float32, device=dev)
    lib = kernels.load("segsum_probe", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sgt_segsum_probe(
            cot.data_ptr(), owners.data_ptr(), base.data_ptr(),
            None if mode == "fold" else off.data_ptr(), n_chunks, d, WIN, PANEL, groups,
            per_block, partial.data_ptr(), out.data_ptr(), stream,
        )
    kernels.check(lib, err, "sgt_segsum_probe")
    LAUNCHES[mode].add(2)
    return out


def segsum_probe(
    cot: torch.Tensor,  # [P, D] float32, P a multiple of CHUNK
    owners: torch.Tensor,  # [P] int32
    mode: str,  # "fold" | "window"
) -> torch.Tensor:
    """The windowed chunk fold of the whole stream: [PANEL, D] float32 (see
    the module docstring). Deterministic: no float atomics, so two runs
    give the same bits. CUDA tensors launch the kernels; CPU tensors take
    the plain version."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}: expected one of {MODES}")
    fn = {"cuda": _segsum_probe_cuda, "cpu": segsum_probe_plain}.get(cot.device.type)
    if fn is None:
        raise ValueError(f"segsum_probe: unsupported device {cot.device}")
    return fn(cot, owners, mode)
