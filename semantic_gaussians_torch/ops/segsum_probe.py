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
tensors. The fold kernel is bound by bytes, so a block (one group of
consecutive chunks a multiprocessor) keeps its accumulator in shared
memory, streams the chunks through a cp.async ring, sums runs of equal
owners by walking the rows in order, and writes to device memory only the
128-row blocks it touched; a second kernel adds the groups' blocks in group
order. No float atomics: rows in order within a slice of a chunk, slices
within a chunk, chunks within a group, groups in order. The kernel takes
1 <= D <= MAX_D (`shared_memory_plan`). The per-chunk scalars are computed in plain torch outside the
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
BLK = 128  # panel rows per accumulator block of the kernel, and per mask bit
THREADS = 512  # of a block of the fold kernel
SMEM_BYTES = 232_448  # shared memory a block can use on an H100 (227 KB)
MAX_D = 27  # widest row whose 8 accumulator blocks and two chunks fit in SMEM_BYTES

# One count per mode; a call launches two kernels (fold, reduce) and counts
# both.
LAUNCHES = {m: kernels.LaunchCounter(f"segsum_probe_{m}") for m in MODES}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"sgt_segsum_probe": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                    _P, _P, _P, _P)}


def chunk_groups(n_chunks: int, max_groups: int) -> Tuple[int, int]:
    """(groups, chunks per group): consecutive chunks are dealt out to at
    most `max_groups` blocks, every block but the last taking the same
    number; the last takes what is left (at least one chunk)."""
    per_block = -(-n_chunks // min(n_chunks, max_groups))
    return -(-n_chunks // per_block), per_block


def shared_memory_plan(d: int) -> Tuple[int, int]:
    """(stages, acc_blocks) of the fold kernel for rows of `d` floats: how
    many 512-row chunks of the stream (2 to 4) and how many 128-row blocks
    of the accumulator (a power of two) a block holds in SMEM_BYTES of
    shared memory, mirroring the layout of csrc/segsum_probe.cu. As many
    stages as leave room for an accumulator of 8 blocks: a window (WIN rows
    at any 128-row offset: 6 blocks) rounded up to a power of two. Raises
    for d > MAX_D, whose window does not fit beside two chunks."""
    if 1 <= d <= MAX_D:
        v = 1 if d % 4 else 4  # channels a walking thread carries
        want = min(THREADS // (d // v), CHUNK // 8)
        srows = -(-CHUNK // want)
        slices = -(-CHUNK // srows)
        span = srows * d
        sstride = span if span % 4 else span + ((d + 3) // 4 * 4 - span) % 32
        stage = ((slices * sstride + 3) // 4 * 4 + CHUNK) * 4
        fixed = (2 * slices * d + 3 * slices + 4) * 4
        for stages in (4, 3, 2):
            blocks = (SMEM_BYTES - fixed - stages * stage) // (BLK * d * 4)
            if blocks >= 8:
                return stages, min(1 << (blocks.bit_length() - 1), PANEL // BLK)
    raise ValueError(f"segsum_probe: D = {d} does not fit a block's shared memory "
                     f"(the kernel takes 1 <= D <= {MAX_D})")


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
    if cot.data_ptr() % 16 or owners.data_ptr() % 16:
        raise ValueError("segsum_probe: cot and owners must be 16-byte aligned")
    stages, acc_blocks = shared_memory_plan(d)
    base, off = probe_scalars(owners, mode)
    n_chunks = p // CHUNK
    dev = cot.device
    # one group a multiprocessor: a block fills an SM's shared memory
    groups, per_block = chunk_groups(n_chunks, kernels.multiprocessors(dev))
    partial = torch.empty((groups, PANEL, d), dtype=torch.float32, device=dev)
    masks = torch.empty(groups, dtype=torch.int32, device=dev)
    out = torch.empty((PANEL, d), dtype=torch.float32, device=dev)
    lib = kernels.load("segsum_probe", _SIGNATURES)
    with kernels.on_device(dev):
        err = lib.sgt_segsum_probe(
            cot.data_ptr(), owners.data_ptr(), base.data_ptr(),
            None if mode == "fold" else off.data_ptr(), n_chunks, d, WIN, PANEL, groups,
            per_block, stages, acc_blocks, partial.data_ptr(), masks.data_ptr(),
            out.data_ptr(), kernels.current_stream(dev),
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
