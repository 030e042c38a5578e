"""Contiguous segment sum: the reduction of the pair-gather's backward.

Port of semantic_gaussians_tpu.ops.segsum (`segsum_contiguous`, whose two
TPU kernels differ only in where VMEM keeps the accumulator).
`segsum_contiguous` launches the CUDA kernel (csrc/segsum.cu) for CUDA
tensors and runs the plain torch version, `segsum_contiguous_plain`, for
CPU tensors.

The kernel is bound by bytes (every live row read once, every output row
written once), so it hands the work out by input rows, not by segments: a
block takes tiles of `rows` consecutive rows by a panel of `cw` columns
(`tile_shape`), copies each into shared memory, and sums runs of equal
owners in row order. Runs inside a tile are written by that tile; a tile's
first and last runs go to a carry buffer. The tile that sees a run end
reads the carries of the few tiles before it and writes the run (most runs
are short); where a run spans more tiles than that, the same kernel reduces
all carries level by level until one tile is left, so a segment of any
length is summed by a tree of fixed shape (rows within a slice, slices
within a tile, tiles within a tile of carries). No float atomics: the result
depends on the data alone, not on block scheduling, and two runs give the
same bits.

The JAX package lays the cotangent out as (D, P), pairs on the TPU's
128-wide lanes. Here it is [P, D], rows per pair: the composite backward
writes each pair's row contiguously, a segment is then a contiguous block
of rows, and the kernel's neighbouring threads read neighbouring floats.
The owners must be non-decreasing (generation-order pair owners).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from . import kernels

LAUNCHES = kernels.LaunchCounter("segsum")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "sgt_segsum": (_P, _P, _P) + (_I,) * 9 + (_P, _L, _P, _P, _L, _P, _P),
}

THREADS = 256  # of a block of csrc/segsum.cu
MAX_PANEL = 128  # widest column panel of a tile
TILE_FLOATS = 8192  # floats of a tile in shared memory as a rule (32 KB)
GROWN_FLOATS = 12288  # floats of a tile grown to save a launch
BASE_ROWS, MAX_ROWS = 512, 1024  # a tile's rows: as a rule at most, and when grown
INLINE_ITEMS = 4  # a level of this many tiles or fewer runs inside the launch before it
MAX_HOPS = 8  # tiles the kernel's look-back goes back (MAX_HOPS of csrc/segsum.cu)


def _pow2_floor(x: int) -> int:
    return 1 << (x.bit_length() - 1)


class _Kept:
    """What the kernel keeps between calls on one device (csrc/segsum.cu):
    the carries' scratch; one int32 that is 0 between calls, the ticket that
    the blocks of a launch draw to find the one that finishes last; and the
    flags, 64-bit words (zeros at first): the call's epoch, which the kernel
    raises on the device before each call's first level, then the
    look-back's tags, one for the call and two a first-level tile, whose
    upper halves hold epochs of earlier calls. Nothing of it is decided on
    the host, so a CUDA graph may capture a call and replay it.

    Scratch and flags grow when a call needs more, never while a graph is
    being captured (the new tensors would come from the graph's private pool
    and replace these): the sizes are claimed by a call before the capture,
    and a growth inside one raises. Tensors that a captured graph uses are
    kept alive when they are grown out. Calls on one device must not
    overlap on two streams."""

    def __init__(self, device: torch.device):
        self.device = device
        self.scratch = torch.empty(4, dtype=torch.float32, device=device)
        self.ticket = torch.zeros(1, dtype=torch.int32, device=device)
        self.flags = torch.zeros(2, dtype=torch.int64, device=device)
        self.in_graph = False  # whether a captured graph uses scratch and flags
        self.retired: list = []  # grown-out tensors that a captured graph uses

    def claim(self, scratch_floats: int, tiles: int) -> "_Kept":
        grow_scratch = self.scratch.numel() < scratch_floats
        grow_flags = self.flags.numel() < 2 + 2 * tiles
        capturing = torch.cuda.is_current_stream_capturing()
        if (grow_scratch or grow_flags) and capturing:
            raise RuntimeError(
                "segsum_contiguous: its scratch would grow inside a CUDA graph capture; "
                "call it once at the captured shapes before capturing")
        if (grow_scratch or grow_flags) and self.in_graph:
            self.retired.append((self.scratch, self.flags))
            self.in_graph = False
        if grow_scratch:
            self.scratch = torch.empty(scratch_floats, dtype=torch.float32, device=self.device)
        if grow_flags:
            self.flags = torch.zeros(2 + 2 * tiles, dtype=torch.int64, device=self.device)
        self.in_graph |= capturing
        return self


_KEPT: Dict[torch.device, _Kept] = {}


@functools.lru_cache(maxsize=256)
def tile_shape(d: int, p: int = 0) -> Tuple[int, int, int]:
    """(cw, rows, slices) of the kernel's tiles for a stream of `p` rows of
    `d` floats: the columns of a panel (all of them up to MAX_PANEL, else
    equal panels of a multiple of 4), the consecutive rows of a tile and the
    slices a tile is cut into (a thread walks one slice of four columns, of
    one where cw is no multiple of 4). A slice has a multiple of 4 rows, so
    every slice starts 16-byte aligned.

    Rows: as many as TILE_FLOATS allow, at most BASE_ROWS; more, up to
    MAX_ROWS and GROWN_FLOATS, where the carries of the first level then
    come to INLINE_ITEMS tiles or fewer, so that the whole sum is one launch
    (a launch costs more than a small stream's sum)."""
    panels = -(-d // MAX_PANEL)
    cw = d if panels == 1 else (-(-d // panels) + 3) // 4 * 4
    groups = cw if cw % 4 else cw // 4  # a walking thread carries 4 columns where it can
    base = rows = min(BASE_ROWS, _pow2_floor(TILE_FLOATS // cw))
    slices = min(64, _pow2_floor(THREADS // groups), base // 4)

    def carry_tiles(rows):  # tiles of level 1, all panels
        tiles = -(-p // rows)
        return -(-2 * tiles // rows) * panels if tiles > 1 else 0

    while carry_tiles(rows) > INLINE_ITEMS and 2 * rows <= min(MAX_ROWS, GROWN_FLOATS // cw):
        rows *= 2
    return cw, rows if carry_tiles(rows) <= INLINE_ITEMS else base, slices


@functools.lru_cache(maxsize=64)
def _scratch_floats(p: int, d: int, rows: int) -> int:
    """Floats of carry scratch over all levels (two carries a tile, values
    then owners, each padded to 16 bytes), as csrc/segsum.cu lays them out."""
    total, n = 0, p
    while n > rows:
        tiles = -(-n // rows)
        total += (2 * tiles * d + 3) // 4 * 4 + (2 * tiles + 3) // 4 * 4
        n = 2 * tiles
    return total


def segsum_contiguous_plain(
    cot: torch.Tensor, owners: torch.Tensor, num_rows: int,
    limit: Optional[torch.Tensor] = None, acc_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain torch version of `segsum_contiguous`: one `index_add_` of the
    live rows onto their owners. `acc_dtype=torch.float64` sums in double,
    for a reference whose own rounding does not show."""
    if limit is not None:
        n = int(limit)
        cot, owners = cot[:n], owners[:n]
    out = torch.zeros((num_rows, cot.shape[1]), dtype=acc_dtype, device=cot.device)
    return out.index_add_(0, owners.long(), cot.to(acc_dtype))


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
    if owners.device != dev or (limit is not None and limit.device != dev):
        raise ValueError("segsum_contiguous: all tensors must be on one device")
    out = torch.empty((num_rows, d), dtype=torch.float32, device=dev)
    if d == 0 or num_rows == 0:
        return out
    cw, rows, slices = tile_shape(d, p)
    # floats per copy: 16 bytes where every copied piece starts aligned (a
    # one-panel tile is one contiguous span, so any d does), else 8 or 4
    vec = 4 if cw == d or d % 4 == 0 else 2 if d % 2 == 0 else 1
    while cot.data_ptr() % (4 * vec):
        vec //= 2
    ovec = 1 if owners.data_ptr() % 16 else 4
    n_scratch = _scratch_floats(p, d, rows)
    kept = _KEPT.get(dev)
    if kept is None:
        kept = _KEPT[dev] = _Kept(dev)
    tiles = max(1, -(-p // rows)) * -(-d // cw)
    kept.claim(n_scratch, tiles)
    lib = kernels.load("segsum", _SIGNATURES)
    with kernels.on_device(dev):
        err = lib.sgt_segsum(
            cot.data_ptr(), owners.data_ptr(), None if limit is None else limit.data_ptr(),
            p, d, num_rows, cw, rows, slices, vec, ovec, INLINE_ITEMS,
            kept.scratch.data_ptr(), n_scratch, kept.ticket.data_ptr(), kept.flags.data_ptr(),
            kept.flags.numel(), out.data_ptr(), kernels.current_stream(dev),
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
    """out[g] = sum of the rows of `cot` whose owner is g: [num_rows, D];
    rows that no pair owns are exactly zero. Deterministic: each segment is
    summed by a tree whose shape depends only on P and D (see the module
    docstring). CUDA tensors launch the kernel (one launch a level or fewer;
    the count goes up by one a call); CPU tensors take the plain version."""
    fn = {"cuda": _segsum_cuda, "cpu": segsum_contiguous_plain}.get(cot.device.type)
    if fn is None:
        raise ValueError(f"segsum_contiguous: unsupported device {cot.device}")
    return fn(cot, owners, num_rows, limit)
