"""Pair expansion: pair slot -> (tile id, gaussian id, owner rank).

Port of semantic_gaussians_tpu.ops.expand. `expand_pairs` launches the CUDA
kernel (csrc/expand.cu) for CUDA tensors and runs the plain torch version,
`expand_pairs_plain`, for CPU tensors. The plain version follows the JAX
package's XLA fallback (ops/binning.py, the `SGTPU_NO_EXPAND` branch):
owner by scatter-max + running max, tile decode by f32 divide, and the
exact tile-ellipse cull by `tile_min_qn`. All three forms agree bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import kernels

TIGHTCULL_MARGIN = 1.0 + 1e-4
# A block of csrc/expand.cu takes CHUNK consecutive pair slots,
# SLOTS_PER_THREAD a thread (mirrored there; the wrapper passes CHUNK and
# the kernel refuses another value).
SLOTS_PER_THREAD = 4
CHUNK = 256 * SLOTS_PER_THREAD
LAUNCHES = kernels.LaunchCounter("expand")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "sgt_expand_pairs": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P),
}


def tile_min_qn(lox, hix, loy, hiy, e0, e1, e2):
    """Exact min over the box [lox,hix]x[loy,hiy] of the normalized PD form
    qn(d) = e0 dx^2 + 2 e1 dx dy + e2 dy^2: 0 if the origin is inside the
    box, else the least of the four edges' clamped scalar minima. Op for op
    the JAX package's order, so the cull decision is bit-identical."""
    inside = (lox <= 0.0) & (hix >= 0.0) & (loy <= 0.0) & (hiy >= 0.0)
    e0s = torch.clamp(e0, min=1e-20)
    e2s = torch.clamp(e2, min=1e-20)

    def q(dx, dy):
        return e0 * dx * dx + 2.0 * (e1 * dx * dy) + e2 * dy * dy

    dy1 = torch.clamp(-(e1 * lox) / e2s, loy, hiy)
    dy2 = torch.clamp(-(e1 * hix) / e2s, loy, hiy)
    dx1 = torch.clamp(-(e1 * loy) / e0s, lox, hix)
    dx2 = torch.clamp(-(e1 * hiy) / e0s, lox, hix)
    qn = torch.minimum(
        torch.minimum(q(lox, dy1), q(hix, dy2)),
        torch.minimum(q(dx1, loy), q(dx2, hiy)),
    )
    return torch.where(inside, torch.zeros_like(qn), qn)


def expand_pairs_plain(
    offsets, rect_packed_d, idx_d, cull_d, num_pairs, num_dense,
    pair_budget, ntx, num_tiles, n, tile_w=32, tile_h=16,
):
    """Plain torch version of `expand_pairs` (same arguments and results)."""
    dev = offsets.device
    i32 = torch.int32
    pair_idx = torch.arange(pair_budget, dtype=i32, device=dev)
    seed = torch.full((pair_budget + 1,), -1, dtype=i32, device=dev)
    seed.scatter_reduce_(
        0, torch.clamp(offsets, max=pair_budget).long(),
        torch.arange(n, dtype=i32, device=dev), reduce="amax",
    )
    seed = seed[:pair_budget]
    g = torch.cummax(seed, 0).values
    valid = pair_idx < num_pairs
    g_safe = torch.clamp(g, 0, n - 1).long()
    off_col = torch.cummax(
        torch.where(seed >= 0, pair_idx, torch.full_like(pair_idx, -1)), 0
    ).values
    pr = rect_packed_d[g_safe]
    x0, y0, w = pr >> 16, (pr >> 8) & 255, pr & 255
    local = pair_idx - off_col
    q = torch.floor(
        torch.clamp(local, 0, 1 << 22).to(torch.float32) / w.to(torch.float32)
    ).to(i32)
    tx = x0 + (local - q * w)
    ty = y0 + q
    live = valid
    if cull_d is not None:
        cp = cull_d[:, g_safe]  # (5, P)
        lox = (tx * tile_w).to(torch.float32) - cp[0]
        hix = lox + float(tile_w - 1)
        loy = (ty * tile_h).to(torch.float32) - cp[1]
        hiy = loy + float(tile_h - 1)
        qn = tile_min_qn(lox, hix, loy, hiy, cp[2], cp[3], cp[4])
        live = valid & ~(qn > TIGHTCULL_MARGIN)
    tile = torch.where(live, ty * ntx + tx, torch.full_like(tx, num_tiles))
    g_key = torch.where(live, idx_d[g_safe], torch.full_like(tx, n))
    gen_owner = torch.where(valid, g_safe.to(i32), num_dense.to(i32))
    return tile, g_key, gen_owner


def _expand_pairs_cuda(
    offsets, rect_packed_d, idx_d, cull_d, num_pairs, num_dense,
    pair_budget, ntx, num_tiles, n, tile_w, tile_h,
):
    dev = offsets.device
    ints = (offsets, rect_packed_d, idx_d)
    for name, t in zip(("offsets", "rect_packed_d", "idx_d"), ints):
        if t.dtype != torch.int32 or t.shape != (n,) or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous int32 [{n}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    for name, t in (("num_pairs", num_pairs), ("num_dense", num_dense)):
        if t.dtype != torch.int32 or t.numel() != 1:
            raise ValueError(f"{name}: expected an int32 scalar")
    if cull_d is not None and (
        cull_d.dtype != torch.float32 or cull_d.shape != (5, n)
        or not cull_d.is_contiguous()
    ):
        raise ValueError(f"cull_d: expected contiguous float32 [5, {n}]")
    tensors = ints + (num_pairs, num_dense) + (() if cull_d is None else (cull_d,))
    if any(t.device != dev for t in tensors):
        raise ValueError("expand_pairs: all tensors must be on one device")
    lib = kernels.load("expand", _SIGNATURES)
    # One allocation for the three outputs (a call's host time is most of
    # its cost at 100k Gaussians); each row is a contiguous view.
    out = torch.empty((3, pair_budget), dtype=torch.int32, device=dev)
    base = out.data_ptr()
    with kernels.on_device(dev):
        err = lib.sgt_expand_pairs(
            offsets.data_ptr(), rect_packed_d.data_ptr(), idx_d.data_ptr(),
            None if cull_d is None else cull_d.data_ptr(),
            num_pairs.data_ptr(), num_dense.data_ptr(),
            n, pair_budget, ntx, num_tiles, tile_w, tile_h, CHUNK,
            base, base + 4 * pair_budget, base + 8 * pair_budget, kernels.current_stream(dev),
        )
    kernels.check(lib, err, "sgt_expand_pairs")
    LAUNCHES.add()
    return out.unbind(0)


def expand_pairs(
    offsets: torch.Tensor,  # [N] int32 exclusive cumsum of per-gaussian
    # counts, clamped into [0, pair_budget+1) (depth order)
    rect_packed_d: torch.Tensor,  # [N] int32 x0<<16 | y0<<8 | w (depth order)
    idx_d: torch.Tensor,  # [N] int32 original gaussian id
    cull_d: Optional[torch.Tensor],  # (5, N) f32 (mean_x, mean_y, e0, e1, e2)
    # depth order, e = conic / r^2; None disables the tile-ellipse cull
    num_pairs: torch.Tensor,  # [] int32 valid pairs (<= pair_budget)
    num_dense: torch.Tensor,  # [] int32 emitting-gaussian count
    pair_budget: int,
    ntx: int,
    num_tiles: int,
    n: int,
    tile_w: int = 32,
    tile_h: int = 16,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (tile [P], g_key [P], gen_owner [P]) in generation order.
    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    fn = {"cuda": _expand_pairs_cuda, "cpu": expand_pairs_plain}.get(offsets.device.type)
    if fn is None:
        raise ValueError(f"expand_pairs: unsupported device {offsets.device}")
    return fn(
        offsets, rect_packed_d, idx_d, cull_d, num_pairs, num_dense,
        pair_budget, ntx, num_tiles, n, tile_w, tile_h,
    )
