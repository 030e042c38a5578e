"""Tiled front-to-back alpha compositing, forward and backward.

Port of semantic_gaussians_tpu.ops.composite_pallas (`composite_pairs` and
its VJP). `composite_forward` launches the CUDA kernels
(csrc/composite_fwd.cu: one kernel up to 32 channels, a walk and a
contraction from LIST_MIN_CHANNELS on) for CUDA tensors and runs the plain
torch version, `composite_forward_plain`, for CPU tensors;
`composite_backward` does the same with csrc/composite_bwd.cu and
`composite_backward_plain`.
`CompositeFunction` is the autograd Function around the two: its forward
is the forward kernel (it saves final_T and n_contrib), its backward the
backward kernel, whose per-pair rows a caller-given function reduces to
per-Gaussian gradients (ops.rasterize does so with the segment sum).

Both read the per-Gaussian arrays through the tile-sorted pair ids: a
geometry table [N, 8] = (mean_x, mean_y, conic a, b, c, opacity, depth, 0)
from `pack_geometry`, and colours [N, C]. Outputs are tile-major, as the JAX
kernel's are: color [T, C, PX], depth / final_T / n_contrib [T, PX], with
PX = tile_h * tile_w pixels in row-major order inside the tile.

Semantics (composite_pallas.py:206-232 and :330-375): alpha = min(0.99,
op exp(power)) with tile-centred dx/dy; a pair is skipped when power > 0
or alpha < 1/255; a pixel stops when T (1 - alpha) < 1e-4, that pair
excluded; out = sum w color + T bg; median depth at the T = 0.5 crossing
(init 15.0); n_contrib = 1-based index in the tile range of the last
contributor. The backward steps T back as T * (1 / (1 - alpha)), one
reciprocal that its dalpha reuses, in the kernel and the plain version
alike.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..utils import tracing
from . import kernels

ALPHA_CUTOFF = 1.0 / 255.0
T_EPS = 1e-4
MAX_ALPHA = 0.99
MEDIAN_DEPTH_INIT = 15.0
GEOM_COLS = 8
MAX_TILE_PX = 512  # one CUDA thread per pixel of a tile
PLAIN_BATCH = 32  # pairs per colour contraction in the plain version

GRAD_GEOM_COLS = 6  # dmean_x, dmean_y, dconic a, b, c, dopacity

LAUNCHES = kernels.LaunchCounter("composite_fwd")
BWD_LAUNCHES = kernels.LaunchCounter("composite_bwd")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "sgt_composite_fwd": (_P,) * 6 + (_I,) * 5 + (_P,) * 8 + (ctypes.POINTER(_I),),
}
# From this width the forward is two kernels, a walk that lists each strip's
# contributing pairs and a contraction (the kernel takes the lists as the
# switch); the one-kernel path holds at most 32 channels in registers.
LIST_MIN_CHANNELS = 33
_BWD_SIGNATURES = {
    "sgt_composite_bwd": (_P,) * 9 + (_I,) * 5 + (_P, _P, ctypes.POINTER(_I)),
}


class _PackGeometry(torch.autograd.Function):
    """The geometry table written column block by column block into one
    allocation (on the card, a copy each is faster than torch.cat's kernel
    for 8-float rows); each input's gradient is a view of the table's."""

    @staticmethod
    def forward(ctx, means2d, conics, opacities, depths):
        geom = torch.empty((means2d.shape[0], GEOM_COLS), dtype=torch.float32,
                           device=means2d.device)
        geom[:, 0:2] = means2d
        geom[:, 2:5] = conics
        geom[:, 5] = opacities
        geom[:, 6] = depths
        geom[:, 7] = 0.0
        return geom

    @staticmethod
    def backward(ctx, g):
        return g[:, 0:2], g[:, 2:5], g[:, 5], g[:, 6]


def pack_geometry(means2d, conics, opacities, depths) -> torch.Tensor:
    """Per-Gaussian geometry table [N, 8] float32 (one 32-byte row each):
    means2d, conic (a, b, c), opacity, depth and a zero pad."""
    return _PackGeometry.apply(means2d, conics, opacities, depths)


def _tile_frame(nt: int, grid_w: int, tile_h: int, tile_w: int, dev):
    """Tile-centred coordinates: each tile's pixel centroid (tox, toy [T])
    and each pixel's offset from it (lx, ly [PX])."""
    f32 = torch.float32
    px = tile_h * tile_w
    tid = torch.arange(nt, device=dev)
    tox = ((tid % grid_w) * tile_w).to(f32) + 0.5 * (tile_w - 1)
    toy = ((tid // grid_w) * tile_h).to(f32) + 0.5 * (tile_h - 1)
    pid = torch.arange(px, device=dev)
    lx = (pid % tile_w).to(f32) - 0.5 * (tile_w - 1)
    ly = (pid // tile_w).to(f32) - 0.5 * (tile_h - 1)
    return tox, toy, lx, ly


def _alpha_terms(r, tox, toy, lx, ly):
    """(dx, dy, power, g, alpha) [T, PX] of one geometry row per tile
    (r [T, 8]) at every pixel of its tile, in the kernels' op order."""
    dx = (r[:, 0] - tox)[:, None] - lx[None, :]
    dy = (r[:, 1] - toy)[:, None] - ly[None, :]
    power = (
        -0.5 * (r[:, 2, None] * dx * dx + r[:, 4, None] * dy * dy)
        - r[:, 3, None] * dx * dy
    )
    g = torch.exp(torch.clamp(power, max=0.0))
    alpha = torch.clamp(r[:, 5, None] * g, max=MAX_ALPHA)
    return dx, dy, power, g, alpha


def composite_forward_plain(
    geom, colors, pair_gaussian, tile_start, tile_count, bg,
    grid_w: int, tile_h: int, tile_w: int, work: Optional[dict] = None,
):
    """Plain torch version of `composite_forward`. Every tile's pixels walk
    their tile range in the same sequential order as the kernel, all tiles
    at once; the weights of each batch of pairs are then contracted with the
    batch's colours.

    If `work` is a dict, it receives what these inputs need done, counted in
    (pixel, pair) events: "evaluated", the pairs whose alpha a pixel computes
    before it stops (the terminating pair included), and "contributed", the
    pairs whose colour it accumulates."""
    dev = geom.device
    f32 = torch.float32
    nt = tile_start.shape[0]
    px = tile_h * tile_w
    num_ch = colors.shape[1]
    tox, toy, lx, ly = _tile_frame(nt, grid_w, tile_h, tile_w, dev)

    T = torch.ones((nt, px), dtype=f32, device=dev)
    D = torch.full((nt, px), MEDIAN_DEPTH_INIT, dtype=f32, device=dev)
    last = torch.zeros((nt, px), dtype=torch.int32, device=dev)
    done = torch.zeros((nt, px), dtype=torch.bool, device=dev)
    acc = torch.zeros((nt, num_ch, px), dtype=f32, device=dev)
    start = tile_start.long()
    count = tile_count.long()
    max_count = int(count.max()) if nt else 0
    p_last = max(pair_gaussian.shape[0] - 1, 0)
    zero = torch.zeros((), dtype=f32, device=dev)
    evaluated = torch.zeros((), dtype=torch.int64, device=dev)
    contributed = torch.zeros((), dtype=torch.int64, device=dev)
    for b0 in range(0, max_count, PLAIN_BATCH):
        if bool(done.all()):
            break
        nb = min(PLAIN_BATCH, max_count - b0)
        j = b0 + torch.arange(nb, device=dev)
        has = j[None, :] < count[:, None]  # [nt, nb]
        pos = torch.clamp(start[:, None] + j[None, :], max=p_last)
        g = torch.where(has, pair_gaussian[pos].long(), 0)
        rows = geom[g]  # [nt, nb, 8]
        w_buf = torch.zeros((nt, nb, px), dtype=f32, device=dev)
        for i in range(nb):
            r = rows[:, i]
            _, _, power, _, alpha = _alpha_terms(r, tox, toy, lx, ly)
            cand = has[:, i, None] & (power <= 0.0) & (alpha >= ALPHA_CUTOFF) & ~done
            test_t = T * (1.0 - alpha)
            term = cand & (test_t < T_EPS)
            contrib = cand & ~term
            w_buf[:, i] = torch.where(contrib, alpha * T, zero)
            D = torch.where(contrib & (T > 0.5) & (test_t < 0.5), r[:, 6, None], D)
            T = torch.where(contrib, test_t, T)
            last = torch.where(contrib, torch.full_like(last, b0 + i + 1), last)
            if work is not None:
                evaluated += (has[:, i, None] & ~done).sum()
                contributed += contrib.sum()
            done = done | term
        col = colors[g] * has[..., None]  # [nt, nb, C]
        acc = acc + torch.bmm(col.transpose(1, 2), w_buf)
    color = acc + bg[None, :, None] * T[:, None, :]
    if work is not None:
        work.update(evaluated=int(evaluated), contributed=int(contributed))
    return color, D, T, last


def _check(t, name, dtype, shape, dev):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected contiguous {dtype} {tuple(shape)}, got "
            f"{t.dtype} {tuple(t.shape)}"
        )
    if t.device != dev:
        raise ValueError(f"{name}: on {t.device}, expected {dev}")


def _check_inputs(geom, colors, pair_gaussian, tile_start, tile_count, bg,
                  grid_w: int, tile_h: int, tile_w: int):
    """Validate what both kernels read; returns (device, T, C, PX)."""
    dev = geom.device
    n = geom.shape[0]
    nt = tile_start.shape[0]
    num_ch = colors.shape[1] if colors.dim() == 2 else -1
    px = tile_h * tile_w
    if px > MAX_TILE_PX or px % 32:
        raise ValueError(f"tile {tile_h}x{tile_w}: need a multiple of 32 px, at most {MAX_TILE_PX}")
    if nt % grid_w:
        raise ValueError(f"{nt} tiles is not a multiple of grid_w={grid_w}")
    _check(geom, "geom", torch.float32, (n, GEOM_COLS), dev)
    _check(colors, "colors", torch.float32, (n, num_ch), dev)
    _check(bg, "bg", torch.float32, (num_ch,), dev)
    _check(pair_gaussian, "pair_gaussian", torch.int32, pair_gaussian.shape[:1], dev)
    _check(tile_start, "tile_start", torch.int32, (nt,), dev)
    _check(tile_count, "tile_count", torch.int32, (nt,), dev)
    if geom.data_ptr() % 16:
        raise ValueError("geom must be 16-byte aligned (float4 rows)")
    return dev, nt, num_ch, px


def _composite_forward_cuda(
    geom, colors, pair_gaussian, tile_start, tile_count, bg,
    grid_w: int, tile_h: int, tile_w: int,
):
    dev, nt, num_ch, px = _check_inputs(
        geom, colors, pair_gaussian, tile_start, tile_count, bg, grid_w, tile_h, tile_w
    )
    color = torch.empty((nt, num_ch, px), dtype=torch.float32, device=dev)
    depth = torch.empty((nt, px), dtype=torch.float32, device=dev)
    final_t = torch.empty((nt, px), dtype=torch.float32, device=dev)
    n_contrib = torch.empty((nt, px), dtype=torch.int32, device=dev)
    # From LIST_MIN_CHANNELS on, the walk lists every strip's (32 pixels')
    # contributing pairs with their weights for the contraction kernel: at
    # most a tile's pair count per strip, so P * PX / 32 entries (at the
    # pair budget of a 640x480 view and C = 768: 2.5 GB, reused by the
    # caching allocator).
    if num_ch >= LIST_MIN_CHANNELS:
        entries = pair_gaussian.shape[0] * (px // 32)
        list_w = torch.empty((entries, 32), dtype=torch.float32, device=dev)
        list_id = torch.empty((entries,), dtype=torch.int32, device=dev)
        list_n = torch.empty((nt * (px // 32),), dtype=torch.int32, device=dev)
        lists = (list_w.data_ptr(), list_id.data_ptr(), list_n.data_ptr())
    else:
        lists = (None, None, None)
    lib = kernels.load("composite_fwd", _SIGNATURES)
    launched = _I(0)  # 2 for C >= LIST_MIN_CHANNELS: the walk, then the contraction
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sgt_composite_fwd(
            geom.data_ptr(), colors.data_ptr(), pair_gaussian.data_ptr(),
            tile_start.data_ptr(), tile_count.data_ptr(), bg.data_ptr(),
            num_ch, nt, grid_w, tile_w, tile_h,
            color.data_ptr(), depth.data_ptr(), final_t.data_ptr(),
            n_contrib.data_ptr(), *lists, stream, ctypes.byref(launched),
        )
    LAUNCHES.add(launched.value, key=num_ch)
    kernels.check(lib, err, "sgt_composite_fwd")
    return color, depth, final_t, n_contrib


def composite_forward(
    geom: torch.Tensor,  # [N, 8] float32 from pack_geometry
    colors: torch.Tensor,  # [N, C] float32
    pair_gaussian: torch.Tensor,  # [P] int32 tile-sorted gaussian ids
    tile_start: torch.Tensor,  # [T] int32
    tile_count: torch.Tensor,  # [T] int32
    bg: torch.Tensor,  # [C] float32
    grid_w: int,
    tile_h: int,
    tile_w: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Composite every tile: (color [T, C, PX], depth [T, PX], final_T
    [T, PX], n_contrib int32 [T, PX]), tile-major. CUDA tensors launch the
    kernel; CPU tensors take the plain version."""
    fn = {"cuda": _composite_forward_cuda, "cpu": composite_forward_plain}.get(
        geom.device.type
    )
    if fn is None:
        raise ValueError(f"composite_forward: unsupported device {geom.device}")
    return fn(geom, colors, pair_gaussian, tile_start, tile_count, bg, grid_w, tile_h, tile_w)


def composite_backward_plain(
    geom, colors, pair_gaussian, tile_start, tile_count, bg, g_color, final_t,
    n_contrib, grid_w: int, tile_h: int, tile_w: int, work: Optional[dict] = None,
):
    """Plain torch version of `composite_backward`: every tile walks its
    range back to front from its largest n_contrib, all tiles at once, with
    the kernel's arithmetic. Rows outside every tile range stay zero (the
    kernel leaves them unwritten).

    If `work` is a dict, it receives the (pixel, pair) events these inputs
    need: "evaluated", the alphas up to each pixel's n_contrib, and
    "contributed", the events that carry a gradient."""
    dev = geom.device
    f32 = torch.float32
    nt = tile_start.shape[0]
    num_ch = colors.shape[1]
    p = pair_gaussian.shape[0]
    out = torch.zeros((p, GRAD_GEOM_COLS + num_ch), dtype=f32, device=dev)
    tox, toy, lx, ly = _tile_frame(nt, grid_w, tile_h, tile_w, dev)
    start = tile_start.long()
    last = n_contrib.long()
    max_last = torch.minimum(last.max(dim=1).values, tile_count.long())  # [nt]
    steps = int(max_last.max())
    T = final_t.clone()
    s = torch.zeros_like(T)
    bgdot = torch.einsum("c,tcp->tp", bg, g_color)
    tbg = final_t * bgdot
    zero = torch.zeros((), dtype=f32, device=dev)
    contributed = torch.zeros((), dtype=torch.int64, device=dev)
    for j in range(steps - 1, -1, -1):
        has = j < max_last  # [nt]
        pos = torch.clamp(start + j, max=max(p - 1, 0))
        g = torch.where(has, pair_gaussian[pos].long(), 0)
        r = geom[g]  # [nt, 8]
        dx, dy, power, gv, alpha = _alpha_terms(r, tox, toy, lx, ly)
        contrib = (j < last) & (power <= 0.0) & (alpha >= ALPHA_CUTOFF) & has[:, None]
        om = 1.0 - alpha
        inv = 1.0 / om
        T = torch.where(contrib, T * inv, T)  # the kernel's order: one division
        w = torch.where(contrib, alpha * T, zero)
        q = torch.bmm(colors[g][:, None, :], g_color)[:, 0]  # [nt, px]
        dalpha = torch.where(contrib, T * q - s * inv - tbg * inv, zero)
        s = torch.where(contrib, s + w * q, s)
        gd = gv * dalpha
        dldp = r[:, 5, None] * gd
        t1 = dldp * dx
        t2 = dldp * dy
        ex, ey = t1.sum(1), t2.sum(1)
        ca, cb, cc = r[:, 2], r[:, 3], r[:, 4]
        geo = torch.stack([
            -(ca * ex + cb * ey), -(cc * ey + cb * ex), -0.5 * (t1 * dx).sum(1),
            -(t1 * dy).sum(1), -0.5 * (t2 * dy).sum(1), gd.sum(1),
        ], dim=1)
        dcolor = torch.bmm(g_color, w[:, :, None])[:, :, 0]  # [nt, C]
        out[pos[has]] = torch.cat([geo, dcolor], dim=1)[has]
        if work is not None:
            contributed += contrib.sum()
    if work is not None:
        work.update(evaluated=int(last.sum()), contributed=int(contributed))
    return out


def _composite_backward_cuda(
    geom, colors, pair_gaussian, tile_start, tile_count, bg, g_color, final_t,
    n_contrib, grid_w: int, tile_h: int, tile_w: int,
):
    dev, nt, num_ch, px = _check_inputs(
        geom, colors, pair_gaussian, tile_start, tile_count, bg, grid_w, tile_h, tile_w
    )
    _check(g_color, "g_color", torch.float32, (nt, num_ch, px), dev)
    _check(final_t, "final_t", torch.float32, (nt, px), dev)
    _check(n_contrib, "n_contrib", torch.int32, (nt, px), dev)
    out = torch.empty(
        (pair_gaussian.shape[0], GRAD_GEOM_COLS + num_ch), dtype=torch.float32, device=dev
    )
    lib = kernels.load("composite_bwd", _BWD_SIGNATURES)
    launched = _I(0)  # one kernel: the one-pass (C <= 8) or the wide design
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sgt_composite_bwd(
            geom.data_ptr(), colors.data_ptr(), pair_gaussian.data_ptr(),
            tile_start.data_ptr(), tile_count.data_ptr(), bg.data_ptr(),
            g_color.data_ptr(), final_t.data_ptr(), n_contrib.data_ptr(),
            num_ch, nt, grid_w, tile_w, tile_h, out.data_ptr(), stream,
            ctypes.byref(launched),
        )
    BWD_LAUNCHES.add(launched.value, key=num_ch)
    kernels.check(lib, err, "sgt_composite_bwd")
    return out


def composite_backward(
    geom: torch.Tensor,  # [N, 8] float32 from pack_geometry
    colors: torch.Tensor,  # [N, C] float32
    pair_gaussian: torch.Tensor,  # [P] int32 tile-sorted gaussian ids
    tile_start: torch.Tensor,  # [T] int32
    tile_count: torch.Tensor,  # [T] int32
    bg: torch.Tensor,  # [C] float32
    g_color: torch.Tensor,  # [T, C, PX] float32 upstream gradient
    final_t: torch.Tensor,  # [T, PX] float32 from the forward
    n_contrib: torch.Tensor,  # [T, PX] int32 from the forward
    grid_w: int,
    tile_h: int,
    tile_w: int,
) -> torch.Tensor:
    """Per-pair gradient rows [P, 6 + C] in tile-sorted order: (dmean_x,
    dmean_y, dconic a, b, c, dopacity, dcolor[C]). Rows of slots in a tile
    range are written (zero past the tile's last contributor); the others
    are unspecified. CUDA tensors launch the kernel; CPU tensors take the
    plain version."""
    fn = {"cuda": _composite_backward_cuda, "cpu": composite_backward_plain}.get(
        geom.device.type
    )
    if fn is None:
        raise ValueError(f"composite_backward: unsupported device {geom.device}")
    return fn(geom, colors, pair_gaussian, tile_start, tile_count, bg, g_color,
              final_t, n_contrib, grid_w, tile_h, tile_w)


class CompositeFunction(torch.autograd.Function):
    """composite_forward with a gradient. Gradients reach `geom` (columns
    0-5; depth and padding get none), `colors` and `bg`; the cotangents of
    depth, final_T and n_contrib are ignored, as in the JAX package.

    `to_gaussians(rows)` maps the backward kernel's per-pair rows [P, 6 + C]
    to (d_geom [N, 8], d_colors [N, C])."""

    @staticmethod
    def forward(ctx, geom, colors, bg, pair_gaussian, tile_start, tile_count,
                grid_w, tile_h, tile_w, to_gaussians):
        color, depth, final_t, n_contrib = composite_forward(
            geom, colors, pair_gaussian, tile_start, tile_count, bg, grid_w, tile_h, tile_w
        )
        ctx.save_for_backward(geom, colors, bg, pair_gaussian, tile_start, tile_count,
                              final_t, n_contrib)
        ctx.frame = (grid_w, tile_h, tile_w)
        ctx.to_gaussians = to_gaussians
        ctx.mark_non_differentiable(n_contrib)
        return color, depth, final_t, n_contrib

    @staticmethod
    def backward(ctx, g_color, _g_depth, _g_final_t, _g_n_contrib):
        tracing.phase("composite_bwd", g_color.device)
        geom, colors, bg, pair_gaussian, tile_start, tile_count, final_t, n_contrib = (
            ctx.saved_tensors
        )
        g_color = g_color.to(torch.float32).contiguous()
        rows = composite_backward(
            geom, colors, pair_gaussian, tile_start, tile_count, bg, g_color, final_t,
            n_contrib, *ctx.frame,
        )
        # bg enters only as out = C + T bg.
        d_bg = torch.einsum("tp,tcp->c", final_t, g_color)
        d_geom, d_colors = ctx.to_gaussians(rows)
        tracing.phase("project_bwd", g_color.device)
        return d_geom, d_colors, d_bg, None, None, None, None, None, None, None
