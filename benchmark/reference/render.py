"""Plain-PyTorch reference of the tiled Gaussian rasterizer.

Independent of the program: the camera matrices, the EWA projection, the
SH colours, the tile binning and the front-to-back compositing are written
out here from the 3DGS equations, with the program's published constants
(near cull at view z 0.2, the 1.3 tan-FOV clamp, +0.3 px low-pass,
eigenvalue floor 0.1, radius ceil(3 sigma), opacity-aware rect extents,
16x32 tiles, alpha cut 1/255, alpha cap 0.99, transmittance stop 1e-4).

Compositing works tile by tile: a tile's pairs in depth order, every pixel
of the tile against every pair, the transmittance as a cumulative product
and the stop as a cumulative "done". Tiles go in blocks of similar pair
counts so that padding stays small and a block fits in memory. The
gradient is recomputed block by block in the backward (nothing of a block
is kept after its forward), so a 1080p frame with ten million pairs fits.

`dtype` sets the arithmetic: float32 is the reference, bfloat16 the
control that a lower-precision program would be.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

NEAR_CULL_Z = 0.2
LOWPASS = 0.3
EIG_FLOOR = 0.1
ALPHA_CUTOFF = 1.0 / 255.0
MAX_ALPHA = 0.99
T_EPS = 1e-4
TILE = (16, 32)  # (height, width) of a tile, the program's own
BLOCK_ELEMS = 1 << 24  # (pixel, pair) evaluations a block holds
CULL_MARGIN = 1.0 + 1e-4

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


def camera(c2w: np.ndarray, fov_x: float, fov_y: float, width: int, height: int,
           device, znear: float = 0.01, zfar: float = 100.0) -> Dict:
    """A pinhole camera (x right, y down, z forward) from its 4x4
    camera-to-world pose: world->view and full projection as float32."""
    w2c = np.linalg.inv(np.asarray(c2w, np.float64))
    tx, ty = math.tan(fov_x / 2), math.tan(fov_y / 2)
    proj = np.zeros((4, 4), np.float64)
    proj[0, 0] = 1.0 / tx
    proj[1, 1] = 1.0 / ty
    proj[2, 2] = zfar / (zfar - znear)
    proj[2, 3] = -(zfar * znear) / (zfar - znear)
    proj[3, 2] = 1.0
    f32 = torch.float32
    return dict(
        world_view=torch.tensor(w2c, dtype=f32, device=device),
        full_proj=torch.tensor(proj @ w2c, dtype=f32, device=device),
        center=torch.tensor(np.asarray(c2w, np.float64)[:3, 3], dtype=f32, device=device),
        width=int(width), height=int(height), tan_x=tx, tan_y=ty,
    )


def sh_colors(sh: torch.Tensor, dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """RGB of [N, K, 3] SH coefficients seen along unit `dirs` [N, 3]."""
    x, y, z = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    basis = [SH_C0 * torch.ones_like(x)]
    if degree > 0:
        basis += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree > 1:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        basis += [SH_C2[0] * xy, SH_C2[1] * yz, SH_C2[2] * (2 * zz - xx - yy),
                  SH_C2[3] * xz, SH_C2[4] * (xx - yy)]
    if degree > 2:
        basis += [SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * xy * z,
                  SH_C3[2] * y * (4 * zz - xx - yy), SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                  SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
                  SH_C3[6] * x * (xx - 3 * yy)]
    b = torch.stack(basis, dim=-1)  # [N, K]
    return torch.clamp((sh[:, :b.shape[1], :] * b[:, :, None]).sum(1) + 0.5, min=0.0)


def project(params: Dict[str, torch.Tensor], cam: Dict, sh_degree: int,
            colors: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """EWA projection of every Gaussian: means2d, depth, conic, opacity,
    colours (from SH, or `colors` [N, C] as given), the rect half-extents
    (int) and the support ellipse that bounds alpha >= 1/255."""
    dt = params["means"].dtype
    wv = cam["world_view"].to(dt)
    fp = cam["full_proj"].to(dt)
    w, h = cam["width"], cam["height"]
    tx, ty = cam["tan_x"], cam["tan_y"]
    fx, fy = w / (2 * tx), h / (2 * ty)
    m = params["means"]
    t = m @ wv[:3, :3].T + wv[:3, 3]
    depth = t[:, 2]
    front = depth > NEAR_CULL_Z
    hom = m @ fp[:3, :3].T + fp[:3, 3]
    pw = m @ fp[3, :3] + fp[3, 3]
    pw = torch.where(pw.abs() > 1e-6, pw, torch.full_like(pw, 1e-6))
    ndc = hom / (pw + 1e-7)[:, None]
    means2d = torch.stack([((ndc[:, 0] + 1) * w - 1) * 0.5, ((ndc[:, 1] + 1) * h - 1) * 0.5], -1)

    tz = torch.where(front, depth, torch.ones_like(depth))
    cx = torch.clamp(t[:, 0] / tz, -1.3 * tx, 1.3 * tx) * tz
    cy = torch.clamp(t[:, 1] / tz, -1.3 * ty, 1.3 * ty) * tz
    # J W: the two rows of the affine approximation, [N, 3] each
    wr = wv[:3, :3]
    u = (fx / tz)[:, None] * wr[0][None, :] - (fx * cx / (tz * tz))[:, None] * wr[2][None, :]
    v = (fy / tz)[:, None] * wr[1][None, :] - (fy * cy / (tz * tz))[:, None] * wr[2][None, :]
    q = params["quats"]
    q = q / torch.sqrt((q * q).sum(-1, keepdim=True) + 1e-12)
    qw, qx, qy, qz = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    rot = torch.stack([
        torch.stack([1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)], -1),
        torch.stack([2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)], -1),
        torch.stack([2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)], -1),
    ], -2)  # [N, 3, 3], columns the Gaussian's axes
    s = torch.exp(params["log_scales"])
    lu = torch.einsum("nji,nj->ni", rot, u) * s  # (R S)^T u
    lv = torch.einsum("nji,nj->ni", rot, v) * s
    a = (lu * lu).sum(-1) + LOWPASS
    b = (lu * lv).sum(-1)
    c = (lv * lv).sum(-1) + LOWPASS
    det = a * c - b * b
    det_ok = det != 0
    inv = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack([c * inv, -b * inv, a * inv], -1)
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=EIG_FLOOR))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam, min=0.0)))
    valid = front & det_ok
    if "alive" in params:
        valid = valid & params["alive"]
    opac = torch.where(valid, torch.sigmoid(params["opacity_logits"][:, 0]),
                       torch.zeros_like(depth))
    r2 = 2.0 * torch.log(torch.clamp(255.0 * opac, min=1.0))
    r = torch.sqrt(r2)
    rx = torch.minimum(radius, torch.ceil(r * torch.sqrt(torch.clamp(a, min=0.0))))
    ry = torch.minimum(radius, torch.ceil(r * torch.sqrt(torch.clamp(c, min=0.0))))
    keep = (valid & (r2 > 0))[:, None]
    rect = torch.where(keep, torch.stack([rx, ry], -1), torch.zeros_like(torch.stack([rx, ry], -1)))
    inv_r2 = torch.where(r2 > 0, 1.0 / torch.clamp(r2, min=1e-20), torch.zeros_like(r2))
    if colors is None:
        d = m - cam["center"].to(dt)[None, :]
        d = d / torch.sqrt((d * d).sum(-1, keepdim=True) + 1e-20)
        sh = torch.cat([params["sh_dc"], params["sh_rest"]], 1)
        colors = sh_colors(sh, d, sh_degree)
    return dict(means2d=means2d, depth=depth, conic=conic, opac=opac, colors=colors,
                rect=rect.detach().to(torch.int64),
                ellipse=(conic * inv_r2[:, None]).detach())


def _tile_min_q(lox, hix, loy, hiy, e0, e1, e2):
    """Least of the support quadratic over the box [lox, hix] x [loy, hiy]
    (offsets from the Gaussian's centre): 0 when the centre is inside."""
    inside = (lox <= 0) & (hix >= 0) & (loy <= 0) & (hiy >= 0)
    e0s, e2s = torch.clamp(e0, min=1e-20), torch.clamp(e2, min=1e-20)

    def qf(dx, dy):
        return e0 * dx * dx + 2.0 * (e1 * dx * dy) + e2 * dy * dy

    q = torch.minimum(
        torch.minimum(qf(lox, torch.clamp(-(e1 * lox) / e2s, loy, hiy)),
                      qf(hix, torch.clamp(-(e1 * hix) / e2s, loy, hiy))),
        torch.minimum(qf(torch.clamp(-(e1 * loy) / e0s, lox, hix), loy),
                      qf(torch.clamp(-(e1 * hiy) / e0s, lox, hix), hiy)))
    return torch.where(inside, torch.zeros_like(q), q)


class Binning:
    """The (tile, Gaussian) pairs of one view: each Gaussian's rect of
    tiles, ordered by tile and, within a tile, by depth (ties by index)."""

    def __init__(self, proj: Dict, width: int, height: int, tile=TILE):
        th, tw = tile
        self.tile = tile
        self.ntx, self.nty = -(-width // tw), -(-height // th)
        self.width, self.height = width, height
        m2 = proj["means2d"].detach().float()
        rect = proj["rect"]
        rx, ry = rect[:, 0].float(), rect[:, 1].float()
        x0 = torch.clamp(torch.floor((m2[:, 0] - rx) / tw), 0, self.ntx).long()
        x1 = torch.clamp(torch.floor((m2[:, 0] + rx + tw - 1) / tw), 0, self.ntx).long()
        y0 = torch.clamp(torch.floor((m2[:, 1] - ry) / th), 0, self.nty).long()
        y1 = torch.clamp(torch.floor((m2[:, 1] + ry + th - 1) / th), 0, self.nty).long()
        has = (rect[:, 0] > 0) & (rect[:, 1] > 0)
        cnt = torch.where(has, (x1 - x0) * (y1 - y0), torch.zeros_like(x0))
        depth = proj["depth"].detach().float()
        order = torch.argsort(torch.where(cnt > 0, depth, torch.full_like(depth, math.inf)),
                              stable=True)
        order = order[cnt[order] > 0]
        c = cnt[order]
        self.num_dense = int(order.numel())
        gid = torch.repeat_interleave(order, c)
        start = torch.cumsum(c, 0) - c
        k = torch.arange(gid.numel(), device=gid.device) - torch.repeat_interleave(start, c)
        wdt = (x1 - x0)[gid]
        tx = x0[gid] + k % wdt
        ty = y0[gid] + k // wdt
        tile_id = ty * self.ntx + tx
        srt = torch.argsort(tile_id, stable=True)
        self.pair_gauss = gid[srt]
        self.pair_tile = tile_id[srt]
        ntiles = self.ntx * self.nty
        self.tile_count = torch.bincount(self.pair_tile, minlength=ntiles)
        self.tile_start = torch.cumsum(self.tile_count, 0) - self.tile_count
        self.num_pairs = int(self.pair_gauss.numel())
        # pairs whose tile the support ellipse reaches (the rest are culled:
        # no pixel of the tile reaches alpha 1/255)
        e = proj["ellipse"].float()[self.pair_gauss]
        mx, my = m2[self.pair_gauss, 0], m2[self.pair_gauss, 1]
        lox = (self.pair_tile % self.ntx * tw).float() - mx
        loy = (self.pair_tile // self.ntx * th).float() - my
        qn = _tile_min_q(lox, lox + (tw - 1), loy, loy + (th - 1), e[:, 0], e[:, 1], e[:, 2])
        self.live_pairs = int((~(qn > CULL_MARGIN)).sum())

    def blocks(self, block_elems: int = BLOCK_ELEMS):
        """Lists of tile ids with pairs, the busiest first, each list small
        enough that its (pixel, pair) grid holds `block_elems`."""
        px = self.tile[0] * self.tile[1]
        cnt = self.tile_count
        tiles = torch.argsort(cnt, descending=True)
        tiles = tiles[cnt[tiles] > 0].tolist()
        counts = cnt[tiles].tolist() if tiles else []
        out, i = [], 0
        while i < len(tiles):
            m = counts[i]
            n = max(1, block_elems // (px * m))
            out.append((torch.tensor(tiles[i:i + n], device=cnt.device), m))
            i += n
        return out


def _walk(tiles, m, bins: Binning, means2d, conic, opac):
    """The front-to-back walk of one block of tiles: each pixel against
    each of its tile's pairs (padded to `m`). Returns the pairs' Gaussians
    [nt, m], the alphas that count [nt, px, m], the transmittance before
    and after each pair, and which pairs contribute."""
    th, tw = bins.tile
    dev = means2d.device
    dt = means2d.dtype
    j = torch.arange(m, device=dev)
    start, cnt = bins.tile_start[tiles], bins.tile_count[tiles]
    ok = j[None, :] < cnt[:, None]
    idx = torch.clamp(start[:, None] + j[None, :], max=bins.num_pairs - 1)
    g = bins.pair_gauss[idx]  # [nt, m]
    ly, lx = torch.meshgrid(torch.arange(th, device=dev), torch.arange(tw, device=dev),
                            indexing="ij")
    px_x = ((tiles % bins.ntx) * tw)[:, None] + lx.reshape(-1)[None, :]  # [nt, px]
    px_y = ((tiles // bins.ntx) * th)[:, None] + ly.reshape(-1)[None, :]
    dx = means2d[g, 0][:, None, :] - px_x.to(dt)[:, :, None]  # [nt, px, m]
    dy = means2d[g, 1][:, None, :] - px_y.to(dt)[:, :, None]
    cg = conic[g]
    power = (-0.5 * (cg[:, None, :, 0] * dx * dx + cg[:, None, :, 2] * dy * dy)
             - cg[:, None, :, 1] * dx * dy)
    o = torch.where(ok, opac[g], torch.zeros_like(opac[g]))
    alpha = torch.clamp(o[:, None, :] * torch.exp(torch.clamp(power, max=0.0)), max=MAX_ALPHA)
    cand = (power <= 0) & (alpha >= ALPHA_CUTOFF) & ok[:, None, :]
    a = torch.where(cand, alpha, torch.zeros_like(alpha))
    t_incl = torch.cumprod(1.0 - a, dim=-1)
    t_excl = torch.cat([torch.ones_like(t_incl[..., :1]), t_incl[..., :-1]], -1)
    term = cand & (t_incl < T_EPS)
    done = torch.cumsum(term.to(torch.int32), -1) > 0  # the stopping pair included
    return dict(g=g, cnt=cnt, a=a, t_incl=t_incl, t_excl=t_excl, term=term, done=done,
                contrib=cand & ~done)


def _block(tiles, m, bins: Binning, means2d, conic, opac, colors):
    """([nt, px, C] colour, [nt, px] transmittance) of one block."""
    w = _walk(tiles, m, bins, means2d, conic, opac)
    wgt = torch.where(w["contrib"], w["a"] * w["t_excl"], torch.zeros_like(w["a"]))
    col = torch.einsum("npm,nmc->npc", wgt, colors[w["g"]])
    return col, 1.0 - wgt.sum(-1)


def _block_counts(tiles, m, bins: Binning, means2d, conic, opac) -> Dict[str, int]:
    w = _walk(tiles, m, bins, means2d, conic, opac)
    done, contrib = w["done"], w["contrib"]
    walked = torch.where(done.any(-1), torch.argmax(w["term"].to(torch.int8), -1) + 1,
                         w["cnt"][:, None].expand_as(done[..., 0]))
    last = torch.where(contrib.any(-1), m - torch.argmax(contrib.flip(-1).to(torch.int8), -1),
                       torch.zeros_like(walked))
    return dict(evaluated=int(walked.sum()), contributing=int(contrib.sum()),
                up_to_last=int(last.sum()))


def _untile(buf: torch.Tensor, bins: Binning) -> torch.Tensor:
    """[tiles, px, C] tile-major -> [H, W, C] cropped."""
    th, tw = bins.tile
    c = buf.shape[-1]
    x = buf.reshape(bins.nty, bins.ntx, th, tw, c).permute(0, 2, 1, 3, 4)
    return x.reshape(bins.nty * th, bins.ntx * tw, c)[:bins.height, :bins.width]


def _composite_all(bins: Binning, means2d, conic, opac, colors, bg):
    th, tw = bins.tile
    ntiles = bins.ntx * bins.nty
    c = colors.shape[-1]
    buf = bg.reshape(1, 1, c).expand(ntiles, th * tw, c).clone()
    for tiles, m in bins.blocks():
        col, tf = _block(tiles, m, bins, means2d, conic, opac, colors)
        buf[tiles] = col + tf[..., None] * bg.reshape(1, 1, c)
    return _untile(buf, bins)


class _Composite(torch.autograd.Function):
    """The composite with its gradient recomputed block by block."""

    @staticmethod
    def forward(ctx, means2d, conic, opac, colors, bg, bins):
        ctx.bins = bins
        ctx.save_for_backward(means2d, conic, opac, colors, bg)
        with torch.no_grad():
            return _composite_all(bins, means2d, conic, opac, colors, bg)

    @staticmethod
    def backward(ctx, gout):
        bins = ctx.bins
        saved = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        grads = [torch.zeros_like(t) for t in saved]
        th, tw = bins.tile
        c = saved[3].shape[-1]
        # the output gradient in tile-major layout (zero on the crop)
        hp, wp = bins.nty * th, bins.ntx * tw
        gpad = gout.new_zeros((hp, wp, c))
        gpad[:bins.height, :bins.width] = gout
        gtile = gpad.reshape(bins.nty, th, bins.ntx, tw, c).permute(0, 2, 1, 3, 4).reshape(
            bins.nty * bins.ntx, th * tw, c)
        covered = torch.zeros(bins.nty * bins.ntx, dtype=torch.bool, device=gout.device)
        for tiles, m in bins.blocks():
            covered[tiles] = True
            with torch.enable_grad():
                col, tf = _block(tiles, m, bins, *saved[:4])
                out = col + tf[..., None] * saved[4].reshape(1, 1, c)
            gs = torch.autograd.grad(out, saved, gtile[tiles], allow_unused=True)
            for acc, gi in zip(grads, gs):
                if gi is not None:
                    acc += gi
        grads[4] = grads[4] + gtile[~covered].sum((0, 1))  # tiles without pairs
        return (*grads, None)


def render(params: Dict[str, torch.Tensor], cam: Dict, sh_degree: int, bg: torch.Tensor,
           colors: Optional[torch.Tensor] = None, with_depth: bool = False) -> Dict:
    """Render one view: {"image" [H, W, C], "bins"}; differentiable in
    `params` (and `colors`). `with_depth` adds the median depth [H, W]
    (the depth where transmittance first falls below one half; 15 where
    it never does), without a gradient."""
    proj = project(params, cam, sh_degree, colors)
    bins = Binning(proj, cam["width"], cam["height"])
    dt = proj["means2d"].dtype
    img = _Composite.apply(proj["means2d"], proj["conic"], proj["opac"], proj["colors"],
                           bg.to(dt), bins)
    out = dict(image=img, bins=bins, proj=proj)
    if with_depth:
        with torch.no_grad():
            out["depth"] = median_depth(bins, proj)
    return out


def median_depth(bins: Binning, proj: Dict) -> torch.Tensor:
    """Depth of the pair at which each pixel's transmittance crosses one
    half (15 where it never does), [H, W]."""
    th, tw = bins.tile
    d = proj["depth"]
    buf = torch.full((bins.ntx * bins.nty, th * tw, 1), 15.0, dtype=d.dtype, device=d.device)
    for tiles, m in bins.blocks():
        w = _walk(tiles, m, bins, proj["means2d"], proj["conic"], proj["opac"])
        cross = w["contrib"] & (w["t_excl"] > 0.5) & (w["t_incl"] < 0.5)
        first = torch.argmax(cross.to(torch.int8), -1)
        dep = d[w["g"]].gather(1, first)  # [nt, px]
        buf[tiles, :, 0] = torch.where(cross.any(-1), dep, torch.full_like(dep, 15.0))
    return _untile(buf, bins)[..., 0]


@torch.no_grad()
def event_counts(params: Dict[str, torch.Tensor], cam: Dict, sh_degree: int) -> Dict[str, int]:
    """The work one RGB view asks of the rasterizer, counted from its
    inputs: pairs, pairs left by the tile cull ("live"), Gaussians with a
    pair ("dense"), (pixel, pair) evaluations walked until each pixel
    stops ("evaluated"), contributions, and the walk up to each pixel's
    last contribution ("up_to_last")."""
    proj = project(params, cam, sh_degree)
    bins = Binning(proj, cam["width"], cam["height"])
    out = dict(pairs=bins.num_pairs, live=bins.live_pairs, dense=bins.num_dense,
               evaluated=0, contributing=0, up_to_last=0)
    for tiles, m in bins.blocks():
        c = _block_counts(tiles, m, bins, proj["means2d"], proj["conic"], proj["opac"])
        for k, v in c.items():
            out[k] += v
    return out
