"""Reference MinkUNet34A: a frozen copy of the port's plain-torch sparse
UNet (semantic_gaussians_torch/models/unet3d.py, without its checkpoint
conversion), kept here so that a later change to the program cannot
change the yardstick. Voxels in a capacity-padded list; each convolution
a loop over kernel offsets of gather, float32 matmul and index_add_;
BatchNorm over alive voxels; weights drawn from a seed as the program
draws them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

# ---------------------------------------------------------------------------
# Topology
# ---------------------------------------------------------------------------
GRID_BITS = 10  # 1024^3 voxel grid (20 m rooms at 2 cm); keys fit int32
GRID_MAX = (1 << GRID_BITS) - 3  # max valid coord before the +2 key shift
_BIG = 2**31 - 1  # key of masked rows and off-grid probes


def validate_coords(coords, mask) -> None:
    """Host-side guard for the int32 key packing: `_linearize` clips coords
    to the 2**GRID_BITS grid, so distinct voxels beyond the bound would
    silently collide into one key. Raises on live coords outside
    [-2, GRID_MAX)."""
    c = coords.cpu().numpy() if isinstance(coords, torch.Tensor) else np.asarray(coords)
    m = (mask.cpu().numpy() if isinstance(mask, torch.Tensor) else np.asarray(mask)).astype(bool)
    if m.any():
        mn, mx = int(c[m].min()), int(c[m].max())
        if mx >= GRID_MAX or mn < -2:
            raise ValueError(
                f"voxel coords span [{mn}, {mx}] but the int32 key packing "
                f"supports [-2, {GRID_MAX}); shift coords to the voxel min "
                f"and/or reduce the random global shift (scene too large for "
                f"the {1 << GRID_BITS}^3 grid at this voxel size)"
            )


def _linearize(coords: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[..., 3] int32 -> sortable int32 keys; masked rows and off-grid
    probes get _BIG (clipping alone would alias a probe at -3 onto a real
    voxel at -2)."""
    shifted = coords + 2
    in_range = mask & torch.all((shifted >= 0) & (shifted < (1 << GRID_BITS)), dim=-1)
    c = torch.clamp(shifted, 0, (1 << GRID_BITS) - 1)
    key = (c[..., 0] << (2 * GRID_BITS)) | (c[..., 1] << GRID_BITS) | c[..., 2]
    return torch.where(in_range, key, torch.full_like(key, _BIG)).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class LevelTopology:
    coords: torch.Tensor  # [V, 3] int32
    mask: torch.Tensor  # [V] bool
    nbr: torch.Tensor  # [K, V] int64 neighbour row (V = missing)
    sorted_keys: torch.Tensor  # [V] int32 packed keys (for joins)
    sorted_perm: torch.Tensor  # [V] int64


@dataclasses.dataclass(frozen=True)
class DownLink:
    """child level -> parent level."""

    parent_of: torch.Tensor  # [V] int64 parent row (V = none)
    octant: torch.Tensor  # [V] int32 in [0, 8): child offset within parent


@dataclasses.dataclass(frozen=True)
class Topology:
    levels: Tuple[LevelTopology, ...]
    links: Tuple[DownLink, ...]  # len == len(levels) - 1


def _offsets(kernel_size: int) -> np.ndarray:
    r = range(-(kernel_size // 2), kernel_size // 2 + 1)
    return np.array([[i, j, k] for i in r for j in r for k in r], np.int32)


def _build_level(coords: torch.Tensor, mask: torch.Tensor, kernel_size: int = 3) -> LevelTopology:
    """Neighbour map of one level: all K offsets probed at once."""
    v = coords.shape[0]
    keys = _linearize(coords, mask)
    perm = torch.argsort(keys, stable=True)  # jnp.argsort is stable
    sorted_keys = keys[perm]
    offs = torch.from_numpy(_offsets(kernel_size)).to(coords.device)
    nk = _linearize(coords[None] + offs[:, None, :], mask[None])  # [K, V]
    pos = torch.searchsorted(sorted_keys, nk.reshape(-1)).reshape(nk.shape)  # left side
    pos_c = torch.clamp(pos, 0, v - 1)
    # nk != _BIG: an off-grid probe's sentinel would otherwise MATCH a
    # masked-out padding row's sentinel key and join a live voxel to a dead
    # row (whose feature row is the caller's, not the zero missing row V)
    found = (sorted_keys[pos_c] == nk) & mask[None] & (nk != _BIG)
    nbr = torch.where(found, perm[pos_c], torch.full_like(pos_c, v))
    return LevelTopology(coords, mask, nbr, sorted_keys, perm)


def _downsample(level: LevelTopology):
    """Parent coords (floor / 2, deduplicated, compacted to the front) and
    the child -> parent link."""
    coords, mask = level.coords, level.mask
    v = coords.shape[0]
    dev = coords.device
    pcoords = torch.where(
        mask[:, None], torch.div(coords, 2, rounding_mode="floor"), torch.zeros_like(coords)
    ).to(torch.int32)
    pkeys = _linearize(pcoords, mask)
    order = torch.argsort(pkeys, stable=True)
    sk = pkeys[order]
    is_first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), sk[1:] != sk[:-1]])
    is_first = is_first & (sk != _BIG)
    dest = torch.cumsum(is_first.to(torch.int64), 0) - 1
    n_parents = is_first.sum()
    # Non-first rows scatter the NEUTRAL (below any valid coord, which can
    # be as low as -2), so the max never corrupts a negative parent coord.
    # With no live row at all every dest is -1: clamped to 0, it carries
    # only neutrals, and no parent is masked in.
    neutral = -(1 << 30)
    vals = torch.where(is_first[:, None], pcoords[order], torch.full_like(pcoords, neutral))
    parent_coords = torch.full((v, 3), neutral, dtype=torch.int32, device=dev)
    parent_coords.scatter_reduce_(
        0, torch.clamp(dest, min=0)[:, None].expand(v, 3), vals, "amax", include_self=True
    )
    parent_mask = torch.arange(v, device=dev) < n_parents
    parent_coords = torch.where(parent_mask[:, None], parent_coords, torch.zeros_like(parent_coords))
    parent_of = torch.empty(v, dtype=torch.int64, device=dev)
    parent_of[order] = dest  # each child's parent: the run id of its sorted position
    parent_of = torch.where(mask, parent_of, torch.full_like(parent_of, v))
    oct_xyz = torch.where(mask[:, None], coords - pcoords * 2, torch.zeros_like(coords))
    octant = (oct_xyz[:, 0] * 4 + oct_xyz[:, 1] * 2 + oct_xyz[:, 2]).to(torch.int32)
    return parent_coords, parent_mask, DownLink(parent_of, octant)


def build_topology(
    coords: torch.Tensor, mask: torch.Tensor, num_levels: int = 5, stem_kernel: int = 5
) -> Topology:
    """Every neighbour / pooling map of a voxel set, on the coords' device.
    Level 0 gets the stem's k=5 map (its centre 27 rows are the k=3 map),
    the others k=3."""
    validate_coords(coords, mask)
    levels, links = [], []
    cur_c, cur_m = coords.to(torch.int32), mask.to(torch.bool)
    for li in range(num_levels):
        lvl = _build_level(cur_c, cur_m, kernel_size=stem_kernel if li == 0 else 3)
        levels.append(lvl)
        if li < num_levels - 1:
            cur_c, cur_m, link = _downsample(lvl)
            links.append(link)
    return Topology(tuple(levels), tuple(links))


def _center27_rows(stem_kernel: int) -> np.ndarray:
    """Row indices of the 3x3x3 offsets within the k=5 offset list."""
    offs5 = _offsets(stem_kernel)
    return np.array(
        [int(np.where((offs5 == o).all(axis=1))[0][0]) for o in _offsets(3)], np.int64
    )


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------
class _OffsetConv(torch.autograd.Function):
    """sum_k feats_pad[nbr[k]] @ w[k] with a memory-flat backward.

    Autograd over the loop would save each offset's gathered rows: a
    (K, V, Cin) residual per conv (5.5 GB at K = 27, V = 200k, C = 256).
    The backward re-gathers from the saved (V + 1, Cin) input instead:
    dfeats is an index_add_ of dout @ w_k^T, dw_k = feats_pad[nbr_k]^T @ dout.
    """

    @staticmethod
    def forward(ctx, feats_pad, nbr, w):
        out = feats_pad.new_zeros((nbr.shape[1], w.shape[2]))
        for k in range(nbr.shape[0]):
            out.addmm_(feats_pad.index_select(0, nbr[k]), w[k])
        ctx.save_for_backward(feats_pad, nbr, w)
        return out

    @staticmethod
    def backward(ctx, dout):
        feats_pad, nbr, w = ctx.saved_tensors
        dout = dout.contiguous()
        dfp = torch.zeros_like(feats_pad)
        dw = torch.empty_like(w)
        for k in range(nbr.shape[0]):
            dfp.index_add_(0, nbr[k], dout @ w[k].T)
            torch.mm(feats_pad.index_select(0, nbr[k]).T, dout, out=dw[k])
        return dfp, None, dw


def _he_normal_(w: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]):
    """Flax's he_normal: a normal truncated at +-2 std, variance 2 / fan_in
    after truncation."""
    std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


def _lecun_dense(cin: int, cout: int, bias: bool, generator) -> nn.Linear:
    """nn.Linear with Flax Dense's init: lecun_normal kernel, zero bias."""
    lin = nn.Linear(cin, cout, bias=bias)
    with torch.no_grad():
        std = math.sqrt(1.0 / cin) / 0.87962566103423978
        nn.init.trunc_normal_(lin.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
        if bias:
            lin.bias.zero_()
    return lin


class SparseConv(nn.Module):
    """k^3 sparse conv over a level's neighbour map (or a subset of its
    rows, e.g. the centre 27 of 125)."""

    def __init__(self, in_channels, out_channels, kernel_volume, rows=None, *, generator=None):
        super().__init__()
        self.register_buffer(
            "rows", None if rows is None else torch.as_tensor(rows, dtype=torch.int64),
            persistent=False)
        self.kernel = nn.Parameter(torch.empty((kernel_volume, in_channels, out_channels)))
        with torch.no_grad():
            _he_normal_(self.kernel, kernel_volume * in_channels, generator)

    def forward(self, feats: torch.Tensor, level: LevelTopology) -> torch.Tensor:
        nbr = level.nbr if self.rows is None else level.nbr[self.rows]
        feats_pad = torch.cat([feats, feats.new_zeros((1, feats.shape[1]))], dim=0)
        return _OffsetConv.apply(feats_pad, nbr, self.kernel) * level.mask[:, None]


def _octant_matmul(x: torch.Tensor, octant: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_o where(octant == o, x, 0) @ w[o]. Not an einsum over
    w[octant]: gathering the weights materializes (V, Cin, Cout), 52 GB at
    a 200k-voxel budget with 256-wide layers. Eight masked dense matmuls
    keep memory O(V C) (a 4x operation overcount on average)."""
    out = None
    for o in range(8):
        y = torch.where((octant == o)[:, None], x, 0.0) @ w[o]
        out = y if out is None else out + y
    return out


class SparseConvDown(nn.Module):
    """k=2 s=2 conv: octant-decomposed scatter-add into parents."""

    def __init__(self, in_channels, out_channels, *, generator=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty((8, in_channels, out_channels)))
        with torch.no_grad():
            _he_normal_(self.kernel, 8 * in_channels, generator)

    def forward(self, feats, link: DownLink, parent_level: LevelTopology):
        v = feats.shape[0]
        contrib = _octant_matmul(feats, link.octant, self.kernel)
        out = feats.new_zeros((v + 1, contrib.shape[1])).index_add(0, link.parent_of, contrib)
        return out[:v] * parent_level.mask[:, None]


class SparseConvUp(nn.Module):
    """k=2 s=2 transpose conv: children gather their parent's features."""

    def __init__(self, in_channels, out_channels, *, generator=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty((8, in_channels, out_channels)))
        with torch.no_grad():
            _he_normal_(self.kernel, 8 * in_channels, generator)

    def forward(self, parent_feats, link: DownLink, child_level: LevelTopology):
        pf = torch.cat([parent_feats, parent_feats.new_zeros((1, parent_feats.shape[1]))], dim=0)
        g = pf.index_select(0, link.parent_of)
        return _octant_matmul(g, link.octant, self.kernel) * child_level.mask[:, None]


class MaskedBatchNorm(nn.Module):
    """BatchNorm over alive voxels (ME.MinkowskiBatchNorm analogue). In
    training mode the batch mean and biased variance are taken over alive
    rows and the running stats follow ra = 0.9 ra + 0.1 batch; in eval mode
    the running stats normalize."""

    def __init__(self, channels, momentum=0.9, eps=1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, feats, mask):
        if self.training:
            m = mask.to(feats.dtype)[:, None]
            n = torch.clamp(m.sum(), min=1.0)
            mean = torch.sum(feats * m, dim=0) / n
            var = torch.sum(m * (feats - mean) ** 2, dim=0) / n
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_((1 - self.momentum) * mean)
                self.var.mul_(self.momentum).add_((1 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        out = (feats - mean) * torch.rsqrt(var + self.eps) * self.scale + self.bias
        return out * mask[:, None]


class BasicBlock(nn.Module):
    """Residual block: conv-bn-relu-conv-bn + skip (resnet_base.py); the
    skip is a bias-free dense layer + bn when the width changes."""

    def __init__(self, in_channels, channels, kernel_volume, rows=None, *, generator=None):
        super().__init__()
        self.conv1 = SparseConv(in_channels, channels, kernel_volume, rows, generator=generator)
        self.bn1 = MaskedBatchNorm(channels)
        self.conv2 = SparseConv(channels, channels, kernel_volume, rows, generator=generator)
        self.bn2 = MaskedBatchNorm(channels)
        if in_channels != channels:
            self.proj = _lecun_dense(in_channels, channels, False, generator)
            self.proj_bn = MaskedBatchNorm(channels)
        else:
            self.proj = self.proj_bn = None

    def call_order(self) -> Iterator[nn.Module]:
        yield from (self.conv1, self.bn1, self.conv2, self.bn2)
        if self.proj is not None:
            yield from (self.proj, self.proj_bn)

    def forward(self, x, level: LevelTopology):
        identity = x
        y = torch.relu(self.bn1(self.conv1(x, level), level.mask))
        y = self.bn2(self.conv2(y, level), level.mask)
        if self.proj is not None:
            identity = self.proj_bn(self.proj(identity), level.mask)
        return torch.relu(y + identity) * level.mask[:, None]


_VARIANTS = {
    # name: (planes, layers) — mink_unet.py:169-231
    "MinkUNet14A": ((32, 64, 128, 256, 128, 128, 96, 96), (1, 1, 1, 1, 1, 1, 1, 1)),
    "MinkUNet14B": ((32, 64, 128, 256, 128, 128, 128, 128), (1, 1, 1, 1, 1, 1, 1, 1)),
    "MinkUNet14C": ((32, 64, 128, 256, 192, 192, 128, 128), (1, 1, 1, 1, 1, 1, 1, 1)),
    "MinkUNet14D": ((32, 64, 128, 256, 384, 384, 384, 384), (1, 1, 1, 1, 1, 1, 1, 1)),
    "MinkUNet18A": ((32, 64, 128, 256, 128, 128, 96, 96), (2, 2, 2, 2, 2, 2, 2, 2)),
    "MinkUNet18B": ((32, 64, 128, 256, 128, 128, 128, 128), (2, 2, 2, 2, 2, 2, 2, 2)),
    "MinkUNet18D": ((32, 64, 128, 256, 384, 384, 384, 384), (2, 2, 2, 2, 2, 2, 2, 2)),
    "MinkUNet34A": ((32, 64, 128, 256, 256, 128, 96, 96), (2, 3, 4, 6, 2, 2, 2, 2)),
    "MinkUNet34B": ((32, 64, 128, 256, 256, 128, 64, 32), (2, 3, 4, 6, 2, 2, 2, 2)),
    "MinkUNet34C": ((32, 64, 128, 256, 256, 128, 96, 96), (2, 3, 4, 6, 2, 2, 2, 2)),
}
_INIT_DIM = 32
_STEM_KERNEL = 5


class _Stage(nn.Module):
    """One encoder level (down conv, bn, blocks) or decoder level (up conv,
    bn, skip concat, blocks)."""

    def __init__(self, conv, bn, blocks):
        super().__init__()
        self.conv, self.bn, self.blocks = conv, bn, nn.ModuleList(blocks)


class MinkUNet(nn.Module):
    """4-level sparse UNet over a precomputed Topology. Training mode
    (`.train()`) normalizes by batch statistics and updates the running
    ones; eval mode uses the running ones."""

    def __init__(self, in_channels, out_channels, variant="MinkUNet34A", *,
                 seed: int = 0, device=None):
        super().__init__()
        self.in_channels, self.out_channels, self.variant = in_channels, out_channels, variant
        planes, layers = _VARIANTS[variant]
        # drawn on the CPU from one generator, then moved to `device`
        g = torch.Generator(device="cpu").manual_seed(seed)
        k5, k3 = _STEM_KERNEL**3, 27
        self.stem = SparseConv(in_channels, _INIT_DIM, k5, generator=g)
        self.stem_bn = MaskedBatchNorm(_INIT_DIM)
        enc, width, skips = [], _INIT_DIM, [_INIT_DIM]
        for i in range(4):
            blocks = []
            for b in range(layers[i]):
                blocks.append(BasicBlock(width if b == 0 else planes[i], planes[i], k3, generator=g))
            enc.append(_Stage(SparseConvDown(width, width, generator=g), MaskedBatchNorm(width),
                              blocks))
            width = planes[i]
            skips.append(width)
        dec = []
        c27 = _center27_rows(_STEM_KERNEL)
        for i in range(4):
            plane, skip = planes[4 + i], skips[3 - i]
            rows = c27 if i == 3 else None
            blocks = [BasicBlock(plane + skip if b == 0 else plane, plane, k3, rows, generator=g)
                      for b in range(layers[4 + i])]
            dec.append(_Stage(SparseConvUp(width, plane, generator=g), MaskedBatchNorm(plane),
                              blocks))
            width = plane
        self.enc, self.dec = nn.ModuleList(enc), nn.ModuleList(dec)
        self.head = _lecun_dense(width, out_channels, True, g)
        if device is not None:
            self.to(device)

    def call_order(self) -> Iterator[nn.Module]:
        """The direct submodules in the order forward() calls them (the
        order Flax numbers them in)."""
        yield from (self.stem, self.stem_bn)
        for st in list(self.enc) + list(self.dec):
            yield from (st.conv, st.bn, *st.blocks)
        yield self.head

    def forward(self, feats: torch.Tensor, topo: Topology) -> torch.Tensor:
        levels, links = topo.levels, topo.links
        x = torch.relu(self.stem_bn(self.stem(feats, levels[0]), levels[0].mask))
        skips = [x]
        for i, st in enumerate(self.enc):
            lvl = levels[i + 1]
            x = torch.relu(st.bn(st.conv(x, links[i], lvl), lvl.mask))
            for blk in st.blocks:
                x = blk(x, lvl)
            skips.append(x)
        for i, st in enumerate(self.dec):
            lvl = levels[3 - i]
            y = torch.relu(st.bn(st.conv(x, links[3 - i], lvl), lvl.mask))
            x = torch.cat([y, skips[3 - i]], dim=-1)
            for blk in st.blocks:
                x = blk(x, lvl)
        return self.head(x) * levels[0].mask[:, None]


def mink_unet(in_channels=3, out_channels=20, arch="MinkUNet34A", *, seed=0,
              device=None) -> MinkUNet:
    """Factory, mirroring mink_unet.py:234-256; weights drawn from `seed`."""
    return MinkUNet(in_channels, out_channels, arch, seed=seed, device=device)
