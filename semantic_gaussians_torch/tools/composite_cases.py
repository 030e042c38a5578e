"""Small adversarial inputs for the two composite kernels, made with numpy
from a seed. The CPU tests run the plain versions on them against the JAX
package's kernel and its VJP; chip_smoke.py runs the kernels on them against
the plain versions on the card. One generator, so both see the same data.

A case is a handful of tiles, each with its own list of Gaussians (in the
order the compositor walks them), placed so as to reach an edge of either
kernel's design:
  * empty tiles beside full ones, an all-empty frame, a one-pair tile;
  * tile ranges one pair short of, on and one past the batch and segment
    sizes of the old and the new kernels (32, 64, 128, 256, 512 pairs);
  * pixels that terminate as early as the 0.99 alpha cap allows (their third
    pair), so that whole blocks leave after their first batch;
  * a tile whose largest n_contrib belongs to one pixel of the last warp;
  * alphas on either side of 1/255, opacity exactly 1/255 and power exactly
    0 at a pixel centre;
  * Gaussians whose footprint covers a single pixel row, or ends within a
    hair of the next row (the edge of the kernels' row skip), tilted or not;
  * channel counts on every channel-block edge of either design (1, 3, 4,
    5, 8, 9, 31, 32, 33, 64), and tile shapes with fewer pixels than a
    batch has pairs (96, 128), or whose rows are 64 pixels wide.
"""
from __future__ import annotations

from typing import Iterator, List, NamedTuple, Sequence, Tuple

import numpy as np

ALPHA_CUTOFF = np.float32(1.0 / 255.0)
CHANNEL_EDGES = (1, 3, 4, 5, 8, 9, 31, 32, 33, 64)


class CompositeCase(NamedTuple):
    name: str
    geom: np.ndarray  # [N, 8] float32: mx, my, conic a, b, c, opacity, depth, 0
    colors: np.ndarray  # [N, C] float32
    pair_gaussian: np.ndarray  # [P] int32, tile after tile (P >= the pairs in ranges)
    tile_start: np.ndarray  # [T] int32
    tile_count: np.ndarray  # [T] int32
    bg: np.ndarray  # [C] float32
    g_color: np.ndarray  # [T, C, PX] float32, the backward's upstream gradient
    grid_h: int
    grid_w: int
    tile_h: int
    tile_w: int

    @property
    def num_channels(self) -> int:
        return self.colors.shape[1]


def conic(sx, sy, theta) -> Tuple[float, float, float]:
    """(a, b, c) of the inverse of R diag(sx^2, sy^2) R^T."""
    c, s = np.cos(theta), np.sin(theta)
    rot = np.array([[c, -s], [s, c]])
    inv = rot @ np.diag([1.0 / sx**2, 1.0 / sy**2]) @ rot.T
    return inv[0, 0], inv[0, 1], inv[1, 1]


def gaussian(mx, my, sx, sy, theta=0.0, op=0.5) -> List[float]:
    a, b, c = conic(sx, sy, theta)
    return [mx, my, a, b, c, op]


def random_gaussians(rng, n, x0, y0, tile_h, tile_w, scale=(1.0, 6.0), op=(0.05, 0.9)):
    """n Gaussians around the tile whose top-left pixel is (x0, y0)."""
    out = []
    for _ in range(n):
        out.append(gaussian(
            x0 + rng.uniform(-4, tile_w + 4), y0 + rng.uniform(-4, tile_h + 4),
            rng.uniform(*scale), rng.uniform(*scale), rng.uniform(0, np.pi),
            rng.uniform(*op)))
    return out


def build(name, per_tile: Sequence[Sequence[Sequence[float]]], num_ch, grid, tile=(16, 32),
          seed=0, slack=37) -> CompositeCase:
    """A case from one list of Gaussians (mx, my, a, b, c, op) per tile, in
    walking order; each tile's Gaussians get their own ids, their depth is
    their position in the list. `slack` pair slots after the last range
    belong to no tile."""
    rng = np.random.default_rng(seed)
    gh, gw = grid
    th, tw = tile
    assert len(per_tile) == gh * gw
    rows, ids, counts = [], [], []
    for gs in per_tile:
        counts.append(len(gs))
        for k, g in enumerate(gs):
            ids.append(len(rows))
            rows.append(list(g) + [1.0 + 0.01 * k, 0.0])
    n = max(len(rows), 1)
    geom = np.zeros((n, 8), np.float32)
    if rows:
        geom[:len(rows)] = np.asarray(rows, np.float32)
    counts = np.asarray(counts, np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    pair_gaussian = np.zeros(len(ids) + slack, np.int32)
    pair_gaussian[:len(ids)] = ids
    colors = rng.uniform(-1.0, 1.0, size=(n, num_ch)).astype(np.float32)
    bg = np.linspace(0.1, 0.4, num_ch).astype(np.float32)
    g_color = rng.normal(size=(gh * gw, num_ch, th * tw)).astype(np.float32)
    return CompositeCase(name, geom, colors, pair_gaussian, starts, counts, bg, g_color,
                         gh, gw, th, tw)


def _origins(grid, tile):
    gh, gw = grid
    th, tw = tile
    return [(tx * tw, ty * th) for ty in range(gh) for tx in range(gw)]


def composite_cases(seed: int = 0, extra_channels: Sequence[int] = ()) -> Iterator[CompositeCase]:
    """Every case; `extra_channels` adds channel counts to the shared
    channel scene (chip_smoke.py adds 768)."""
    rng = np.random.default_rng(seed)
    th, tw = 16, 32

    def rand(n, x0, y0, **kw):
        return random_gaussians(rng, n, x0, y0, th, tw, **kw)

    # Empty tiles beside full ones, and a frame with no pairs at all.
    grid = (2, 2)
    org = _origins(grid, (th, tw))
    yield build("empty_tiles", [[], rand(40, *org[1]), [], rand(7, *org[3])], 3, grid, seed=1)
    yield build("all_empty", [[], [], [], []], 3, grid, seed=2, slack=0)
    # One pair in a tile (and one in a second tile, far from its pixels).
    yield build("one_pair", [[gaussian(10.5, 7.0, 3.0, 2.0, 0.3, 0.8)], [],
                             [gaussian(-30.0, 40.0, 2.0, 2.0, 0.0, 0.9)], []], 3, grid, seed=3)
    # Ranges around every batch / segment size of either kernel: low opacity,
    # so that few pixels terminate and the walks reach the range ends.
    grid = (2, 3)
    org = _origins(grid, (th, tw))
    sizes = (31, 33, 63, 65, 127, 129)
    yield build("batch_edges_small", [rand(s, *o, op=(0.02, 0.12)) for s, o in zip(sizes, org)],
                3, grid, seed=4)
    grid = (1, 3)
    org = _origins(grid, (th, tw))
    sizes = (255, 257, 513)
    yield build("batch_edges_large", [rand(s, *o, scale=(0.8, 3.0), op=(0.01, 0.06))
                                      for s, o in zip(sizes, org)], 3, grid, seed=5)
    # Every pixel terminates on its third pair (opacity 0.98 under the 0.99
    # cap: T = 0.02, 4e-4, then 8e-6 < 1e-4), with 300 pairs behind.
    grid = (1, 2)
    org = _origins(grid, (th, tw))
    tiles = []
    for x0, y0 in org:
        front = [gaussian(x0 + 15.5 + d, y0 + 7.5, 400.0, 400.0, 0.0, 0.98) for d in (0, 1, 2)]
        tiles.append(front + rand(300, x0, y0))
    yield build("early_exit", tiles, 3, grid, seed=6)
    # The largest n_contrib at one pixel of the last warp: faint wide
    # Gaussians over the tile, then small ones at the bottom-right pixel.
    wide = [gaussian(16.0 + rng.uniform(-8, 8), 8.0 + rng.uniform(-4, 4), 30.0, 30.0, 0.0, 0.03)
            for _ in range(60)]
    corner = [gaussian(31.0, 15.0, 0.35, 0.35, 0.0, 0.2) for _ in range(20)]
    yield build("last_warp_holds_max", [wide + corner], 3, (1, 1), seed=7)
    # Alphas about 1/255: opacity exactly 1/255 and just below, centred on a
    # pixel (power exactly 0 there); a wide faint splat whose alpha crosses
    # 1/255 across the tile; power 0 at a pixel centre with high opacity.
    edge = [
        gaussian(5.0, 3.0, 2.0, 2.0, 0.0, float(ALPHA_CUTOFF)),
        gaussian(9.0, 4.0, 2.0, 2.0, 0.0, float(np.nextafter(ALPHA_CUTOFF, np.float32(0)))),
        gaussian(20.0, 9.0, 6.0, 4.0, 0.4, 0.0080),
        gaussian(12.0, 12.0, 1.5, 1.5, 0.0, 0.9),
        gaussian(12.0, 12.0, 3.0, 1.0, 1.1, 0.05),
    ] + rand(40, 0, 0)
    yield build("alpha_edges", [edge], 3, (1, 1), seed=8)
    # Footprints of one pixel row: sigma_y 0.3 (rows +-1 have power
    # -0.5 / 0.09 < ln(1 / (255 op))), tilted and not; and ellipses whose
    # candidate region ends within 1e-4 of the next row's centre.
    one_row = []
    for r, theta in ((0, 0.0), (5, 0.0), (15, 0.0), (7, 0.05), (9, np.pi / 2 - 0.02)):
        sx, sy = (6.0, 0.3) if theta < 1.0 else (0.3, 6.0)
        one_row.append(gaussian(16.0 + r % 7, float(r), sx, sy, theta, 0.9))
    for op, r in ((0.5, 3), (0.9, 10)):
        lim = np.log(255.0 * op)  # power reaches -lim at dy where dy^2 / (2 sy^2) = lim
        for eps in (-1e-4, 1e-4):
            sy = 1.0 / np.sqrt(2.0 * lim) * (1.0 + eps)
            one_row.append(gaussian(11.0, float(r), 5.0, sy, 0.0, op))
    yield build("one_row_footprints", [one_row + rand(30, 0, 0)], 3, (1, 1), seed=9)
    # Channel counts on every channel-block edge, on one shared scene.
    grid = (2, 2)
    org = _origins(grid, (th, tw))
    scene = [rand(n, *o) for n, o in zip((70, 1, 130, 33), org)]
    for c in CHANNEL_EDGES + tuple(extra_channels):
        yield build(f"channels_{c}", scene, c, grid, seed=10 + c)
    # Tiles of 96 pixels (not a multiple of 128) and of 8 x 64.
    for tile, c in (((3, 32), 3), ((3, 32), 9), ((4, 32), 5), ((8, 64), 3), ((8, 64), 33)):
        grid = (2, 2)
        org = _origins(grid, tile)
        per = [random_gaussians(rng, n, x0, y0, *tile) for n, (x0, y0) in zip((50, 0, 9, 140), org)]
        yield build(f"tile_{tile[0]}x{tile[1]}_c{c}", per, c, grid, tile=tile, seed=30 + c)


def case_names() -> List[str]:
    return [c.name for c in composite_cases()]
