"""Small adversarial inputs for the pair-expand kernel, made with numpy from
a seed. The CPU tests hold the plain version against the JAX package's
kernel on them, bit for bit; chip_smoke.py holds the CUDA kernel against the
plain version on the card. One generator, so both see the same data.

A case is a depth-ordered Gaussian table as binning builds it: emitting
Gaussians first, each owning w x h consecutive pair slots (its tile rect),
zero-count ones last with offset = total, offsets clamped to budget + 1.
The cases sit on the edges of csrc/expand.cu's design, whose blocks take
CHUNK consecutive slots, SLOTS_PER_THREAD a thread, and stage the owners of
their valid slots (at most CHUNK) as a window:
  * a chunk that starts in the middle of a Gaussian's run, and runs that
    cross thread and chunk edges;
  * one Gaussian whose run spans several whole chunks (a rect as wide as
    the grid);
  * chunks of count-1 Gaussians only, and a chunk whose window is exactly
    CHUNK owners (the widest);
  * num_pairs inside a thread's slots and inside a run, on an overflowing
    budget (later offsets clamped to budget + 1) and on one that is not;
    num_pairs = 0 and num_pairs = budget without overflow;
  * budgets that are not a multiple of 4, of 512 (the JAX kernel's chunk)
    or of CHUNK; n = 1;
  * rect widths 1 and the grid's width;
  * cull values whose qn lies within a few ulps of TIGHTCULL_MARGIN, tiles
    with the mean inside, e1 = 0, e0 and e2 below the 1e-20 clamp.
Every case carries a cull table; the tests run each with the cull on and
off.
"""
from __future__ import annotations

from typing import Iterator, List, NamedTuple, Sequence, Tuple

import numpy as np

from ..ops.expand import CHUNK, TIGHTCULL_MARGIN

TILE_H, TILE_W = 16, 32
GRID = (48, 64)  # (rows, columns) of tiles: a 2048x768 image


class ExpandCase(NamedTuple):
    name: str
    offsets: np.ndarray  # [n] int32 exclusive cumsum of counts, clamped to budget + 1
    rect: np.ndarray  # [n] int32 x0 << 16 | y0 << 8 | w
    idx: np.ndarray  # [n] int32 original Gaussian ids (a permutation)
    cull: np.ndarray  # [5, n] float32 mean_x, mean_y, e0, e1, e2
    num_pairs: int
    num_dense: int
    budget: int
    grid_h: int
    grid_w: int

    @property
    def n(self) -> int:
        return self.offsets.shape[0]

    def torch_args(self, cull: bool, device="cpu") -> tuple:
        """expand_pairs' arguments for this case, on `device`."""
        import torch

        def t(a):
            return torch.from_numpy(a).to(device)

        return (t(self.offsets), t(self.rect), t(self.idx), t(self.cull) if cull else None,
                torch.tensor(self.num_pairs, dtype=torch.int32, device=device),
                torch.tensor(self.num_dense, dtype=torch.int32, device=device),
                self.budget, self.grid_w, self.grid_w * self.grid_h, self.n, TILE_W, TILE_H)


def random_cull(rng, x0, y0, w, h) -> np.ndarray:
    """[5, n] cull rows: each mean inside its rect's pixel box, each form
    positive definite and about as wide as the rect, so that corner tiles
    are culled now and then."""
    mx = (x0 + rng.uniform(0.2, 0.8, x0.size) * w) * TILE_W
    my = (y0 + rng.uniform(0.2, 0.8, y0.size) * h) * TILE_H
    e0 = rng.uniform(0.7, 1.6, x0.size) / (0.5 * w * TILE_W) ** 2
    e2 = rng.uniform(0.7, 1.6, y0.size) / (0.5 * h * TILE_H) ** 2
    e1 = rng.uniform(-0.9, 0.9, x0.size) * np.sqrt(e0 * e2)
    return np.stack([mx, my, e0, e1, e2]).astype(np.float32)


def build(name, rects: Sequence[Tuple[int, int, int, int]], budget, seed, zeros=0,
          cull=None, grid=GRID) -> ExpandCase:
    """A case from the emitting Gaussians' tile rects (x0, y0, w, h) in depth
    order, each owning w * h slots, then `zeros` zero-count Gaussians. The
    cull rows are `cull` (emitting Gaussians only) or random_cull's."""
    rng = np.random.default_rng(seed)
    r = np.asarray(rects, np.int64).reshape(-1, 4)
    x0, y0, w, h = r.T
    if ((x0 + w > grid[1]) | (y0 + h > grid[0]) | (w < 1) | (h < 1)).any():
        raise ValueError(f"{name}: a rect leaves the {grid} grid")
    zx = rng.integers(0, grid[1], zeros)
    zy = rng.integers(0, grid[0], zeros)
    counts = np.concatenate([w * h, np.zeros(zeros, np.int64)])
    cum = np.cumsum(counts)
    total = int(cum[-1]) if counts.size else 0
    packed = np.concatenate([(x0 << 16) | (y0 << 8) | w, (zx << 16) | (zy << 8) | 1])
    rows = random_cull(rng, x0, y0, w, h) if cull is None else np.asarray(cull, np.float32)
    zrows = random_cull(rng, zx, zy, np.ones(zeros), np.ones(zeros))
    return ExpandCase(
        name=name,
        offsets=np.minimum(cum - counts, budget + 1).astype(np.int32),
        rect=packed.astype(np.int32),
        idx=rng.permutation(counts.size).astype(np.int32),
        cull=np.concatenate([rows, zrows], axis=1),
        num_pairs=min(total, budget), num_dense=int((counts > 0).sum()),
        budget=budget, grid_h=grid[0], grid_w=grid[1],
    )


def small_rects(rng, k, max_w=4, max_h=3, grid=GRID) -> List[Tuple[int, int, int, int]]:
    """k random rects of 1..max_w x 1..max_h tiles inside the grid."""
    w = rng.integers(1, max_w + 1, k)
    h = rng.integers(1, max_h + 1, k)
    x0 = rng.integers(0, grid[1] - w + 1)
    y0 = rng.integers(0, grid[0] - h + 1)
    return list(zip(x0, y0, w, h))


def fill(rng, slots, width=3) -> List[Tuple[int, int, int, int]]:
    """Rects of width x 1 tiles (the last one narrower) owning `slots` slots."""
    out = []
    while slots > 0:
        w = min(width, slots)
        out.append((int(rng.integers(0, GRID[1] - w + 1)), int(rng.integers(0, GRID[0])), w, 1))
        slots -= w
    return out


def margin_forms() -> Tuple[np.ndarray, np.ndarray]:
    """e0 values whose qn at a tile edge 10 px from the mean, e1 = 0,
    (qn = (e0 * 10) * 10 in float32) steps through TIGHTCULL_MARGIN ulp by
    ulp, and those qn values."""
    margin = np.float32(TIGHTCULL_MARGIN)
    base = np.float32(margin / np.float32(100.0))
    e0 = [base]
    for _ in range(6):
        e0.insert(0, np.nextafter(e0[0], np.float32(0)))
        e0.append(np.nextafter(e0[-1], np.float32(1)))
    e0 = np.asarray(e0, np.float32)
    return e0, (e0 * np.float32(10.0)) * np.float32(10.0)


def cull_edge_case(seed) -> ExpandCase:
    """Gaussians of 2 x 1 tiles: the mean 10 px left of the second tile, in
    the first (qn = 0 there) and at its vertical centre, e1 = 0, e0 from
    margin_forms (the second tile's qn within a few ulps of the margin);
    then 3 x 3-tile Gaussians centred on their middle tile whose e0 / e2
    lie below the 1e-20 clamp (0, 1e-30) with e1 zero or not."""
    e0, _ = margin_forms()
    rects, rows = [], []
    for i, e in enumerate(e0):
        x0, y0 = 2 * (i % 20), 3 + 2 * (i // 20)
        rects.append((x0, y0, 2, 1))
        rows.append(((x0 + 1) * TILE_W - 10.0, y0 * TILE_H + 8.0, e, 0.0, 1.0 / 64.0))
    tiny = (0.0, 1e-30)
    k = 0
    for a in tiny + (1e-3,):
        for c in tiny + (1e-3,):
            for b in (0.0, 1e-3, -2e-4):
                if a >= 1e-3 and c >= 1e-3:
                    continue
                x0, y0 = 3 * (k % 20), 20 + 3 * (k // 20)
                rects.append((x0, y0, 3, 3))
                rows.append(((x0 + 1.5) * TILE_W, (y0 + 1.5) * TILE_H, a, b, c))
                k += 1
    rng = np.random.default_rng(seed)
    filler = np.asarray(fill(rng, 40)).T
    cull = np.concatenate([np.asarray(rows).T, random_cull(rng, *filler)], axis=1)
    return build("cull-edges", rects + list(zip(*filler)), 512, seed, zeros=5, cull=cull)


def expand_cases(seed: int = 0) -> Iterator[ExpandCase]:
    rng = np.random.default_rng(seed)
    c = CHUNK
    yield build("random", small_rects(rng, 1400), 8192, seed + 1, zeros=300)
    yield build("random-overflow", small_rects(rng, 2400), 8192, seed + 2, zeros=200)
    # A run of 12 slots from c - 5, another from 2c - 2 (inside a thread),
    # each across a chunk edge.
    yield build("chunk-starts-mid-run",
                fill(rng, c - 5) + [(10, 10, 4, 3)] + fill(rng, c - 9) + [(5, 5, 3, 4)]
                + fill(rng, 700), 4096, seed + 3, zeros=7)
    # 700 slots, one 64 x 40 rect (2560 slots: chunks 1 and 2 whole), more.
    yield build("run-spans-chunks",
                fill(rng, 700) + [(0, 4, GRID[1], 40)] + fill(rng, 900), 8192, seed + 4,
                zeros=3)
    yield build("count-one", [(int(x), int(y), 1, 1) for x, y in zip(
        rng.integers(0, GRID[1], 5000), rng.integers(0, GRID[0], 5000))], 6144, seed + 5,
        zeros=11)
    # Chunk 1's window: the Gaussian owning slots c - 2 .. c, then c - 1
    # count-1 Gaussians: exactly CHUNK owners.
    ones = [(int(x), 0, 1, 1) for x in rng.integers(0, GRID[1], 2 * c)]
    yield build("widest-window", ones[:c - 2] + [(7, 7, 3, 1)] + ones[c - 2:2 * c - 3]
                + fill(rng, 300), 4096, seed + 6)
    # Overflow: num_pairs = budget = 4094 falls inside a thread and inside
    # the 5 x 5 run that starts at 4090; later offsets clamp to 4095.
    yield build("overflow-mid-thread-mid-run",
                fill(rng, 4090) + [(20, 20, 5, 5)] + fill(rng, 60), 4094, seed + 7, zeros=9)
    # Overflow at a chunk edge: budget 4 * CHUNK, a run across it.
    yield build("overflow-at-chunk-edge",
                fill(rng, 4 * c - 6) + [(30, 30, 4, 4)] + fill(rng, 50), 4 * c, seed + 8,
                zeros=4)
    yield build("no-pairs", [], 2048, seed + 9, zeros=50)
    yield build("exact-budget", fill(rng, 3 * c), 3 * c, seed + 10, zeros=13)
    # Budget 3001 (not a multiple of 4, 512 or CHUNK); num_pairs 2999
    # without overflow (inside a thread).
    yield build("ragged-budget", fill(rng, 2999), 3001, seed + 11, zeros=6)
    yield build("one-gaussian", [(3, 2, 7, 1)], 8, seed + 12)
    yield build("one-gaussian-overflow", [(0, 0, 6, 5)], 21, seed + 13)
    # Rect widths 1 (tall) and the grid's width (flat), alternating.
    yield build("rect-widths", [(int(rng.integers(0, GRID[1])), 0, 1, 30) if i % 2 else
                                (0, int(rng.integers(0, GRID[0])), GRID[1], 1)
                                for i in range(60)], 4096, seed + 14, zeros=2)
    yield cull_edge_case(seed + 15)


def beyond_contract_case(seed: int = 0) -> ExpandCase:
    """Zero-count Gaussians between emitting ones, which binning never
    makes: chunk 1's owners span 3 * CHUNK table rows, so the kernel takes
    its per-slot search of the whole table there. The owner of a slot is
    still the last row whose offset is at most the slot; the JAX kernel,
    whose window is fixed, does not take such input."""
    rng = np.random.default_rng(seed)
    case = build("zero-counts-between", fill(rng, 3 * CHUNK, width=1), 4096, seed)
    # every third Gaussian gets two zero-count copies before it
    keep = np.repeat(np.arange(case.n), np.where(np.arange(case.n) % 3 == 0, 3, 1))
    counts = np.r_[keep[1:] != keep[:-1], True].astype(np.int64)
    return case._replace(offsets=(np.cumsum(counts) - counts).astype(np.int32),
                         rect=case.rect[keep], cull=np.ascontiguousarray(case.cull[:, keep]),
                         idx=rng.permutation(keep.size).astype(np.int32))


def case_names() -> List[str]:
    return [c.name for c in expand_cases()]

