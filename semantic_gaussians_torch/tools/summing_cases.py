"""Small adversarial inputs for the two summing kernels, made with numpy
from a seed. The CPU tests run the plain versions on them against numpy and
the JAX package; chip_smoke.py runs the kernels on them against the plain
versions on the card. One generator, so both see the same data.

`segsum_cases()` covers what the segment sum's tiling can get wrong: runs
that end exactly on, one row before and one row after every tile boundary;
one owner for every row (each tile is one run, joined through every level
of carries); all owners distinct; steps over unowned output rows, before
the first owner, inside the stream and after the last owner; `limit` at 0,
at P, inside a run and on a run's first row; row widths from 1 to one above
the widest column panel; a stream long enough for three levels; runs
around the reach of the kernel's look-back over tiles.
`probe_cases()` covers the probe's chunk groups and its unsorted branch.
"""
from __future__ import annotations

from typing import Iterator, NamedTuple, Optional

import numpy as np

from ..ops.segsum import MAX_HOPS, MAX_PANEL, tile_shape
from ..ops.segsum_probe import CHUNK
from .probe_common import D as PROBE_D
from .probe_common import make_owners


class SegsumCase(NamedTuple):
    name: str
    cot: np.ndarray  # [P, D] float32
    owners: np.ndarray  # [P] int32, non-decreasing
    num_rows: int
    limit: Optional[int]  # rows at or past it count as zero
    unit_steps: bool  # owners step by at most 1 (what the JAX kernels take)


class ProbeCase(NamedTuple):
    name: str
    cot: np.ndarray  # [P, D] float32, P a multiple of CHUNK
    owners: np.ndarray  # [P] int32
    sorted: bool  # owners non-decreasing inside every chunk


def _runs(lengths, owners) -> np.ndarray:
    return np.repeat(np.asarray(owners, np.int32), np.asarray(lengths))


def _random_steps(rng, p, rate) -> np.ndarray:
    steps = (rng.uniform(size=p) < rate).astype(np.int32)
    steps[0] = 0
    return np.cumsum(steps).astype(np.int32)


def segsum_cases(seed: int = 0) -> Iterator[SegsumCase]:
    rng = np.random.default_rng(seed)

    def case(name, d, owners, num_rows=None, limit=None):
        owners = np.asarray(owners, np.int32)
        cot = rng.normal(size=(owners.size, d)).astype(np.float32)
        rows = int(owners.max(initial=-1)) + 1 if num_rows is None else num_rows
        unit = bool(owners.size == 0 or (owners[0] == 0 and np.diff(owners).max(initial=0) <= 1))
        return SegsumCase(name, cot, owners, rows, limit, unit)

    d = 9
    _, rows, _ = tile_shape(d)
    p = 3 * rows + 5
    yield case("one_owner", d, np.zeros(p, np.int32), num_rows=3)
    yield case("all_distinct", 4, np.arange(3 * tile_shape(4)[1] + 1))
    # steps of 2, 5 and 300 output rows, first owner 7, 37 empty rows at the end
    jumps = rng.choice([0, 0, 0, 1, 1, 2, 5, 300], size=p)
    jumps[0] = 7
    stepped = np.cumsum(jumps)
    yield case("steps_and_empty_rows", 16, stepped, num_rows=int(stepped[-1]) + 38)
    # a run boundary on every multiple of the tile's rows, and a row either side
    for name, shift in (("boundary_before", -1), ("boundary_on", 0), ("boundary_after", 1)):
        cuts = np.arange(1, 4) * rows + shift
        yield case(name, d, _runs(np.diff(np.r_[0, cuts, p]), np.arange(4)))
    # the tile's first run ends on its second row, its last starts on its last
    edges = np.sort(np.r_[np.arange(1, 4) * rows - 1, np.arange(0, 4) * rows + 1])
    yield case("one_row_heads_and_tails", d, _runs(np.diff(np.r_[0, edges, p]),
                                                   np.arange(edges.size + 1)))
    owners = _random_steps(rng, p, 0.2)
    starts = np.flatnonzero(np.diff(owners)) + 1  # first rows of the runs
    long_runs = starts[:-1][np.diff(starts) >= 3]
    run_start, inside = int(starts[len(starts) // 3]), int(long_runs[len(long_runs) // 2]) + 1
    for name, limit in (("limit_zero", 0), ("limit_all", p), ("limit_inside_a_run", inside),
                        ("limit_on_a_boundary", run_start), ("limit_on_a_tile", 2 * rows)):
        yield case(name, d, owners, num_rows=int(owners[-1]) + 3, limit=limit)
    for width in (1, 4, 9, 16, 33, MAX_PANEL, MAX_PANEL + 1):
        r = tile_shape(width)[1]
        n = 2 * r + r // 2 + 3
        yield case(f"width_{width}", width, _random_steps(rng, n, 0.3))
    # three levels: more tiles than a tile of carries holds, one run across
    # the first two thirds of them
    r = tile_shape(4)[1]
    n = (r // 2 + 40) * r + 17
    long_run = np.r_[np.zeros(2 * n // 3, np.int32), 1 + _random_steps(rng, n - 2 * n // 3, 0.3)]
    yield case("three_levels", 4, long_run)
    # runs as long as the look-back reaches, and one and two tiles longer (those
    # defer to the carry levels), between short runs
    r = tile_shape(16)[1]
    for tiles in (MAX_HOPS, MAX_HOPS + 1, MAX_HOPS + 2):
        ahead = _random_steps(rng, r + r // 3, 0.3)
        long_run = np.full(tiles * r, ahead[-1] + 1, np.int32)
        after = ahead[-1] + 2 + _random_steps(rng, 2 * r, 0.3)
        yield case(f"run_over_{tiles + 1}_tiles", 16, np.r_[ahead, long_run, after])
    yield case("no_rows", d, np.zeros(0, np.int32), num_rows=5)


def shuffle_inside_chunks(rng, owners: np.ndarray, every: int = 1) -> np.ndarray:
    """Owners put out of order inside every `every`-th chunk; each chunk's
    first owner (which fixes its window) stays."""
    blocks = owners.reshape(-1, CHUNK).copy()
    for b in blocks[::every]:
        b[1:] = rng.permutation(b[1:])
    return blocks.reshape(-1)


def probe_data(n_chunks: int, rows: int, seed: int = 0, shuffle: bool = False, every: int = 1):
    """The probe tools' data law at a reduced p: cot [p, D] and step owners
    (`shuffle`: out of order inside every `every`-th chunk)."""
    rng = np.random.default_rng(seed)
    p = n_chunks * CHUNK
    cot = np.ascontiguousarray(rng.normal(size=(PROBE_D, p)).astype(np.float32).T)
    owners = make_owners(rng, rows, p)
    if shuffle:
        owners = shuffle_inside_chunks(rng, owners, every)
    return cot, owners


def probe_cases(max_groups: int, seed: int = 0) -> Iterator[ProbeCase]:
    """Cases around a grouping into at most `max_groups` chunk groups (on
    the card: its multiprocessor count)."""
    g = max_groups
    # the window slides past the panel's end several times
    yield ProbeCase("ordered", *probe_data(48, 22_000, seed + 3), True)
    yield ProbeCase("shuffled", *probe_data(48, 22_000, seed + 3, shuffle=True), False)
    # some chunks of a group out of order, the others walked
    yield ProbeCase("shuffled_every_third", *probe_data(2 * g + 7, 40 * g, seed + 5, True, 3),
                    False)
    # a chunk count that does not divide into the groups: the last group is short
    yield ProbeCase("ragged_groups", *probe_data(2 * g + 1, 60 * g, seed + 6), True)
    yield ProbeCase("fewer_chunks_than_groups", *probe_data(3, 900, seed + 7), True)
    # one owner for every pair: each chunk is one run, one panel row
    cot, owners = probe_data(g + 2, 2, seed + 8)
    yield ProbeCase("one_owner", cot, np.full_like(owners, 77), True)
    # fast owners: windows move by more than the accumulator holds per chunk
    cot, owners = probe_data(g + 5, 10_000_000, seed + 9)
    yield ProbeCase("fast_owners", cot, (owners.astype(np.int64) * 3).astype(np.int32), True)
