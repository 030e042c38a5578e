"""Segment-sum probe ladder, round 2 (port of tools/exp_panel2.py).

A ladder of kernels that all consume the full cotangent stream (d = 16,
p = 3,670,016, numpy default_rng(0)), and the production segment sum's
scaling with the chunk count on production-like advancing owners:

  resident  the production segment sum at p = 393,216 / rows = 90,000 and
            p = 786,432 / rows = 180,000, with `index_add_` (the library
            call for it) at the larger shape
  A         the fold probe: every chunk's 640-row window added at offset 0
  B         the window probe: added at its moving offset inside the panel
  each probe followed by the sum of its panel, as a check line.

Usage:
    python -m semantic_gaussians_torch.tools.exp_panel2 [--device cpu] [--scale s]

Runs on CUDA and raises if CUDA is absent unless `--device cpu` is given.
Times are means of 10 calls after one warm-up (CUDA events on the card),
each line stamped with the card's name and power limit. `--scale` shrinks p
and rows (for CPU tests). `main(argv)` returns the table.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops.segsum import segsum_contiguous
from ..ops.segsum_probe import segsum_probe
from .probe_common import (
    P_FULL, ROWS_FULL, Table, index_add, make_cot, make_owners, parse_args, scaled,
)

RESIDENT_SHAPES = ((393_216, 90_000), (786_432, 180_000))


def main(argv=None) -> list:
    device, scale = parse_args(__doc__, sys.argv[1:] if argv is None else argv)
    p, rows = scaled(P_FULL, ROWS_FULL, scale)
    rng = np.random.default_rng(0)
    cot = make_cot(rng, p, device)
    table = Table(device)

    # the production kernel's scaling with the chunk count
    for pp_full, rr_full in RESIDENT_SHAPES:
        pp, rr = scaled(pp_full, rr_full, scale)
        o = torch.from_numpy(make_owners(rng, rr, pp)).to(device)
        part = cot[:pp]
        table.timeit(f"resident p={pp} rows={rr}",
                     lambda: segsum_contiguous(part, o, rr), p=pp, rows=rr)
    table.timeit(f"index_add_ p={pp} rows={rr}", index_add(part, o, rr), p=pp, rows=rr)

    # the ladder: every kernel reads all of cot and folds it into the panel
    owners = torch.from_numpy(make_owners(rng, rows, p)).to(device)
    out_a = table.timeit("A static fold into panel[:WIN]",
                         lambda: segsum_probe(cot, owners, "fold"), p=p, rows=rows)
    table.note("A sum", float(out_a.sum()))
    out_b = table.timeit("B dynamic-window add",
                         lambda: segsum_probe(cot, owners, "window"), p=p, rows=rows)
    table.note("B sum", float(out_b.sum()))
    return table.lines


if __name__ == "__main__":
    main()
