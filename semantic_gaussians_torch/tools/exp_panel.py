"""Segment-sum probe ladder, round 1 (port of tools/exp_panel.py).

What does a windowed accumulate cost per 512-pair chunk? Four kernels read
the same cotangent stream (d = 16, p = 3,670,016, owners over 1,000,000
rows, numpy default_rng(0)):

  V4  the production segment sum at rows = 50,000 (owners capped)
  V0  the production segment sum at rows = 1,000,000
  V1  the window probe: each chunk's 640-row window added at its moving
      offset inside one 4096-row panel (a cost probe, not a segment sum)
  V2  the fold probe: every window added at offset 0
  and `index_add_` on V0's data, the library call for the production kernel.

Usage:
    python -m semantic_gaussians_torch.tools.exp_panel [--device cpu] [--scale s]

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
from ..ops.segsum_probe import CHUNK, segsum_probe
from .probe_common import (
    P_FULL, ROWS_FULL, Table, index_add, make_cot, make_owners, parse_args, scaled,
)


def main(argv=None) -> list:
    device, scale = parse_args(__doc__, sys.argv[1:] if argv is None else argv)
    p, rows = scaled(P_FULL, ROWS_FULL, scale)
    _, small_rows = scaled(P_FULL, 50_000, scale)
    rng = np.random.default_rng(0)
    cot = make_cot(rng, p, device)
    owners_np = make_owners(rng, rows, p)
    owners = torch.from_numpy(owners_np).to(device)
    small = torch.from_numpy(np.minimum(owners_np, small_rows - 1)).to(device)
    table = Table(device)
    chunks = p // CHUNK

    table.timeit(f"V4 production segsum, same {chunks} chunks (rows={small_rows})",
                 lambda: segsum_contiguous(cot, small, small_rows), p=p, rows=small_rows)
    table.timeit(f"V0 production segsum (rows={rows})",
                 lambda: segsum_contiguous(cot, owners, rows), p=p, rows=rows)
    table.timeit("V1 window probe, moving offset into the panel",
                 lambda: segsum_probe(cot, owners, "window"), p=p, rows=rows)
    table.timeit("V2 fold probe, off=0",
                 lambda: segsum_probe(cot, owners, "fold"), p=p, rows=rows)
    table.timeit(f"index_add_ on V0's data (rows={rows})", index_add(cot, owners, rows),
                 p=p, rows=rows)
    return table.lines


if __name__ == "__main__":
    main()
