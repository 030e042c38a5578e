"""The readings that the limits of a Gaussian Grouping cell's `correct` are
set from (tools/controls.py's readings, for the `train_grouping` traffic).

    python3 -m benchmark.tools.grouping_controls --workload scannet.train_group16 \\
        --seeds a,b,c [--sound 1] [--control 1] [--faults all|none|name,name] [--seconds 3]

For each seed, on the card and at the cell's size: a sound run with a
short window; the control, the Gaussian Grouping reference in bfloat16 in
the program's place against the float32 reference; and runs under each
fault of Gaussian Grouping's path: the 3D term left out, the classifier
not updated, the cross-entropy over half the pixels. Each reading is one
JSON line. The benchmark's own runs run none of this.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from benchmark.tools.controls import patched

ROOT = Path(__file__).resolve().parents[2]


def _reg3d_out():
    """The 3D term left out of the loss (its draws and neighbours kept)."""
    from semantic_gaussians_torch.pipelines import train as PT

    def make(orig):
        def loss(*a, **kw):
            l3d, knn = orig(*a, **kw)
            return l3d * 0.0, knn
        return loss
    return patched(PT, "reg3d_loss", make)


def _classifier_frozen():
    """The classifier not updated: its moments step, its weights stay."""
    from semantic_gaussians_torch.pipelines import train as PT

    def make(orig):
        def adam(state, *a, **kw):
            new_params, new_adam, cls = orig(state, *a, **kw)
            return new_params, new_adam, dataclasses.replace(cls, params=state.classifier.params)
        return adam
    return patched(PT, "adam_step", make)


def _identity_half():
    """The cross-entropy over the top half of the view's pixels."""
    from semantic_gaussians_torch.pipelines import train as PT

    def make(orig):
        def loss(identity, ids, classifier):
            h = identity.shape[0] // 2
            return orig(identity[:h], ids[:h], classifier)
        return loss
    return patched(PT, "identity_loss", make)


FAULTS = dict(reg3d_out=_reg3d_out, classifier_frozen=_classifier_frozen,
              identity_half=_identity_half)


def control(cell, seed: int, device) -> List:
    """The bfloat16 reference through the check chunk's cameras against the
    float32 reference, its neighbours' flips counted as the cell counts the
    program's."""
    from benchmark.common import checks as C
    from benchmark.scenes.common import scene_extent
    from benchmark.traffic.train import CHECK_STEPS, _law, loop_views
    from benchmark.traffic.train_grouping import follow_check, knn_flips

    cfg, wl = cell.config, cell.workload
    poses = _law(cfg).train_poses(cfg)
    views = loop_views(seed, len(poses), CHECK_STEPS)
    args = (cfg, wl, seed, poses, views, scene_extent(poses), device)
    ref = follow_check(*args)
    low = follow_check(*args, dtype=torch.bfloat16)
    leaves = {k: low[f"{k}_norms"] for k in ("moment", "change")}
    knn = torch.stack([torch.full_like(ref["knn"][1], -1) if k is None else k
                       for k in low["knn"]]).cpu()
    flips = sum(knn_flips(knn, ref["knn"]))
    return (C.training_checks(low["losses"], leaves, ref, wl["limits"])
            + [("knn_flips", float(flips), wl["limits"]["knn_flips"])])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--sound", type=int, default=1)
    ap.add_argument("--control", type=int, default=1)
    ap.add_argument("--faults", default="all", help="comma-separated fault names, all, or none")
    args = ap.parse_args(argv)
    from benchmark.common.manifest import Cell, load_manifest
    from benchmark.run import cache_env, run_cell

    cache_env()
    cell = Cell(args.workload, load_manifest(ROOT))
    if not torch.cuda.is_available():
        print("the readings are taken on the card", file=sys.stderr)
        return 2
    dev = "cuda:0"

    def emit(kind, seed, checks, extra=None):
        rec: Dict = dict(kind=kind, workload=cell.name, seed=seed,
                         numbers={n: (v if np.isfinite(v) else str(v)) for n, v, _ in checks})
        rec.update(extra or {})
        print("READING " + json.dumps(rec), flush=True)

    def numbers(r):
        return [(n, c["value"] if not isinstance(c["value"], str) else np.inf, 0)
                for n, c in r["checks"].items()]

    names = (list(FAULTS) if args.faults == "all" else
             [] if args.faults == "none" else args.faults.split(","))
    for seed in [int(s) for s in args.seeds.split(",")]:
        if args.sound:
            r = run_cell(cell, seed, args.seconds, False, dev, time.perf_counter())
            emit("sound", seed, numbers(r), dict(metrics=r["metrics"], device=r["device"]))
        if args.control:
            emit("control", seed, control(cell, seed, dev))
        for name in names:
            with FAULTS[name]():
                r = run_cell(cell, seed, args.seconds, False, dev, time.perf_counter())
            emit(f"fault.{name}", seed, numbers(r))
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
