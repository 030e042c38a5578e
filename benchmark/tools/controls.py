"""The readings that the limits of `correct` are set from.

    python3 -m benchmark.tools.controls --workload <cell> --seeds a,b,c [--sound 1]
        [--control 1] [--faults all|none|name,name] [--seconds 3]

For each seed, on the card and at the cell's own size:
- sound: a run of the cell with a short window, as the benchmark makes it
  (its checks' numbers are the lower readings);
- control: the reference computed in the nearest precision below the
  configuration's, put in the program's place (training: bfloat16 for
  float32; distillation: TF32 matmuls for float32 with TF32 off; the
  viewer: bfloat16), against the reference;
- faults: a run with the timed path broken underneath (FAULTS).
Each reading is one JSON line. The benchmark's own runs run none of this.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]


# ---------------------------------------------------------------------------
# faults, planted in the program for the length of a run
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def patched(module, name: str, make: Callable):
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def _train_unchanged():
    """A step that returns its state unchanged: Adam leaves the parameters."""
    from semantic_gaussians_torch.pipelines import train as PT

    def make(orig):
        def adam(grads, state, params, lrs, hyper):
            _, new_state = orig(grads, state, params, lrs, hyper)
            return params, new_state
        return adam
    return patched(PT, "adam_update", make)


def _train_half_batch():
    """Half of the batch left out: the loss over the image's top half."""
    from semantic_gaussians_torch.pipelines import train as PT

    def make(orig):
        def loss(pred, gt, lam=0.2):
            h = pred.shape[0] // 2
            return orig(pred[:h], gt[:h], lam)
        return loss
    return patched(PT, "photometric_loss", make)


def _train_altered():
    """An answer altered where it is produced: the render's first tile row
    brightened by 0.05."""
    from semantic_gaussians_torch.pipelines import train as PT

    def make(orig):
        def render(*a, **kw):
            out = orig(*a, **kw)
            img = out["render"]
            out = dict(out, render=torch.cat([img[:16] + 0.05, img[16:]], 0))
            return out
        return render
    return patched(PT, "render", make)


def _distill_unchanged():
    """A step that returns its state unchanged: the program's optimizer
    steps do nothing."""
    from semantic_gaussians_torch.pipelines import distill as PD

    def make(orig):
        def state(*a, **kw):
            model, opt, schedule = orig(*a, **kw)
            opt.step = lambda *x, **y: None
            return model, opt, schedule
        return state
    return patched(PD, "make_distill_state", make)


def _distill_half_batch():
    """Half of the batch left out: the loss over the first half of the voxels."""
    from semantic_gaussians_torch.pipelines import distill as PD

    def make(orig):
        def loss(pred, target, mask=None):
            h = pred.shape[0] // 2
            return orig(pred[:h], target[:h], mask=None if mask is None else mask[:h])
        return loss
    return patched(PD, "cosine_distill_loss", make)


def _distill_altered():
    """An answer altered where it is produced: the item's features scaled."""
    from semantic_gaussians_torch.data import feature_dataset as FD

    def make(orig):
        def getitem(self, idx, seed=None):
            item = orig(self, idx, seed=seed)
            item.feats[: item.num_voxels // 10] *= 1.01
            return item
        return getitem
    return patched(FD.FeatureDataset, "__getitem__", make)


def _view_half():
    """Half of the batch left out: the lower half of every image black."""
    from semantic_gaussians_torch.cli import view_server as VS

    def make(orig):
        def render_view(*a, **kw):
            img = orig(*a, **kw).copy()
            img[img.shape[0] // 2:] = 0
            return img
        return render_view
    return patched(VS, "render_view", make)


def _view_altered():
    """An answer altered where it is produced: one tile of each image off
    by 8 levels."""
    from semantic_gaussians_torch.cli import view_server as VS

    def make(orig):
        def render_view(*a, **kw):
            img = orig(*a, **kw).copy()
            img[:16, :32] = (img[:16, :32].astype(np.int32) + 8).clip(0, 255).astype(np.uint8)
            return img
        return render_view
    return patched(VS, "render_view", make)


FAULTS: Dict[str, Dict[str, Callable]] = {
    "train": {"unchanged": _train_unchanged, "half_batch": _train_half_batch,
              "altered": _train_altered},
    "distill": {"unchanged": _distill_unchanged, "half_batch": _distill_half_batch,
                "altered": _distill_altered},
    "view": {"half_batch": _view_half, "altered": _view_altered},
}


# ---------------------------------------------------------------------------
# controls: the reference in a lower precision in the program's place
# ---------------------------------------------------------------------------
def control_train(cell, seed: int, device) -> List:
    """The bfloat16 reference through the check chunk's cameras against the
    float32 reference."""
    import importlib

    from benchmark.common import checks as C
    from benchmark.scenes.common import scene_extent
    from benchmark.traffic.train import CHECK_STEPS, follow_check, loop_views

    cfg, wl = cell.config, cell.workload
    law = importlib.import_module(f"benchmark.scenes.{cfg['law']}")
    poses = law.train_poses(cfg)
    views = loop_views(seed, len(poses), CHECK_STEPS)
    arrays = law.scene(cfg, 2 * seed, device)
    args = (cfg, wl, seed, arrays, poses, views, scene_extent(poses), device)
    ref = follow_check(*args)
    low = follow_check(*args, dtype=torch.bfloat16)
    leaves = {k: low[f"{k}_norms"] for k in ("moment", "change")}
    return C.training_checks(low["losses"], leaves, ref, wl["limits"])


def control_distill(cell, seed: int, device) -> List:
    import importlib

    from benchmark.common import checks as C
    from benchmark.reference import distill as RD
    from benchmark.traffic.distill import fused_features, packed

    cfg, wl = cell.config, cell.workload
    d = cfg["distill"]
    law = importlib.import_module(f"benchmark.scenes.{cfg['law']}")
    arrays = law.scene(cfg, 2 * seed, device)
    n = arrays["means"].shape[0]
    locs, feats = arrays["means"].double().cpu().numpy(), packed(arrays)
    gt, mask = fused_features(cfg, n, 2 * seed + 1, device)
    gt = gt.astype(np.float32) * mask[:, None]
    items = []
    for item_seed, rng in RD.loop_draws(seed, 3):
        it = RD.make_item(locs, feats, gt, mask, item_seed, d["voxel_size"], d["voxel_budget"])
        hi = max(1, min(100, RD.U.GRID_MAX - int(it["coords"].max())))
        it["coords"] = it["coords"] + rng.integers(0, hi, size=(1, 3)).astype(np.int32)
        items.append(it)
    rcfg = dict(d, feature_dim=cfg["feature_dim"])
    ref = RD.follow(seed, items, rcfg, 1, device)
    again = RD.follow(seed, items, rcfg, 1, device)
    low = RD.follow(seed, items, rcfg, 1, device, allow_tf32=True)
    leaves = {k: again[f"{k}_norms"] for k in ("grad", "change")}
    twice = C.training_checks(again["losses"], leaves, ref, wl["limits"])
    print("READING " + json.dumps(dict(kind="reference_twice", workload=cell.name, seed=seed,
                                       numbers={n: v for n, v, _ in twice},
                                       leaves=dict(change=again["change_norms"],
                                                   ref_change=ref["change_norms"]))),
          flush=True)
    leaves = {k: low[f"{k}_norms"] for k in ("grad", "change")}
    return C.training_checks(low["losses"], leaves, ref, wl["limits"])


def control_view(cell, seed: int, device) -> List:
    """The bfloat16 reference's image of each mode's requests (two a mode
    from the cell's own request stream) against the float32 reference's."""
    import importlib

    from benchmark.reference import view as RV
    from benchmark.traffic.distill import fused_features
    from benchmark.traffic.view import MODES, requests

    cfg, wl = cell.config, cell.workload
    law = importlib.import_module(f"benchmark.scenes.{cfg['law']}")
    arrays = law.scene(cfg, 2 * seed, device)
    f16, vis = fused_features(cfg, arrays["means"].shape[0], 2 * seed + 1, device)
    feats = torch.from_numpy(f16.astype(np.float32) * vis[:, None]).to(device)
    out = []
    reqs = requests(cfg, wl, seed, 4 * wl["run_length"])
    for m in MODES:
        worst = 0.0
        for r in [r for r in reqs if r["mode"] == m][:2]:
            cam = RV.request_camera(r["c2w"], r["w"], r["h"], r["fov"], device)
            a = RV.render_mode(arrays, feats, cam, m, r["prompts"], int(cfg["sh_degree"]))
            b = RV.render_mode(arrays, feats, cam, m, r["prompts"], int(cfg["sh_degree"]),
                               dtype=torch.bfloat16)
            off = np.abs(a.astype(np.int32) - b.astype(np.int32)).max(-1) > wl["level_slack"]
            worst = max(worst, float(off.mean()))
        out.append((f"pixels_off.{m}", worst, wl["limits"][f"pixels_off.{m}"]))
    return out


CONTROLS = {"train": control_train, "distill": control_distill, "view": control_view}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--sound", type=int, default=1)
    ap.add_argument("--control", type=int, default=1)
    ap.add_argument("--faults", default="all",
                    help="comma-separated fault names of the cell's traffic, all, or none")
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
        rec = dict(kind=kind, workload=cell.name, seed=seed,
                   numbers={n: (v if np.isfinite(v) else str(v)) for n, v, _ in checks})
        rec.update(extra or {})
        print("READING " + json.dumps(rec), flush=True)

    for seed in [int(s) for s in args.seeds.split(",")]:
        if args.sound:
            r = run_cell(cell, seed, args.seconds, False, dev, time.perf_counter())
            emit("sound", seed, [(n, c["value"] if not isinstance(c["value"], str) else np.inf, 0)
                                 for n, c in r["checks"].items()], dict(metrics=r["metrics"]))
        if args.control:
            emit("control", seed, CONTROLS[cell.traffic](cell, seed, dev))
        names = (list(FAULTS[cell.traffic]) if args.faults == "all" else
                 [] if args.faults == "none" else args.faults.split(","))
        for name in names:
            with FAULTS[cell.traffic][name]():
                r = run_cell(cell, seed, args.seconds, False, dev, time.perf_counter())
            emit(f"fault.{name}", seed,
                 [(n, c["value"] if not isinstance(c["value"], str) else np.inf, 0)
                  for n, c in r["checks"].items()])
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
