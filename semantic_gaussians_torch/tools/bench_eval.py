"""Serving-path throughput of open-vocabulary evaluation: views a second.

Port of the root tools/bench_eval.py. The workload: `--n` Gaussians of the
random cloud (tools.common.random_cloud_params, seed 0), [n, C] random
features, K + 1 unit text rows, `--views` cameras stepped 0.02 along x, and
random label images; each view is rendered, matched against the text
(argmax) and added to the [K, K + 1] confusion. The port's
pipelines.eval_segmentation.eval_views runs twice each way: view by view
(chunk_views = 0) and in chunks of `--chunk` views (one CUDA-graph replay a
chunk; eval_views captures its graphs anew on every call). The first call
of each way is reported apart. The two ways' confusion matrices must be
identical.

    python -m semantic_gaussians_torch.tools.bench_eval [--n 100000] [--c 768]
        [--views 16] [--chunk 8] [--w 640] [--h 480] [--classes 19] [--pred3d]
        [--pair-budget 0] [--device cpu]

`--pair-budget 0` renders at eval_views' default budget, which is what
the root tool renders at: it parses `--pair-budget 262144` but never hands
it to eval_views (and this scene has ~494,500 pairs a view at 100k, past
262,144).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..pipelines.eval_segmentation import eval_views
from ..utils.camera import make_camera
from ..utils.device import card_stamp, resolve_device
from .common import random_cloud_params


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--c", type=int, default=768)
    ap.add_argument("--views", type=int, default=16)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--w", type=int, default=640)
    ap.add_argument("--h", type=int, default=480)
    ap.add_argument("--classes", type=int, default=19)
    ap.add_argument("--pred3d", action="store_true")
    ap.add_argument("--pair-budget", type=int, default=0,
                    help="0: eval_views' default budget (default_pair_budget(n))")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def eval_inputs(n: int, c: int, views: int, w: int, h: int, classes: int, device):
    """The root tool's inputs, drawn in its order: (cameras, label images,
    params, alive, features [n, c], text [K + 1, c], class names)."""
    params, alive, rng = random_cloud_params(n, device=device)
    feats = torch.from_numpy(rng.normal(size=(n, c)).astype(np.float32)).to(device)
    text = rng.normal(size=(classes + 1, c)).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    cams = [make_camera(np.eye(3), np.array([0.02 * i, 0, 0], np.float32), 1.4, 1.1, w, h,
                        device=device) for i in range(views)]
    gts = [rng.integers(0, classes + 1, size=(h, w)) for _ in range(views)]
    return cams, gts, params, alive, feats, text, [f"c{i}" for i in range(classes)]


def run(args) -> dict:
    """Both ways at `args` (parse_args); returns {way: dict(views_per_s,
    ms_per_view, first_call_s, miou, confusion)} and the speed-up."""
    dev = resolve_device(args.device)
    print(f"device: {card_stamp(dev)} n={args.n} C={args.c} {args.w}x{args.h} "
          f"views={args.views}")
    cams, gts, params, alive, feats, text, labels = eval_inputs(
        args.n, args.c, args.views, args.w, args.h, args.classes, dev)

    def call(chunk):
        return eval_views(cams, gts, params, alive, feats, text, labels,
                          pred_on_3d=args.pred3d, chunk_views=chunk,
                          pair_budget=args.pair_budget or None)

    out = {}
    for name, chunk in (("per_view", 0), ("chunked", args.chunk)):
        t0 = time.perf_counter()
        miou, _, conf = call(chunk)
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        call(chunk)
        dt = time.perf_counter() - t0
        out[name] = dict(views_per_s=args.views / dt, ms_per_view=dt / args.views * 1e3,
                         first_call_s=first_s, miou=float(miou), confusion=conf)
        print(f"{name:>9}: {args.views / dt:7.2f} views/s ({dt / args.views * 1e3:6.1f} "
              f"ms/view; first call {first_s:.1f}s) mIoU {miou:.4f}")
    if not np.array_equal(out["per_view"]["confusion"], out["chunked"]["confusion"]):
        raise RuntimeError("the per-view and chunked confusion matrices differ")
    speedup = out["chunked"]["views_per_s"] / out["per_view"]["views_per_s"]
    print(f"confusions identical; chunked speedup {speedup:.2f}x")
    return dict(out, speedup=speedup)


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
