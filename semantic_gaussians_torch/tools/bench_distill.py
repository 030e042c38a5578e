"""Distill-path throughput: the sparse MinkUNet's training step, voxels/s.

Port of the root tools/bench_distill.py. The 3D-distillation step
(MinkUNet34A over a ~10^5-voxel room, 56-dim Gaussian features -> 768-dim
CLIP space, cosine loss, AdamW) is timed with its topology built inside
every step, as the reference rebuilds its coordinate maps per batch. The
scene is room-shaped (floor, ceiling and walls, plus clutter blobs), so
neighbour density and stride-pool occupancy resemble real data.
`room_voxels` is the root tool's, draw for draw.

After a warm-up of INNER = 5 chained steps (pipelines.distill's
make_distill_step: topology, forward, loss, backward, AdamW), ITERS = 4 x 5
steps are timed; then as many forward-only inferences with their topology
(eval_segmentation's per-scene path). Eager: the topology's shapes depend
on the data, so no CUDA graph can hold a step.

    python -m semantic_gaussians_torch.tools.bench_distill [--voxels 131072]
        [--arch MinkUNet34A] [--feature-dim 768] [--device cpu] [--tiny]

`--tiny`: 2,048 voxels, MinkUNet14A, 32 dims, 3 x 2 steps, on the CPU.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..models.unet3d import build_topology
from ..pipelines.distill import DistillConfig, make_distill_state, make_distill_step
from ..utils.device import card_stamp, resolve_device, synchronize

INNER, ITERS = 5, 4
IN_CHANNELS = 56


def room_voxels(n_target: int, rng) -> np.ndarray:
    """~n_target unique voxel coords forming a box room + clutter."""
    side = int(np.sqrt(n_target / 6.0)) + 1
    g = np.arange(side)
    xx, yy = np.meshgrid(g, g)
    planes = []
    for z in (0, side - 1):  # floor / ceiling
        planes.append(np.stack([xx, yy, np.full_like(xx, z)], -1).reshape(-1, 3))
        planes.append(np.stack([xx, np.full_like(xx, z), yy], -1).reshape(-1, 3))
        planes.append(np.stack([np.full_like(xx, z), xx, yy], -1).reshape(-1, 3))
    pts = np.concatenate(planes)
    blob = rng.normal(size=(n_target // 4, 3)) * side / 8 + side / 2  # clutter blobs
    pts = np.concatenate([pts, blob.astype(np.int64)])
    pts = np.unique(np.clip(pts, 0, 1000), axis=0)
    rng.shuffle(pts)
    return pts[:n_target].astype(np.int32)


def distill_inputs(voxels: int, feature_dim: int, device):
    """The root tool's inputs at seed 0, drawn in its order: (coords,
    feats, gt, gt_mask, mask) on `device`."""
    rng = np.random.default_rng(0)
    coords = room_voxels(voxels, rng)
    n = coords.shape[0]
    feats = rng.normal(size=(n, IN_CHANNELS)).astype(np.float32)
    gt = rng.normal(size=(n, feature_dim)).astype(np.float32)
    gt_mask = rng.uniform(size=(n,)) > 0.2
    return tuple(torch.from_numpy(x).to(device) for x in (
        coords, feats, gt, gt_mask, np.ones(n, bool)))


def time_distill(voxels: int, arch: str, feature_dim: int, device, inner: int = INNER,
                 iters: int = ITERS) -> dict:
    """`inner` warm-up steps, then `iters` x `inner` timed steps, then as
    many timed inferences after one warm-up. Returns dict(voxels, step_ms,
    step_mvox_s, loss (the last step's), infer_ms, infer_mvox_s)."""
    dev = resolve_device(device)
    cfg = DistillConfig(model_3d=arch, feature_dim=feature_dim, in_channels=IN_CHANNELS)
    coords, feats, gt, gt_mask, mask = distill_inputs(voxels, feature_dim, dev)
    n = coords.shape[0]
    model, opt, schedule = make_distill_state(cfg, steps_per_epoch=100, device=dev)
    step = make_distill_step(model, opt, schedule, cfg)
    for _ in range(inner):
        loss = step(coords, feats, gt, gt_mask, mask)
    synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(iters * inner):
        loss = step(coords, feats, gt, gt_mask, mask)
    loss = float(loss)
    step_s = (time.perf_counter() - t0) / (iters * inner)

    model.eval()
    with torch.no_grad():
        model(feats, build_topology(coords, mask))
        synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(iters * inner):
            y = model(feats, build_topology(coords, mask))
        synchronize(dev)
    infer_s = (time.perf_counter() - t0) / (iters * inner)
    if not torch.isfinite(y).all():
        raise RuntimeError("the inference produced non-finite features")
    return dict(voxels=n, step_ms=step_s * 1e3, step_mvox_s=n / step_s / 1e6, loss=loss,
                infer_ms=infer_s * 1e3, infer_mvox_s=n / infer_s / 1e6)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiny", action="store_true", help="CPU sanity run")
    ap.add_argument("--voxels", type=int, default=131072)
    ap.add_argument("--arch", default="MinkUNet34A")
    ap.add_argument("--feature-dim", type=int, default=768)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    inner, iters = INNER, ITERS
    if args.tiny:
        args.voxels, args.arch, args.feature_dim, args.device = 2048, "MinkUNet14A", 32, "cpu"
        inner, iters = 3, 2
    dev = resolve_device(args.device)
    print(f"device={card_stamp(dev)} voxels={args.voxels} arch={args.arch}")
    r = time_distill(args.voxels, args.arch, args.feature_dim, dev, inner, iters)
    print(f"distill step (fwd+bwd+adamw+topology): {r['step_ms']:.2f} ms  "
          f"{r['step_mvox_s']:.2f} Mvoxels/s  loss={r['loss']:.4f}")
    print(f"inference fwd (+topology): {r['infer_ms']:.2f} ms  {r['infer_mvox_s']:.2f} Mvoxels/s")
    return r


if __name__ == "__main__":
    main()
