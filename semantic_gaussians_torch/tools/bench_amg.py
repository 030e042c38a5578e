"""Automatic mask generation throughput: SAM's point sweep, masks/s.

Port of the root tools/bench_amg.py. The SAMCLIP predictor's hot loop is
the automatic mask generator's point sweep: per batch of point prompts, a
prompt decode and one bilinear resample of the low-resolution logits to
the image (models/automask.py). This tool measures it at 640x480 with a
tiny SAM (SamConfig.tiny(img_size=256): vit_h's structure at toy widths,
seeded weights from tools.random_checkpoints.sam_model) and
AutoMaskConfig(points_per_side=16) on an image of uniform noise: the
resample, which dominates and does not depend on the widths, is real; the
encoder's time is reported apart, since it scales with the backbone.

Times SamAutoMask.embed (preprocess and encoder, once an image; 3 calls
after a first) and one batch of `--batch` random points as the root tool
times the JAX `_predict_fn` (`--points` / `--batch` batches after a first,
the device synchronized after each): SamAutoMask.decode_batch (prompt
decode + resample), then on the device every row's mask (logit >
threshold), stability score and box (predict_batch), which
SamAutoMask.select filters.

    python -m semantic_gaussians_torch.tools.bench_amg [--points 256]
        [--batch 64] [--width 640] [--height 480] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..models.automask import AutoMaskConfig, SamAutoMask, masks_to_boxes
from ..models.sam import SamConfig
from ..utils.device import card_stamp, resolve_device, synchronize
from .random_checkpoints import sam_model

ENCODER_CALLS = 3


def amg_inputs(width: int, height: int, batch: int, device):
    """(generator, image [H, W, 3] uint8, points [batch, 2] in the
    encoder's frame): the root tool's, drawn in its order from seed 0."""
    cfg = SamConfig.tiny(img_size=256)
    gen = SamAutoMask(sam_model(cfg, seed=0).to(device), AutoMaskConfig(points_per_side=16))
    rng = np.random.default_rng(0)
    img = (rng.uniform(size=(height, width, 3)) * 255).astype(np.uint8)
    pts = rng.uniform(0, cfg.img_size, (batch, 1, 2)).astype(np.float32)[:, 0]
    return gen, img, torch.from_numpy(pts).to(device)


def predict_batch(gen: SamAutoMask, emb, points, hw, rhw):
    """The JAX `_predict_fn` of one batch: (masks [B, 3, h, w] bool, iou
    [B, 3], stability [B, 3], boxes [B, 3, 4]), all on the device."""
    logits, iou = gen.decode_batch(emb, points, hw, rhw)
    masks = logits > gen.amg.mask_threshold
    return masks, iou, gen.stability(logits), masks_to_boxes(masks)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", type=int, default=256)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    h, w = args.height, args.width
    gen, img, pts = amg_inputs(w, h, args.batch, dev)

    t0 = time.perf_counter()
    emb, rhw = gen.embed(img)
    synchronize(dev)
    enc_first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(ENCODER_CALLS):
        emb, rhw = gen.embed(img)
    synchronize(dev)
    enc_ms = (time.perf_counter() - t0) / ENCODER_CALLS * 1e3

    iters = max(1, args.points // args.batch)
    with torch.inference_mode():
        predict_batch(gen, emb, pts, (h, w), rhw)
        synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            masks, iou, stab, boxes = predict_batch(gen, emb, pts, (h, w), rhw)
            synchronize(dev)
    dt = time.perf_counter() - t0
    if (tuple(masks.shape) != (args.batch, 3, h, w) or tuple(boxes.shape) != (args.batch, 3, 4)
            or not (torch.isfinite(iou).all() and torch.isfinite(stab).all())):
        raise RuntimeError(f"predict_batch gave masks {tuple(masks.shape)}, boxes "
                           f"{tuple(boxes.shape)}, or non-finite scores")
    masks = iters * args.batch * 3  # three scales a point
    print(f"device={card_stamp(dev)} {w}x{h} batch={args.batch}\n"
          f"encoder: {enc_ms:.1f} ms/image (tiny backbone; vit_h scales this ~400x by FLOPs; "
          f"first call {enc_first_s:.1f}s)\n"
          f"decode+upscale: {dt / iters * 1e3:.1f} ms/batch -> {masks / dt:.0f} masks/s "
          f"({args.points / dt:.0f} points/s at {args.batch}/batch)")
    return dict(encoder_ms=enc_ms, encoder_first_s=enc_first_s, batch_ms=dt / iters * 1e3,
                masks_per_s=masks / dt, points_per_s=args.points / dt)


if __name__ == "__main__":
    main()
