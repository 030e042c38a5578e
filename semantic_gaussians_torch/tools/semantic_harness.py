"""The semantic pipeline end to end: fusion -> distillation -> evaluation.

Port of the root tools/semantic_harness.py. The scene is the parity
harness's textured scene (tools.parity_harness.build_true_scene, seed 11)
at `--density` 3 (205,236 Gaussians on the floor, the ball and the box;
the dust dropped, opacity 0.95), taken as a trained model whose classes
come from its construction. An oracle 2D provider gives each pixel of a
640x480 view the `--dim`-wide text feature of its ground-truth class
(RandomFeatureProvider's text rows), zeros where the pixel is unlabelled:
a perfect open-vocabulary segmenter. Ground-truth label images are
rendered from one-hot class features through the pred_on_3d path.

  1. fuse: `--n-fuse` ring views, depth=render, cut_boundary 10, chunks of
     `--chunk-views` views through pipelines.fusion._fuse_chunk (one
     GraphRunner over all chunks: a CUDA-graph replay a chunk), saved as
     the reference's {feat, mask_full} .pt beside the model's PLY.
  2. distill: MinkUNet34A (56 -> dim) with the cosine loss and the
     reference's augmentation (elastic distortion, a flip, a random global
     shift), `--epochs` steps of the one scene (make_distill_step).
  3. eval: `--n-eval` held-out ring views in modes 2d (a dim-channel
     feature render, pred_on_3d false), 3d (the distilled net's features,
     one-hot render) and 2d_and_3d (the argmax ensemble).

Checks (the JAX tool's): fused-vs-oracle cosine > 0.95, > 70% of the
labelled Gaussians visited, the distill loss's last ten steps below 0.15,
mIoU 2d > 0.9, 3d > 0.8, 2d_and_3d > 0.8.

    python -m semantic_gaussians_torch.tools.semantic_harness
        [--out harness_out/semantic_harness.json] [--state FILE]
        [--max-seconds S] [--workdir DIR] [--device cpu]

With --state, progress is saved after every fusion chunk and every block
of `--epoch-block` distill steps (written to a temporary file and
renamed), and a rerun resumes; past --max-seconds it exits with code 3.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pickle
import statistics
import sys
import time
from pathlib import Path

import numpy as np

from .parity_harness import atomic_write, build_true_scene, ring_camera

LABELS = ["floor", "ball", "box"]
UNLABELED = len(LABELS)  # the ground-truth id of dust and background
MODEL_3D = "MinkUNet34A"
# The distill step (of a process) traced for the busy share: its device
# time over the median wall of the untraced steps.
PROFILED_STEP = 3


def build_gt_maps(cams, params, alive, cls, cache_path=None, backend="tiled"):
    """A ground-truth label image [H, W] uint8 a view, rendered from the
    Gaussians' classes: one-hot class features (row 0 'other') through the
    pred_on_3d path, so that boundary pixels take the dominant class and
    the background 'unlabeled'. Cached at `cache_path` when given."""
    import torch

    from ..pipelines.eval_segmentation import predict_label_image

    if cache_path is not None and Path(cache_path).exists():
        return list(np.load(cache_path)["gt"])
    dev = params.device
    eye = np.eye(1 + len(LABELS), dtype=np.float32)
    gfeat = np.where(
        (cls < len(LABELS))[:, None], eye[np.minimum(cls + 1, len(LABELS))], 0.0
    ).astype(np.float32)
    gfeat_t, eye_t = torch.from_numpy(gfeat).to(dev), torch.from_numpy(eye).to(dev)
    gts = [predict_label_image(cam, params, alive, gfeat_t, eye_t, pred_on_3d=True,
                               backend=backend).cpu().numpy().astype(np.uint8)
           for cam in cams]
    if cache_path is not None:
        with open(f"{cache_path}.tmp", "wb") as f:
            np.savez_compressed(f, gt=np.stack(gts))
        Path(f"{cache_path}.tmp").replace(cache_path)
    return gts


def build_scene(args, dev):
    """The harness's scene at `args.density` (seed 11) as a trained model's
    stand-in, and its cameras: a namespace of params, alive, cls [capacity]
    (UNLABELED past the points), n_gaussians, text [K+1, dim] (row 0
    'other'), lookup [K+1, dim] (the oracle: a ground-truth id's text row,
    zeros for UNLABELED), the `--n-fuse` ring cameras and the `--n-eval`
    held-out ones."""
    from types import SimpleNamespace

    from ..core.gaussians import init_from_pcd
    from ..models.predictors import RandomFeatureProvider
    from ..pipelines.eval_segmentation import text_feature_matrix
    from ..utils.camera import make_camera_from_c2w

    rng = np.random.default_rng(11)
    w, h, n_fuse = args.width, args.height, args.n_fuse
    pts, cols, cls = build_true_scene(rng, density=args.density, return_classes=True)
    # No dust (a trained run prunes floaters), near-opaque surfaces (so that
    # the median depth reads the surface).
    keep = cls < len(LABELS)
    pts, cols, cls = pts[keep], cols[keep], cls[keep]
    params, alive = init_from_pcd(pts, cols, sh_degree=3, init_opacity=0.95, device=dev)
    cls_full = np.full(params.capacity, UNLABELED, np.int32)
    cls_full[: len(cls)] = cls
    text = text_feature_matrix(RandomFeatureProvider(embedding_dim=args.dim), LABELS)
    lookup = np.concatenate([text[1:], np.zeros((1, args.dim), np.float32)])

    def make(c2w, fov_x, fov_y, cw, ch):
        return make_camera_from_c2w(c2w, fov_x, fov_y, cw, ch, device=dev)

    cams = [ring_camera(i + 0.5 / n_fuse, n_fuse, w, h, make=make) for i in range(n_fuse)]
    eval_cams = [ring_camera((i + 0.25) * n_fuse / args.n_eval + 0.5 / n_fuse, n_fuse, w, h,
                             make=make) for i in range(args.n_eval)]
    return SimpleNamespace(params=params, alive=alive, cls=cls_full, n_gaussians=len(pts),
                           text=text, lookup=lookup, cams=cams, eval_cams=eval_cams)


def eval_pair_budget(cam, params, alive, backend="tiled"):
    """(the eval renders' pair budget, a probe render's live pairs): the
    budget is tuned to the probe's pair count (the capacity's default
    would give a D-channel render a needlessly large pack buffer); None
    with the dense oracle, which has no pair stream."""
    import torch

    from ..pipelines.train import tuned_pair_budget
    from ..renderer import render

    with torch.no_grad():
        probe = render(cam, params, alive=alive, backend=backend)
    pairs = int(probe["num_pairs"])
    if int(probe["overflow"]):
        raise RuntimeError("the eval probe render overflowed its pair budget")
    if backend != "tiled":
        return None, pairs
    if pairs <= 0:
        raise RuntimeError("the eval probe render saw no pairs")
    return tuned_pair_budget(pairs), pairs


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="harness_out/semantic_harness.json")
    ap.add_argument("--state", default=None, help="resume file (chunked runs)")
    ap.add_argument("--max-seconds", type=float, default=1e9)
    ap.add_argument("--density", type=int, default=3, help="scene density (3: ~206k Gaussians)")
    ap.add_argument("--dim", type=int, default=512, help="feature width (CLIP space)")
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--n-fuse", type=int, default=30)
    ap.add_argument("--n-eval", type=int, default=8)
    ap.add_argument("--chunk-views", type=int, default=3, help="fusion views a dispatch")
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--epoch-block", type=int, default=25,
                    help="distill steps between two saves of the resume state")
    ap.add_argument("--voxel-size", type=float, default=0.02)
    ap.add_argument("--voxel-budget", type=int, default=65536)
    ap.add_argument("--workdir", default="harness_out/semantic_harness")
    ap.add_argument("--backend", default="tiled", help="render backend (tiled or dense)")
    ap.add_argument("--feat-dtype", default="float16",
                    help="dtype of the 2D feature maps handed to fusion (the reference "
                         "stores features in float16; accumulation is float32)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def _atomic_torch_save(obj, path) -> None:
    import torch

    p = Path(path)
    tmp = p.with_name(p.name + ".tmp")
    torch.save(obj, tmp)
    tmp.replace(p)


def run(args):
    """The three stages; returns (report, extra): the report has the JAX
    tool's keys, `extra` the confusions, the labelled pixel counts and the
    device. Raises SystemExit(3) when --max-seconds cuts a run."""
    import torch

    from ..io.ply import save_gaussian_ply
    from ..models.unet3d import GRID_MAX
    from ..pipelines.distill import (
        DistillConfig, FeatureDataset, item_tensors, make_distill_state, make_distill_step,
        make_gaussian_features,
    )
    from ..pipelines.eval_segmentation import ensemble_argmax_class, eval_views
    from ..pipelines.fusion import (
        FusionConfig, _fuse_chunk, _intrinsic_for, load_fused_features, save_fused_features,
    )
    from ..pipelines.train import stack_camera_chunk
    from ..utils.device import card_stamp, resolve_device
    from ..utils.graphs import GraphRunner
    from ..utils.logging_utils import device_busy_ms, profile_trace

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    t_start = time.time()
    work = Path(args.workdir)
    work.mkdir(parents=True, exist_ok=True)
    w, h, D = args.width, args.height, args.dim
    sc = build_scene(args, dev)
    params, alive, cls_full, text, lookup = sc.params, sc.alive, sc.cls, sc.text, sc.lookup
    cams, eval_cams, cap = sc.cams, sc.eval_cams, params.capacity
    print(f"scene: {sc.n_gaussians} gaussians (cap {cap}); {w}x{h}; D={D}", flush=True)

    gt_cache = work / f"gt_d{args.density}_{w}x{h}_f{args.n_fuse}_e{args.n_eval}.npz"
    cached = gt_cache.exists()
    t0 = time.time()
    gts_all = build_gt_maps(cams + eval_cams, params, alive, cls_full, gt_cache,
                            backend=args.backend)
    gt_fuse, gt_eval = gts_all[: args.n_fuse], gts_all[args.n_fuse:]
    print(f"GT label maps: {time.time() - t0:.1f}s (cached: {cached})", flush=True)

    st = dict(stage="fuse", view_done=0, sem_path=None, epoch=0, timings=dict(), losses=[],
              metrics=dict())
    if args.state and Path(args.state).exists():
        st = pickle.loads(Path(args.state).read_bytes())
        print(f"resumed: stage={st['stage']} view={st['view_done']} epoch={st['epoch']}",
              flush=True)

    def save_state():
        if args.state:
            atomic_write(args.state, pickle.dumps(st))

    def out_of_budget():
        return time.time() - t_start > args.max_seconds

    fcfg = FusionConfig(img_dim=(w, h), every_k_views=1, depth="render", cut_boundary=10,
                        visibility_threshold=0.05, chunk_views=args.chunk_views)
    ply_path = work / "point_cloud.ply"
    fused_path = work / "fused_0.pt"

    # ================= stage 1: fusion =================
    if st["stage"] == "fuse":
        k = args.chunk_views
        if st["sem_path"] and Path(st["sem_path"]).exists():
            blob = torch.load(st["sem_path"], map_location=dev)
            sem, counts = blob["sem"], blob["counts"]
        else:
            sem = torch.zeros((cap, D), dtype=torch.float32, device=dev)
            counts = torch.zeros((cap,), dtype=torch.float32, device=dev)
        lookup_t = torch.from_numpy(lookup.astype(np.dtype(args.feat_dtype))).to(dev)
        runner = GraphRunner(dev)
        fuse_t = st["timings"].setdefault("fuse", dict(wall_s=0.0, views=0, chunks=[]))
        while st["view_done"] < args.n_fuse:
            t0 = time.time()
            batch = list(range(st["view_done"], min(st["view_done"] + k, args.n_fuse)))
            pad = k - len(batch)
            idxs = batch + [batch[-1]] * pad
            cam_stack = stack_camera_chunk(
                [dataclasses.replace(cams[i], image=None) for i in idxs])
            t_feat = time.time()
            # the oracle's maps, made on the device from the label images
            feats = lookup_t[torch.from_numpy(np.stack([gt_fuse[i] for i in idxs]).astype(
                np.int64)).to(dev)]
            sync()
            transfer_s = time.time() - t_feat
            inputs = dict(
                feat=feats,
                intrinsic=torch.from_numpy(np.stack(
                    [_intrinsic_for(cams[i], fcfg.img_dim) for i in idxs])).to(dev),
                weight=torch.tensor([1.0] * len(batch) + [0.0] * pad, device=dev),
            )
            with torch.no_grad():
                sem, counts = _fuse_chunk(runner, sem, counts, params, alive, cam_stack, inputs,
                                          fcfg, "render", args.backend, None)
            sync()
            del feats, inputs
            dt = time.time() - t0
            st["view_done"] += len(batch)
            fuse_t["wall_s"] += dt
            fuse_t["views"] = st["view_done"]
            fuse_t["chunks"].append(dict(views=len(batch), s=round(dt, 2),
                                         transfer_s=round(transfer_s, 2)))
            print(f"fuse: {st['view_done']}/{args.n_fuse} views ({dt:.1f}s chunk, "
                  f"{transfer_s:.1f}s maps)", flush=True)
            if args.state:
                sem_path = work / "fuse_acc.pt"
                _atomic_torch_save(dict(sem=sem.cpu(), counts=counts.cpu()), sem_path)
                st["sem_path"] = str(sem_path)
                save_state()
                if out_of_budget() and st["view_done"] < args.n_fuse:
                    print("CHUNK DONE (fuse); resume me", flush=True)
                    raise SystemExit(3)
        fuse_t["graphs"] = dict(captures=runner.captures, replays=runner.replays)
        del runner

        visited = counts > 0
        fused = (sem / torch.clamp(counts, min=1.0)[:, None]).cpu().numpy()
        vis = visited.cpu().numpy()
        del sem, counts
        # fused-vs-oracle cosine over the visited, labelled Gaussians
        labeled = (cls_full < len(LABELS)) & vis
        gtf = lookup[np.minimum(cls_full, len(LABELS))]  # [cap, D]
        num = (fused * gtf).sum(-1)
        den = np.linalg.norm(fused, axis=-1) * np.linalg.norm(gtf, axis=-1)
        cos = num[labeled] / np.maximum(den[labeled], 1e-8)
        st["metrics"]["fused_cos_mean"] = float(cos.mean())
        st["metrics"]["fused_cos_p10"] = float(np.percentile(cos, 10))
        st["metrics"]["visited_frac_labeled"] = float(
            (vis & (cls_full < len(LABELS))).sum() / max((cls_full < len(LABELS)).sum(), 1))
        t0 = time.time()
        save_gaussian_ply(ply_path, params, alive.cpu().numpy())
        save_fused_features(fused_path, fused, vis)
        st["timings"]["fuse"]["save_s"] = round(time.time() - t0, 1)
        st["stage"] = "distill"
        save_state()
        print(f"fusion done: cos={cos.mean():.4f} "
              f"visited={st['metrics']['visited_frac_labeled']:.3f}", flush=True)

    # ================= stage 2: distill =================
    dcfg = DistillConfig(model_3d=MODEL_3D, feature_dim=D, in_channels=56,
                         voxel_size=args.voxel_size, epochs=args.epochs, lr=1e-3)
    ds = FeatureDataset([str(ply_path)], [str(fused_path)], voxel_size=args.voxel_size,
                        aug=True, voxel_budget=args.voxel_budget)
    model, opt, schedule = make_distill_state(dcfg, len(ds), seed=0, device=dev)
    ck = work / "distill_state.pt"
    if st["stage"] == "distill":
        if st["epoch"] > 0 and ck.exists():
            blob = torch.load(ck, map_location=dev)
            model.load_state_dict(blob["model"])
            opt.load_state_dict(blob["opt"])
        # one step an epoch (one scene): a resumed run's schedule starts at the
        # steps already made
        done = st["epoch"]
        step = make_distill_step(model, opt, lambda t: schedule(t + done), dcfg)
        drng = np.random.default_rng(1000 + st["epoch"])
        dis_t = st["timings"].setdefault("distill", dict(wall_s=0.0, epochs=0))
        item_ms, step_ms, voxels = [], [], []
        n_here = 0
        while st["epoch"] < args.epochs:
            t0 = time.time()
            n_block = min(args.epoch_block, args.epochs - st["epoch"])
            for _ in range(n_block):
                t_item = time.perf_counter()
                item = ds.__getitem__(0, seed=int(drng.integers(1 << 31)))
                max_c = int(item.coords.max()) if item.coords.size else 0
                hi = max(1, min(100, GRID_MAX - max_c))
                coords = item.coords + drng.integers(0, hi, size=(1, 3)).astype(np.int32)
                tensors = item_tensors(item, coords, dev)
                t_step = time.perf_counter()
                item_ms.append((t_step - t_item) * 1e3)
                voxels.append(item.num_voxels)
                traced = on_card and n_here == PROFILED_STEP
                if traced:
                    trace = work / "distill_trace"
                    with profile_trace(trace):
                        loss = step(*tensors)
                        sync()
                    dis_t["profiled_step"] = dict(
                        traced_wall_ms=(time.perf_counter() - t_step) * 1e3,
                        device_busy_ms=device_busy_ms(trace), voxels=item.num_voxels)
                else:
                    loss = step(*tensors)
                st["losses"].append(float(loss))  # float() waits for the step
                if not traced:  # the profiler lengthens the wall it traces
                    step_ms.append((time.perf_counter() - t_step) * 1e3)
                n_here += 1
            st["epoch"] += n_block
            dt = time.time() - t0
            dis_t["wall_s"] += dt
            dis_t["epochs"] = st["epoch"]
            dis_t["s_per_epoch"] = round(dis_t["wall_s"] / max(st["epoch"], 1), 2)
            dis_t["item_ms_median"] = statistics.median(item_ms)
            dis_t["step_ms_median"] = statistics.median(step_ms)
            prof = dis_t.get("profiled_step")
            if prof is not None:  # the traced step's device time over an untraced wall
                prof["untraced_step_ms_median"] = dis_t["step_ms_median"]
                prof["device_busy_share"] = prof["device_busy_ms"] / dis_t["step_ms_median"]
            dis_t["voxels_mean"] = float(np.mean(voxels))
            print(f"distill: epoch {st['epoch']}/{args.epochs} loss={st['losses'][-1]:.4f} "
                  f"({dt:.1f}s block)", flush=True)
            if args.state:
                _atomic_torch_save(dict(model=model.state_dict(), opt=opt.state_dict()), ck)
                save_state()
                if out_of_budget() and st["epoch"] < args.epochs:
                    print("CHUNK DONE (distill); resume me", flush=True)
                    raise SystemExit(3)
        _atomic_torch_save(dict(model=model.state_dict(), opt=opt.state_dict()), ck)
        st["stage"] = "eval"
        save_state()
    else:
        model.load_state_dict(torch.load(ck, map_location=dev)["model"])

    # ================= stage 3: eval =================
    feats_2d, _ = load_fused_features(fused_path, capacity=cap, device=dev)
    text_t = torch.from_numpy(text).to(dev)
    gt_eval = [g.astype(np.int64) for g in gt_eval]

    eval_budget, pairs = eval_pair_budget(eval_cams[0], params, alive, args.backend)
    st["metrics"]["live_pairs"] = pairs
    print(f"eval: {pairs} live pairs -> budget {eval_budget}", flush=True)

    # the distilled per-Gaussian features (an unaugmented voxelization)
    t0 = time.time()
    _, gaussian_features = make_gaussian_features(params, alive, "all", args.voxel_size,
                                                  args.voxel_budget)
    feats_3d = gaussian_features(model)
    sync()
    infer_s = time.time() - t0

    ev, confusions, mious = {}, {}, {}
    runs = (("2d", feats_2d, False), ("3d", feats_3d, True), ("2d_and_3d", None, True))
    for mode, feats, on_3d in runs:
        t0 = time.time()
        if feats is None:
            cls_ens = ensemble_argmax_class(feats_2d, feats_3d, text_t)
            feats = text_t[cls_ens] * alive[:, None]
        miou, macc, conf = eval_views(
            eval_cams, gt_eval, params, alive, feats, text, LABELS, pred_on_3d=on_3d,
            backend=args.backend, stdout=False, chunk_views=args.n_eval,
            pair_budget=eval_budget)
        ev[mode] = dict(miou=round(miou, 4), macc=round(macc, 4),
                        wall_s=round(time.time() - t0, 1))
        confusions[mode], mious[mode] = conf, miou
        print(f"eval {mode}: mIoU {miou:.4f} ({ev[mode]['wall_s']}s)", flush=True)
    ev["3d"]["unet_infer_s"] = round(infer_s, 1)
    st["timings"]["eval"] = ev

    m = st["metrics"]
    m.update(miou_2d=mious["2d"], miou_3d=mious["3d"], miou_ensemble=mious["2d_and_3d"],
             distill_final_loss=float(np.mean(st["losses"][-10:])))
    checks = dict(
        fused_cos=m["fused_cos_mean"] > 0.95,
        visited=m["visited_frac_labeled"] > 0.7,
        distill_converged=m["distill_final_loss"] < 0.15,
        miou_2d=m["miou_2d"] > 0.9,
        miou_3d=m["miou_3d"] > 0.8,
        miou_ensemble=m["miou_ensemble"] > 0.8,
    )
    report = dict(
        config=dict(
            n_gaussians=sc.n_gaussians, capacity=cap, dim=D, width=w, height=h,
            feat_dtype=args.feat_dtype, n_fuse_views=args.n_fuse, n_eval_views=args.n_eval,
            density=args.density, epochs=args.epochs, voxel_size=args.voxel_size,
            voxel_budget=args.voxel_budget, model_3d=dcfg.model_3d, device=card_stamp(dev),
        ),
        timings=st["timings"],
        metrics=m,
        loss_curve=st["losses"][:: max(1, len(st["losses"]) // 100)],
        checks=checks,
        wall_s_total=round(
            st["timings"]["fuse"]["wall_s"] + st["timings"]["distill"]["wall_s"]
            + sum(v["wall_s"] for v in ev.values()), 1),
    )
    labelled = int(sum(int((g < len(LABELS)).sum()) for g in gt_eval))
    extra = dict(confusions=confusions, labelled_pixels=labelled,
                 counted_pixels={k: int(c.sum()) for k, c in confusions.items()},
                 wall_s=time.time() - t_start)
    return report, extra


def main(argv=None):
    args = parse_args(argv)
    report, extra = run(args)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    checks = report["checks"]
    print(json.dumps(dict(metrics=report["metrics"], checks=checks,
                          counted_pixels=extra["counted_pixels"],
                          labelled_pixels=extra["labelled_pixels"])))
    if not all(checks.values()):
        print("SEMANTIC HARNESS: CHECK FAILURES", flush=True)
        sys.exit(1)
    print("SEMANTIC HARNESS: OK")
    return report


if __name__ == "__main__":
    main()
