"""3DGS training entry point (port of the root train.py): RGB, Feature 3DGS or
Gaussian Grouping.

Usage:
    python -m semantic_gaussians_torch.cli.train \\
        semantic_gaussians_torch/config/yamls/official_train.yaml \\
        scene.scene_path=/data/scene0000_00 train.exp_name=run1 [--device cpu]

Trains on CUDA (`train.device`, default cuda) and raises if CUDA is absent
unless the CPU was asked for (`--device cpu` or `train.device=cpu`).
Writes `<train.out_dir or output/<exp_name>>/`: config.yaml, the PLY at
each save milestone and the last iteration, and a checkpoint (`ckpt_<it>.pt`)
at each checkpoint milestone, and TensorBoard logs under `tb_logs/` (where
tensorboard is installed). Prints test-view L1 / PSNR (the first 8 test
views) at each test milestone; a milestone of 0 evaluates the initial
state. `train.steps_per_dispatch` (default 10) steps go in one chunk, on
CUDA one CUDA-graph replay (pipelines.train.train_loop); 1 runs every step
eagerly.

With `model.feature_dim=D` (> 0) it trains Feature 3DGS (Zhou et al., CVPR
2024): a D-channel feature field rendered with the colour in one composite
and fit to a 2D teacher's maps, one per training image in
`train.feature_dir` (`<image name>.npy|.npz|.pt`, [H, W, D] or [D, H, W],
resized nearest to the view), held on the device in float16 (as LSeg's
exported maps; the loss upcasts them), at `train.semantic_feature_lr` and
`train.lambda_feature`. The field starts at zero. Beside each PLY it writes
the field as fused features, `point_cloud/iteration_<it>/features/<scene
name>/0.pt` ({feat, mask_full}, pipelines.fusion.save_fused_features), so
that `fusion.out_dir=<that features dir>` hands them to the eval CLI (mode
2d) and the viewer. Feature fields train on one device.

With `model.num_objects=D` (> 0) it trains Gaussian Grouping (Ye et al.,
ECCV 2024; core.grouping): a D-channel identity field (their 16), started
at RGB2SH of a uniform draw and trained at `train.feature_lr` as theirs,
composited with the colour, a classifier of `train.num_classes` classes
(torch's Conv2d init, its own Adam at their fixed lr 5e-4 and eps 1e-8),
the cross-entropy against each view's object map
(`train.object_dir/<image name>.png`, 8-bit ids, resized nearest to the
view, held on the device) and every `train.reg3d_interval`-th iteration the
3D term (`train.lambda_3d`, `reg3d_k`, `reg3d_max_points`, `reg3d_sample`;
draws keyed by `pipeline.seed`). Beside each PLY it writes
`classifier.pt` ({weight, bias}) and `identity.pt` ({identity}: the
field's rows in the PLY's order). One device only.

With `pipeline.distributed=true` every process is one rank (a card, or a
CPU process with `--device cpu`, which runs on gloo): the process group is
made first (parallel.multihost.init_distributed, from the SGTPU_* or a
launcher's RANK / WORLD_SIZE / LOCAL_RANK variables; NCCL on CUDA unless
`pipeline.dist_backend` names another, e.g. gloo for ranks that share one
card), then the (view = node, band = rank in the node) mesh, and
parallel.train_parallel.hybrid_train_loop trains (`pipeline.zero=true`:
the ZeRO steps). Rank 0 alone writes config.yaml, the PLYs and the
checkpoints. Launched without those variables it trains as one rank.
"""
from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np
import torch

from ..config.config import load_config, pretty
from ..core.densify import DensifyConfig
from ..core.gaussians import init_from_pcd, num_alive, with_feature_field
from ..core.grouping import GroupingConfig, identity_init, init_classifier
from ..models.predictors import PrecomputedFeatureProvider
from ..core.optimizer import TrainHyper
from ..io.ply import save_gaussian_ply
from ..io.scene import load_scene, realize_camera
from ..parallel import multihost
from ..parallel.train_parallel import hybrid_train_loop
from ..pipelines.fusion import save_fused_features
from ..pipelines.train import TrainConfig, init_train_state, train_loop
from ..renderer import render
from ..utils.checkpoint import save_state
from ..utils.device import resolve_device
from ..utils.losses import l1_loss, psnr


def evaluate(state, cameras, bg, backend="tiled", pair_budget=None):
    """Mean L1 and PSNR over `cameras` (which carry their images)."""
    l1s, psnrs = [], []
    with torch.no_grad():
        for cam in cameras:
            out = render(cam, state.params, alive=state.alive, bg=bg, backend=backend,
                         pair_budget=pair_budget)
            l1s.append(float(l1_loss(out["render"], cam.image)))
            psnrs.append(float(psnr(out["render"], cam.image)))
    return float(np.mean(l1s)), float(np.mean(psnrs))


def load_teacher_maps(feature_dir, infos, dim: int, device) -> torch.Tensor:
    """[V, H, W, D] float16 on `device`: the teacher map of each camera in
    `infos`, looked up by image name (PrecomputedFeatureProvider's files),
    at the camera's size."""
    prov = PrecomputedFeatureProvider(feature_dir, dim, "float16")
    h, w = infos[0].height, infos[0].width
    if any((c.width, c.height) != (w, h) for c in infos):
        raise ValueError("a feature field's training views must share one size")
    out = torch.empty((len(infos), h, w, dim), dtype=torch.float16, device=device)
    for i, c in enumerate(infos):
        out[i] = torch.from_numpy(prov.extract_image_feature(c.image_path, (w, h)))
    return out


def load_object_maps(object_dir, infos, device) -> torch.Tensor:
    """[V, H, W] uint8 on `device`: each camera's object map,
    `<object_dir>/<image name>.png` (8-bit ids; a colour PNG's first
    channel), resized nearest to the camera's size."""
    from PIL import Image

    out = torch.empty((len(infos), infos[0].height, infos[0].width), dtype=torch.uint8)
    if any((c.width, c.height) != (infos[0].width, infos[0].height) for c in infos):
        raise ValueError("Gaussian Grouping's training views must share one size")
    for i, c in enumerate(infos):
        path = pathlib.Path(object_dir) / f"{c.image_name}.png"
        if not path.exists():
            raise FileNotFoundError(f"no object map for {c.image_name} in {object_dir}")
        img = Image.open(path)
        if img.size != (c.width, c.height):
            img = img.resize((c.width, c.height), Image.NEAREST)
        ids = np.array(img)
        out[i] = torch.from_numpy(ids if ids.ndim == 2 else ids[..., 0])
    return out.to(device)


def main(argv=None) -> dict:
    """Train as configured. Returns a summary: the final state, the
    training log of every chunk (train_loop's), test (L1, PSNR) by
    iteration and the PLYs written."""
    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("config")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args, overrides = ap.parse_known_args(argv)
    cfg = load_config(args.config, overrides)
    t = cfg.train
    dev_arg = args.device or t.get("device", "cuda")
    distributed = bool(cfg.pipeline.get("distributed", False))
    launched = False
    if distributed:  # before any CUDA work: it binds this rank's card first
        launched = multihost.init_distributed(device=dev_arg,
                                              backend=cfg.pipeline.get("dist_backend"))
        device = multihost.rank_device(dev_arg)
    else:
        device = resolve_device(dev_arg)
    try:
        return _train(cfg, t, device, distributed)
    finally:
        if launched:
            torch.distributed.destroy_process_group()


def _train(cfg, t, device, distributed) -> dict:
    primary = multihost.is_primary()
    print(pretty(cfg))
    seed = int(cfg.pipeline.get("seed", 0))
    generator = torch.Generator(device=device).manual_seed(seed)

    white = bool(cfg.scene.get("white_background", False))
    scene = load_scene(
        cfg.scene.scene_path,
        eval_split=bool(cfg.scene.get("test_cameras", True)),
        downscale=float(cfg.scene.get("downscale_ratio", 1)),
        images_dir=cfg.scene.get("colmap_images", "images"),
        white_background=white,
    )
    extent = float(scene.nerf_normalization["radius"])
    print(f"scene: {len(scene.train_cameras)} train / {len(scene.test_cameras)} test "
          f"cameras, {len(scene.points)} init points, extent {extent:.2f}")
    cameras = [realize_camera(c, white_background=white, device=device)
               for c in scene.train_cameras]
    test_cams = [realize_camera(c, white_background=white, device=device)
                 for c in scene.test_cameras[:8]]

    params, alive = init_from_pcd(
        scene.points, scene.colors, sh_degree=int(cfg.model.sh_degree),
        capacity=cfg.model.get("capacity"), device=device,
    )
    feature_dim = int(cfg.model.get("feature_dim") or 0)
    num_objects = int(cfg.model.get("num_objects") or 0)
    teacher = object_ids = classifier = grouping = None
    if feature_dim and num_objects:
        raise ValueError("model.feature_dim and model.num_objects: one field, not both")
    if (feature_dim or num_objects) and distributed:
        raise ValueError("a feature or identity field trains on one device, not distributed")
    if feature_dim:
        params = with_feature_field(params, feature_dim)
        teacher = load_teacher_maps(t.feature_dir, scene.train_cameras, feature_dim, device)
        print(f"teacher maps {tuple(teacher.shape)} {teacher.dtype} from {t.feature_dir}")
    if num_objects:
        feature_dim = num_objects
        grouping = GroupingConfig(
            num_classes=int(t.get("num_classes", 256)), lambda_3d=float(t.get("lambda_3d", 2.0)),
            reg3d_interval=int(t.get("reg3d_interval", 2)), reg3d_k=int(t.get("reg3d_k", 5)),
            reg3d_max_points=int(t.get("reg3d_max_points", 300_000)),
            reg3d_sample=int(t.get("reg3d_sample", 1000)), seed=seed)
        params = with_feature_field(params, num_objects,
                                    identity_init(params.capacity, num_objects, generator, device))
        classifier = init_classifier(grouping.num_classes, num_objects, generator, device)
        object_ids = load_object_maps(t.object_dir, scene.train_cameras, device)
        print(f"object maps {tuple(object_ids.shape)} from {t.object_dir}")
    state = init_train_state(params, alive, classifier)
    tc = TrainConfig(
        hyper=TrainHyper(
            position_lr_init=t.position_lr_init,
            position_lr_final=t.position_lr_final,
            position_lr_delay_mult=t.position_lr_delay_mult,
            position_lr_max_steps=t.position_lr_max_steps,
            feature_lr=t.feature_lr,
            opacity_lr=t.opacity_lr,
            scaling_lr=t.scaling_lr,
            rotation_lr=t.rotation_lr,
            semantic_feature_lr=float(t.feature_lr if num_objects
                                      else t.get("semantic_feature_lr", 0.001)),
        ),
        densify=DensifyConfig(
            grad_threshold=t.densify_grad_threshold, percent_dense=t.percent_dense,
        ),
        iterations=int(t.iterations),
        lambda_dssim=float(t.lambda_dssim),
        cut_edge=bool(t.get("cut_edge", False)),
        densification_interval=int(t.densification_interval),
        opacity_reset_interval=int(t.opacity_reset_interval),
        densify_from_iter=int(t.densify_from_iter),
        densify_until_iter=int(t.densify_until_iter),
        max_sh_degree=int(cfg.model.sh_degree),
        white_background=white,
        random_background=bool(t.get("random_background", False)),
        spatial_lr_scale=extent,
        feature_dim=feature_dim,
        lambda_feature=float(t.get("lambda_feature", 1.0)),
        grouping=grouping,
    )
    out_dir = pathlib.Path(t.get("out_dir") or pathlib.Path("output") / str(t.exp_name))
    if primary:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "config.yaml").write_text(pretty(cfg))
    if distributed:
        mesh = multihost.make_view_band_mesh()
        rank = torch.distributed.get_rank() if torch.distributed.is_initialized() else 0
        print(f"[distributed] rank {rank}, mesh {mesh.shape}, {device}")

    iters = int(t.iterations)
    save_iters = {int(i) for i in t.get("save_iterations", [])}
    ckpt_iters = {int(i) for i in t.get("checkpoint_iterations", [])}
    test_iters = {int(i) for i in t.get("test_iterations", [])}
    backend = cfg.pipeline.get("backend", "tiled")
    budget = cfg.pipeline.get("pair_budget")
    bg = torch.ones(3, device=device) if white else torch.zeros(3, device=device)
    # Milestones past the iteration count do not extend training.
    milestones = sorted(i for i in save_iters | ckpt_iters | test_iters | {iters}
                        if i <= iters)
    summary = dict(logs=[], tests={}, plys=[])
    done = 0
    for target in milestones:
        if target > done and distributed:
            # the loop returns the ZeRO moments gathered (every rank gathers)
            state, history = hybrid_train_loop(
                state, cameras, tc, generator, mesh, scene_extent=extent,
                num_iters=target - done, log_every=100, pair_budget=budget, iter_offset=done,
                zero=bool(cfg.pipeline.get("zero", False)),
            )
            summary["logs"].append(dict(history=history))
            done = target
        elif target > done:
            state, log = train_loop(
                state, cameras, tc, generator, extent, num_iters=target - done,
                backend=backend, log_every=100, pair_budget=budget, iter_offset=done,
                steps_per_dispatch=int(t.get("steps_per_dispatch", 10)),
                tb_dir=str(out_dir / "tb_logs"), teacher=teacher, object_ids=object_ids,
            )
            summary["logs"].append(log)
            done = target
        if target in test_iters and test_cams:
            l1, p = evaluate(state, test_cams, bg, backend, budget)
            summary["tests"][target] = (l1, p)
            multihost.primary_print(f"[test @ {target}] L1 {l1:.4f} PSNR {p:.2f}")
        if primary and (target in save_iters or target == iters):
            ply = out_dir / "point_cloud" / f"iteration_{target}" / "point_cloud.ply"
            save_gaussian_ply(ply, state.params, state.alive.cpu().numpy())
            summary["plys"].append(ply)
            if grouping is not None:  # the PLY's rows, in its order
                cls = state.classifier.params
                torch.save(dict(weight=cls.weight.cpu(), bias=cls.bias.cpu()),
                           ply.parent / "classifier.pt")
                torch.save(dict(identity=state.params.features[state.alive].cpu()),
                           ply.parent / "identity.pt")
            elif feature_dim:  # the PLY's rows, in its order
                feats = ply.parent / "features" / pathlib.Path(cfg.scene.scene_path).name / "0.pt"
                rows = state.params.features[state.alive].cpu().numpy()
                save_fused_features(feats, rows, np.ones(rows.shape[0], bool))
                summary.setdefault("features", []).append(feats)
            print(f"saved {ply} ({int(num_alive(state.alive))} gaussians)")
        if primary and target in ckpt_iters:
            save_state(out_dir / f"ckpt_{target}.pt", state)
            print(f"checkpointed iteration {target}")
    summary["state"] = state
    return summary


if __name__ == "__main__":
    main()
