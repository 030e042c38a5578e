"""3DGS training entry point (port of the root train.py), RGB or Feature 3DGS.

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
    teacher = None
    if feature_dim:
        if distributed:
            raise ValueError("model.feature_dim > 0 trains on one device, not distributed")
        params = with_feature_field(params, feature_dim)
        teacher = load_teacher_maps(t.feature_dir, scene.train_cameras, feature_dim, device)
        print(f"teacher maps {tuple(teacher.shape)} {teacher.dtype} from {t.feature_dir}")
    state = init_train_state(params, alive)
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
            semantic_feature_lr=float(t.get("semantic_feature_lr", 0.001)),
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
                tb_dir=str(out_dir / "tb_logs"), teacher=teacher,
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
            if feature_dim:  # the PLY's rows, in its order
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
