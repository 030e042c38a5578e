"""2D -> 3D fusion entry point (port of the root fusion.py).

Usage:
    python -m semantic_gaussians_torch.cli.fusion \\
        semantic_gaussians_torch/config/yamls/fusion_scannet.yaml \\
        scene.scene_path=... model.model_dir=... fusion.out_dir=... [--device cpu]

Fuses on CUDA (`fusion.device`, default cuda) and raises if CUDA is absent
unless the CPU was asked for (`--device cpu` or `fusion.device=cpu`). Loads
the trained Gaussians from `<model_dir>/point_cloud/iteration_<n>/` (or
`params.npz` with `model.dynamic`), fuses every k-th training view's
feature map onto them and writes `<fusion.out_dir>/<scene name>/0.pt`.
"""
from __future__ import annotations

import argparse
import pathlib
import sys

import torch

from ..config.config import load_config, pretty
from ..core.gaussians import params_from_numpy
from ..io.dynamic_npz import load_dynamic_npz
from ..io.ply import load_gaussian_ply
from ..io.scene import load_scene, realize_camera
from ..models.predictors import make_predictor
from ..pipelines.fusion import FusionConfig, fuse_scene, save_fused_features
from ..utils.checkpoint import latest_iteration
from ..utils.device import resolve_device


def load_model(cfg, device):
    """(params, alive) on `device` from `cfg.model`: the PLY of the asked
    (or latest) iteration, or timestep 0 of a dynamic scene."""
    model_dir = pathlib.Path(cfg.model.model_dir)
    if cfg.model.get("dynamic"):
        return load_dynamic_npz(model_dir / "params.npz").params_at(0, device=device)
    it = cfg.model.get("load_iteration", -1)
    if it == -1:
        it = latest_iteration(model_dir / "point_cloud")
    ply = model_dir / "point_cloud" / f"iteration_{it}" / "point_cloud.ply"
    arrays, alive = load_gaussian_ply(ply)
    print(f"loaded {ply}: {int(alive.sum())} gaussians")
    return params_from_numpy(arrays, device), torch.from_numpy(alive).to(device)


def main(argv=None) -> dict:
    """Fuse as configured. Returns a summary: the visited count, the output
    path, the number of views fused and the device."""
    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("config")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args, overrides = ap.parse_known_args(argv)
    cfg = load_config(args.config, overrides)
    f = cfg.fusion
    device = resolve_device(args.device or f.get("device", "cuda"))
    print(pretty(cfg))

    scene = load_scene(
        cfg.scene.scene_path,
        eval_split=bool(cfg.scene.get("test_cameras", False)),
        downscale=float(cfg.scene.get("downscale_ratio", 1)),
        images_dir=cfg.scene.get("colmap_images", "images"),
    )
    cameras = [realize_camera(c, with_image=False) for c in scene.train_cameras]
    image_paths = [c.image_path for c in scene.train_cameras]
    params, alive = load_model(cfg, device)
    provider = make_predictor(f.get("model_2d", "precomputed"), f, device)
    fcfg = FusionConfig(
        img_dim=tuple(f.get("img_dim", (648, 484))),
        every_k_views=int(f.get("every_k_views", 5)),
        depth=f.get("depth", "render"),
        depth_scale=float(f.get("depth_scale", 1000.0)),
        visibility_threshold=float(f.get("visibility_threshold", 0.05)),
        cut_boundary=int(f.get("cut_boundary", 10)),
        chunk_views=int(f.get("chunk_views", 4)),
        feat_dtype=str(f.get("feat_dtype", "float32")),
    )
    feats, visited = fuse_scene(
        params, alive, cameras, provider, fcfg, image_paths=image_paths,
        backend=(cfg.get("pipeline") or {}).get("backend", "tiled"),
    )
    scene_name = pathlib.Path(cfg.scene.scene_path).name
    out = pathlib.Path(f.out_dir) / scene_name / "0.pt"
    save_fused_features(
        out, feats.cpu().numpy(), visited.cpu().numpy(),
        n_split_points=int(f.get("n_split_points", 999_999_999)),
        num_rand_file_per_scene=int(f.get("num_rand_file_per_scene", 1)),
    )
    n_visited = int(visited.sum())
    print(f"fused {n_visited} gaussians -> {out}")
    return dict(visited=n_visited, out_path=out, device=str(device),
                views=len(cameras[:: fcfg.every_k_views]))


if __name__ == "__main__":
    main()
