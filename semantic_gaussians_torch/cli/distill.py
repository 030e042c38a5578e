"""3D distillation entry point (port of the root distill.py).

Usage:
    python -m semantic_gaussians_torch.cli.distill \\
        semantic_gaussians_torch/config/yamls/distill_scannet.yaml \\
        model.model_dir=... fusion.out_dir=... distill.exp_name=... [--device cpu]

Trains on CUDA (`distill.device`, default cuda) and raises if CUDA is absent
unless the CPU was asked for (`--device cpu` or `distill.device=cpu`).
`model.model_dir` holds one scene (point_cloud/iteration_N/point_cloud.ply)
or one subdirectory per scene; each scene's fused features are
`<fusion.out_dir>/<scene>/*.pt` (or `<fusion.out_dir>/*.pt`), one
(scene, file) pair per .pt. Writes model_<epoch>.npz checkpoints (the JAX
package's format) every `distill.save_interval` epochs to
`<distill.out_dir or output_distill/<exp_name>>/`. With
`distill.eval_scene` set, every `distill.eval_interval` epochs the net's
classes of that scene's Gaussians are rendered from three of its training
views to `<out>/semantic/<epoch>/<i>.png`.
"""
from __future__ import annotations

import argparse
import pathlib
import sys

from ..config.config import load_config, pretty
from ..data.feature_dataset import FeatureDataset
from ..pipelines.distill import DistillConfig, train_distill
from ..utils.checkpoint import latest_iteration
from ..utils.device import resolve_device


def _scene_ply(sd: pathlib.Path, load_it: int) -> pathlib.Path:
    it = load_it if load_it != -1 else latest_iteration(sd / "point_cloud")
    return sd / "point_cloud" / f"iteration_{it}" / "point_cloud.ply"


def main(argv=None) -> dict:
    """Distill as configured. Returns a summary: the trained model, the
    per-step losses, the output directory, the checkpoints written and the
    eval hook's PNG directories."""
    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("config")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args, overrides = ap.parse_known_args(argv)
    cfg = load_config(args.config, overrides)
    d = cfg.distill
    device = resolve_device(args.device or d.get("device", "cuda"))
    print(pretty(cfg))

    model_dir = pathlib.Path(cfg.model.model_dir)
    fusion_dir = pathlib.Path(cfg.fusion.out_dir)
    load_it = int(cfg.model.get("load_iteration", -1))
    plys, fused = [], []
    scene_dirs = (
        [model_dir] if (model_dir / "point_cloud").exists()
        else sorted(p for p in model_dir.iterdir() if p.is_dir()) if model_dir.is_dir() else []
    )
    for sd in scene_dirs:
        ply = _scene_ply(sd, load_it)
        fdir = fusion_dir / sd.name if (fusion_dir / sd.name).exists() else fusion_dir
        for pt in sorted(fdir.glob("*.pt")):
            plys.append(str(ply))
            fused.append(str(pt))
    print(f"distilling over {len(plys)} (scene, fusion-file) pairs")
    if not plys:
        raise FileNotFoundError(
            f"no (point_cloud.ply, fused .pt) pairs found under model_dir={model_dir} / "
            f"fusion.out_dir={fusion_dir}: check that the fusion out_dir contains "
            f"<scene>/*.pt matching the model_dir scene layout"
        )

    feature_type = d.get("feature_type", "all")
    voxel_size = float(d.get("voxel_size", 0.02))
    voxel_budget = int(d.get("voxel_budget", 200_000))
    ds = FeatureDataset(plys, fused, voxel_size=voxel_size, aug=bool(d.get("aug", True)),
                        feature_type=feature_type, voxel_budget=voxel_budget)
    dcfg = DistillConfig(
        model_3d=d.get("model_3d", "MinkUNet34A"),
        feature_dim=int(cfg.fusion.get("embedding_dim", 768)),
        in_channels=56 if feature_type == "all" else 48,
        lr=float(d.get("lr", 1e-3)),
        epochs=int(d.get("epochs", 100)),
        loss_type=d.get("loss_type", "cosine"),
        aug=bool(d.get("aug", True)),
    )
    out_dir = pathlib.Path(d.get("out_dir") or pathlib.Path("output_distill") / str(
        d.get("exp_name", "distill")))

    # The every-N-epoch semantic render of a validation scene: its Gaussians
    # come from model_dir/<scene name> (or model_dir for a single scene).
    eval_hook, hook_dirs = None, []
    if d.get("eval_scene"):
        from ..data.scannet_constants import COCOMAP_CLASS_LABELS, SCANNET20_CLASS_LABELS
        from ..io.scene import load_scene, realize_camera
        from ..models.predictors import RandomFeatureProvider, TorchCLIPTextEncoder
        from ..pipelines.distill import make_eval_render_hook
        from ..pipelines.eval_segmentation import text_feature_matrix

        labels = (SCANNET20_CLASS_LABELS if cfg.scene.get("dataset_name", "cocomap") == "scannet20"
                  else COCOMAP_CLASS_LABELS)
        tmp = (cfg.get("eval") or {}).get("text_model_path")
        if tmp:
            enc = TorchCLIPTextEncoder(tmp, dcfg.feature_dim)
        else:
            print("WARNING: no local CLIP checkpoint; random text features")
            enc = RandomFeatureProvider(dcfg.feature_dim)
        text = text_feature_matrix(enc, labels)
        escene = pathlib.Path(str(d.eval_scene))
        sd = model_dir / escene.name
        if not (sd / "point_cloud").exists():
            sd = model_dir
        esc = load_scene(str(escene), eval_split=False)
        cams = [realize_camera(c, with_image=False, device=device)
                for c in esc.train_cameras[::40][:3]]
        hook = make_eval_render_hook(
            _scene_ply(sd, load_it), cams, text, out_dir, dcfg, feature_type=feature_type,
            voxel_size=voxel_size, voxel_budget=voxel_budget,
            backend=(cfg.get("pipeline") or {}).get("backend", "tiled"), device=device,
        )

        def eval_hook(epoch, model):
            hook_dirs.append(hook(epoch, model))

    save_interval = int(d.get("save_interval", 10))
    epochs = dcfg.epochs
    model, _, losses = train_distill(
        ds, dcfg, log_every=1, ckpt_dir=str(out_dir), save_interval=save_interval,
        seed=int(cfg.pipeline.get("seed", 1)), eval_hook=eval_hook,
        eval_interval=int(d.get("eval_interval", 10)), device=device,
    )
    ckpts = [out_dir / f"model_{e}.npz" for e in range(save_interval, epochs + 1, save_interval)]
    return dict(model=model, losses=losses, out_dir=out_dir, checkpoints=ckpts,
                hook_dirs=hook_dirs, steps_per_epoch=len(ds), device=str(device))


if __name__ == "__main__":
    main()
