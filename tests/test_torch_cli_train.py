"""The port's train CLI end to end on the CPU: a 300-point Blender-layout
toy scene written by the test, 30 iterations with one densify; the PLY is
written and the training views' PSNR rises."""
import json

import numpy as np
import torch

from semantic_gaussians_torch.cli.train import main as train_main
from semantic_gaussians_torch.cli.view_server import encode_png
from semantic_gaussians_torch.config.config import default_config_dir
from semantic_gaussians_torch.core.gaussians import init_from_pcd
from semantic_gaussians_torch.io.ply import load_gaussian_ply, save_point_cloud
from semantic_gaussians_torch.renderer import render
from semantic_gaussians_torch.utils.camera import make_camera
import torch_port_common  # noqa: F401  (one torch thread per test worker)

W, H, FOV = 64, 48, 0.9


def _ring_c2w(n, radius=5.0):
    """Blender (OpenGL) camera-to-world poses on a ring, looking at the origin."""
    poses = []
    for i in range(n):
        ang = 2 * np.pi * i / n
        pos = np.array([radius * np.sin(ang), 0.3, -radius * np.cos(ang)])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross(np.array([0.0, 1.0, 0.0]), fwd)
        right /= np.linalg.norm(right)
        up = np.cross(fwd, right)
        c2w = np.eye(4)
        c2w[:3, :3] = np.stack([right, -up, -fwd], axis=1)  # OpenGL axes
        c2w[:3, 3] = pos
        poses.append(c2w)
    return poses


def write_toy_scene(root, n=300, views=4, seed=0):
    """Blender layout: transforms_{train,test}.json, PNGs rendered by the
    port from a target scene, and points3d.ply with jittered colours."""
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, 3)) * 0.6).astype(np.float32)
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    target, alive = init_from_pcd(pts, cols, sh_degree=1, capacity=n)
    frames = []
    (root / "train").mkdir(parents=True)
    for i, c2w in enumerate(_ring_c2w(views)):
        flip = c2w.copy()
        flip[:3, 1:3] *= -1
        w2c = np.linalg.inv(flip)
        cam = make_camera(w2c[:3, :3].T, w2c[:3, 3], FOV, FOV * H / W, W, H)
        img = render(cam, target, alive, bg=torch.zeros(3))["render"]
        png = (np.clip(img.numpy(), 0, 1) * 255 + 0.5).astype(np.uint8)
        (root / "train" / f"r_{i}.png").write_bytes(encode_png(png))
        frames.append({"file_path": f"./train/r_{i}", "transform_matrix": c2w.tolist()})
    meta = {"camera_angle_x": FOV, "frames": frames}
    for split in ("train", "test"):
        (root / f"transforms_{split}.json").write_text(json.dumps(meta))
    jitter = np.clip(cols + rng.normal(size=cols.shape) * 0.5, 0, 1)
    save_point_cloud(root / "points3d.ply", pts, jitter, np.zeros_like(pts))


def test_train_cli_on_cpu(tmp_path):
    scene = tmp_path / "scene"
    write_toy_scene(scene)
    out = tmp_path / "out"
    summary = train_main([
        str(default_config_dir() / "official_train.yaml"), "--device", "cpu",
        f"scene.scene_path={scene}", f"train.out_dir={out}", "model.sh_degree=1",
        "train.iterations=30", "train.test_iterations=[0,30]", "train.save_iterations=[]",
        # one densify, at iteration 10; the threshold keeps it to a few
        # splits, which the remaining 20 steps absorb
        "train.densify_from_iter=5", "train.densification_interval=10",
        "train.densify_until_iter=11", "train.densify_grad_threshold=0.003",
    ])
    (l1_0, psnr_0), (l1_1, psnr_1) = summary["tests"][0], summary["tests"][30]
    assert psnr_1 > psnr_0 + 0.5, (psnr_0, psnr_1)
    log = summary["logs"][0]
    assert torch.isfinite(log["loss"]).all()
    assert [it for it, *_ in log["densify"]] == [10]
    assert log["densify"][0][1] > 300  # the alive count changed
    ply = out / "point_cloud" / "iteration_30" / "point_cloud.ply"
    assert summary["plys"] == [ply]
    arrays, alive = load_gaussian_ply(ply)
    assert alive.sum() == log["densify"][0][1] and np.isfinite(arrays["means"]).all()
