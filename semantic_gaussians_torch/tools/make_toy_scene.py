"""Write a tiny synthetic Blender-layout scene (for end-to-end drives).

Port of the root tools/make_toy_scene.py: `n_gauss` random Gaussians
(seed 3) rendered with the dense oracle from a ring of `n_cams` cameras;
writes transforms_train.json (OpenGL-convention poses), one PNG a view and
points3d.ply.

    python -m semantic_gaussians_torch.tools.make_toy_scene OUT_DIR [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

import numpy as np
import torch

from ..cli.view_server import encode_png
from ..core.gaussians import init_from_pcd
from ..io.ply import save_point_cloud
from ..renderer import render
from ..utils.camera import make_camera_from_c2w
from ..utils.device import resolve_device


def make_toy_scene(out_dir, n_cams=6, w=128, h=96, n_gauss=300, seed=3, device=None) -> Path:
    dev = resolve_device(device)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n_gauss, 3)) * 0.4).astype(np.float32)
    cols = rng.uniform(size=(n_gauss, 3)).astype(np.float32)
    params, alive = init_from_pcd(pts, cols, sh_degree=3, device=dev)
    save_point_cloud(out / "points3d.ply", pts, cols)

    fov_x = 1.0
    frames = []
    for i in range(n_cams):
        ang = 2 * math.pi * i / n_cams
        r = 3.0
        pos = np.array([r * math.sin(ang), 0.3, -r * math.cos(ang)])
        fwd = -pos / np.linalg.norm(pos)
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        upv = np.cross(fwd, right)
        c2w_cv = np.eye(4)
        c2w_cv[:3, :3] = np.stack([right, upv, fwd], axis=1)
        c2w_cv[:3, 3] = pos
        cam = make_camera_from_c2w(c2w_cv, fov_x, fov_x * h / w, w, h, device=dev)
        with torch.no_grad():
            img = render(cam, params, alive, backend="dense")["render"]
        img8 = (np.clip(img.cpu().numpy(), 0, 1) * 255).astype(np.uint8)
        name = f"r_{i}"
        (out / f"{name}.png").write_bytes(encode_png(img8))
        # transforms json stores OpenGL-convention c2w (the loader flips back)
        c2w_gl = c2w_cv.copy()
        c2w_gl[:3, 1:3] *= -1
        frames.append({"file_path": name, "transform_matrix": c2w_gl.tolist()})
    (out / "transforms_train.json").write_text(
        json.dumps({"camera_angle_x": fov_x, "frames": frames}))
    print(f"wrote toy scene to {out} ({n_cams} views)")
    return out


def main(argv=None) -> Path:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return make_toy_scene(args.out_dir, device=args.device)


if __name__ == "__main__":
    main()
