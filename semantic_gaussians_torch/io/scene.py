"""Scene loading: format sniffing and loaders for ScanNet, COLMAP and
Blender layouts, in numpy + PIL.

The port's own copy of semantic_gaussians_tpu.io.scene. Sniffing: `pose/`
-> ScanNet (color/ pose/ intrinsic/intrinsic_color.txt, non-finite poses
skipped, every 8th view held out for test), `sparse/` -> COLMAP,
`transforms_train.json` -> Blender (OpenGL -> COLMAP axis flip,
camera_angle_x). The scene extent is 1.1 x the largest camera distance
from the cameras' mean centre. `realize_camera` makes the port's torch
Camera, with its image, on a device.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from pathlib import Path
from typing import List, NamedTuple, Optional

import numpy as np

from ..utils.camera import focal2fov, fov2focal, make_camera
from .colmap import intrinsics_to_fov, load_colmap_model, qvec2rotmat
from .ply import load_point_cloud, save_point_cloud


class CameraInfo(NamedTuple):
    uid: int
    R: np.ndarray  # camera-to-world rotation (reference's transposed storage)
    T: np.ndarray  # world-to-camera translation
    fov_x: float
    fov_y: float
    image_path: str
    image_name: str
    width: int
    height: int


@dataclasses.dataclass
class SceneInfo:
    points: np.ndarray
    colors: np.ndarray
    normals: np.ndarray
    train_cameras: List[CameraInfo]
    test_cameras: List[CameraInfo]
    nerf_normalization: dict
    ply_path: Optional[str]


def nerfpp_norm(cam_infos: List[CameraInfo]) -> dict:
    """Scene translate/radius from camera centres."""
    centers = []
    for c in cam_infos:
        w2c = np.eye(4)
        w2c[:3, :3] = c.R.T
        w2c[:3, 3] = c.T
        c2w = np.linalg.inv(w2c)
        centers.append(c2w[:3, 3])
    centers = np.stack(centers)
    avg = centers.mean(axis=0)
    dist = np.linalg.norm(centers - avg, axis=1)
    diagonal = float(dist.max())
    return {"translate": -avg, "radius": diagonal * 1.1}


# --------------------------------------------------------------------------
# ScanNet (preprocessed layout: color/ pose/ intrinsic/intrinsic_color.txt)
# --------------------------------------------------------------------------
def load_scannet_scene(
    path, eval_split: bool = True, llffhold: int = 8, downscale: float = 1.0
) -> SceneInfo:
    path = Path(path)
    intr = np.loadtxt(path / "intrinsic" / "intrinsic_color.txt")
    color_dir = path / "color"
    names = sorted(os.listdir(color_dir), key=lambda s: int(Path(s).stem))
    from PIL import Image

    first = Image.open(color_dir / names[0])
    width, height = first.size
    width = int(width / downscale)
    height = int(height / downscale)
    fov_x = 2 * math.atan(width / (2 * intr[0, 0] / downscale))
    fov_y = 2 * math.atan(height / (2 * intr[1, 1] / downscale))

    infos = []
    for i, name in enumerate(names):
        pose = np.loadtxt(path / "pose" / (Path(name).stem + ".txt"))
        if not np.isfinite(pose).all():
            continue
        w2c = np.linalg.inv(pose)  # pose is camera-to-world
        R = w2c[:3, :3].T  # stored transposed, reference convention
        T = w2c[:3, 3]
        infos.append(
            CameraInfo(
                uid=i, R=R, T=T, fov_x=fov_x, fov_y=fov_y,
                image_path=str(color_dir / name), image_name=Path(name).stem,
                width=width, height=height,
            )
        )
    if eval_split:
        train = [c for i, c in enumerate(infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(infos) if i % llffhold == 0]
    else:
        train, test = infos, []

    ply_path = path / "points3d.ply"
    if ply_path.exists():
        pts, cols, nrm = load_point_cloud(ply_path)
    else:
        # random init inside the camera bounding box
        pts, cols, nrm = _random_pcd_from_cameras(infos)
        save_point_cloud(ply_path, pts, cols, nrm)
    return SceneInfo(
        pts, cols, nrm, train, test, nerfpp_norm(train), str(ply_path)
    )


def _random_pcd_from_cameras(infos, num_pts=100_000):
    centers = []
    for c in infos:
        w2c = np.eye(4)
        w2c[:3, :3] = c.R.T
        w2c[:3, 3] = c.T
        centers.append(np.linalg.inv(w2c)[:3, 3])
    centers = np.stack(centers)
    lo, hi = centers.min(0) - 1.0, centers.max(0) + 1.0
    rng = np.random.default_rng(0)
    pts = rng.uniform(lo, hi, size=(num_pts, 3)).astype(np.float32)
    cols = rng.uniform(size=(num_pts, 3)).astype(np.float32)
    return pts, cols, np.zeros_like(pts)


# --------------------------------------------------------------------------
# COLMAP
# --------------------------------------------------------------------------
def load_colmap_scene(
    path,
    images_dir: str = "images",
    eval_split: bool = True,
    llffhold: int = 8,
    downscale: float = 1.0,
) -> SceneInfo:
    path = Path(path)
    sparse = path / "sparse" / "0"
    if not sparse.exists():
        sparse = path / "sparse"
    cams, images, pts3d = load_colmap_model(sparse)

    infos = []
    for iid in sorted(images.keys()):
        im = images[iid]
        cam = cams[im.camera_id]
        R = qvec2rotmat(im.qvec).T  # stored transposed (reference convention)
        T = im.tvec
        fov_x, fov_y = intrinsics_to_fov(cam)
        w = int(cam.width / downscale)
        h = int(cam.height / downscale)
        infos.append(
            CameraInfo(
                uid=iid, R=R, T=T, fov_x=fov_x, fov_y=fov_y,
                image_path=str(path / images_dir / im.name),
                image_name=Path(im.name).stem, width=w, height=h,
            )
        )
    if eval_split:
        train = [c for i, c in enumerate(infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(infos) if i % llffhold == 0]
    else:
        train, test = infos, []

    ply_path = sparse / "points3D.ply"  # same model dir the .bin came from
    if pts3d is not None:
        pts, cols, _ = pts3d
        nrm = np.zeros_like(pts)
    elif ply_path.exists():
        pts, cols, nrm = load_point_cloud(ply_path)
    else:
        pts, cols, nrm = _random_pcd_from_cameras(infos)
    return SceneInfo(
        pts, cols, nrm, train, test, nerfpp_norm(train), None
    )


# --------------------------------------------------------------------------
# Blender / NeRF-synthetic
# --------------------------------------------------------------------------
def load_blender_scene(
    path, white_background: bool = False, eval_split: bool = True,
    downscale: float = 1.0,
) -> SceneInfo:
    path = Path(path)

    def read_split(fname, uid0=0):
        meta = json.load(open(path / fname))
        infos = []
        for i, frame in enumerate(meta["frames"]):
            c2w = np.array(frame["transform_matrix"])
            c2w[:3, 1:3] *= -1  # OpenGL -> COLMAP
            w2c = np.linalg.inv(c2w)
            R = w2c[:3, :3].T
            T = w2c[:3, 3]
            img_rel = frame["file_path"]
            img_path = path / (img_rel + ".png")
            if not img_path.exists():
                img_path = path / img_rel
            from PIL import Image

            with Image.open(img_path) as im:
                w0, h0 = im.size
            w = int(w0 / downscale)
            h = int(h0 / downscale)
            if "fl_x" in frame:
                fov_x = focal2fov(frame["fl_x"], w0)
            else:
                fov_x = float(meta["camera_angle_x"])
            fov_y = focal2fov(fov2focal(fov_x, w0), h0)
            infos.append(
                CameraInfo(
                    uid=uid0 + i, R=R, T=T, fov_x=fov_x, fov_y=fov_y,
                    image_path=str(img_path), image_name=Path(img_rel).stem,
                    width=w, height=h,
                )
            )
        return infos

    train = read_split("transforms_train.json")
    test = []
    if eval_split and (path / "transforms_test.json").exists():
        test = read_split("transforms_test.json", uid0=len(train))

    ply_path = path / "points3d.ply"
    if ply_path.exists():
        pts, cols, nrm = load_point_cloud(ply_path)
    else:
        # random init in Blender bounds
        rng = np.random.default_rng(0)
        pts = (rng.random((100_000, 3)) * 2.6 - 1.3).astype(np.float32)
        cols = rng.random((100_000, 3)).astype(np.float32)
        nrm = np.zeros_like(pts)
    return SceneInfo(
        pts, cols, nrm, train, test, nerfpp_norm(train), None
    )


# --------------------------------------------------------------------------
# Sniffing + camera realization
# --------------------------------------------------------------------------
def load_scene(path, eval_split: bool = True, downscale: float = 1.0,
               images_dir: str = "images", white_background: bool = False
               ) -> SceneInfo:
    """Load a scene, its layout sniffed from the directory."""
    p = Path(path)
    if (p / "pose").exists():
        return load_scannet_scene(p, eval_split, downscale=downscale)
    if (p / "sparse").exists():
        return load_colmap_scene(
            p, images_dir, eval_split, downscale=downscale
        )
    if (p / "transforms_train.json").exists():
        return load_blender_scene(
            p, white_background, eval_split, downscale=downscale
        )
    raise ValueError(f"Could not recognize scene type for {path}")


def load_image(path, width=None, height=None, white_background=False):
    """[H,W,3] float 0..1; RGBA composited over bg; resized to
    (width, height) when given."""
    from PIL import Image

    im = Image.open(path)
    if width is not None and (im.size != (width, height)):
        im = im.resize((width, height), Image.LANCZOS)
    arr = np.asarray(im).astype(np.float32) / 255.0
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=-1)
    if arr.shape[-1] == 4:
        bg = 1.0 if white_background else 0.0
        arr = arr[..., :3] * arr[..., 3:4] + bg * (1 - arr[..., 3:4])
    return arr[..., :3]


def realize_camera(info: CameraInfo, with_image: bool = True,
                   white_background: bool = False, device="cpu"):
    """CameraInfo -> the port's Camera on `device` (loads the image file)."""
    img = None
    if with_image and info.image_path and os.path.exists(info.image_path):
        img = load_image(
            info.image_path, info.width, info.height, white_background
        )
    return make_camera(
        info.R, info.T, info.fov_x, info.fov_y, info.width, info.height,
        image=img, image_name=info.image_name, device=device,
    )
