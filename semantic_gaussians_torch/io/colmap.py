"""COLMAP sparse-reconstruction parsing (binary + text), in numpy.

The port's own copy of semantic_gaussians_tpu.io.colmap: cameras.bin /
images.bin / points3D.bin parsing (and the text forms), qvec -> rotation
matrix, PINHOLE-family intrinsics to FoV, from the public COLMAP format.
"""
from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, NamedTuple

import numpy as np


class ColmapCamera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class ColmapImage(NamedTuple):
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str


CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    """COLMAP (w, x, y, z) quaternion -> rotation matrix."""
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
            [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
            [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
        ]
    )


def _read(f, n, fmt):
    return struct.unpack("<" + fmt, f.read(n))


def read_cameras_binary(path) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        for _ in range(num):
            cid, model_id, w, h = _read(f, 24, "iiQQ")
            name, np_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, 8 * np_params, "d" * np_params))
            cams[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return cams


def read_images_binary(path) -> Dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        for _ in range(num):
            iid = _read(f, 4, "i")[0]
            qvec = np.array(_read(f, 32, "dddd"))
            tvec = np.array(_read(f, 24, "ddd"))
            cam_id = _read(f, 4, "i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (num_p2d,) = _read(f, 8, "Q")
            f.read(24 * num_p2d)  # skip 2D points (x, y, point3D_id)
            images[iid] = ColmapImage(iid, qvec, tvec, cam_id, name.decode())
    return images


def read_points3d_binary(path):
    """-> (xyz [N,3], rgb [N,3] float 0..1, errors [N])."""
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        xyz = np.zeros((num, 3))
        rgb = np.zeros((num, 3))
        err = np.zeros(num)
        for i in range(num):
            data = _read(f, 43, "QdddBBBd")
            xyz[i] = data[1:4]
            rgb[i] = data[4:7]
            err[i] = data[7]
            (track_len,) = _read(f, 8, "Q")
            f.read(8 * track_len)
    return xyz.astype(np.float32), (rgb / 255.0).astype(np.float32), err


def read_cameras_text(path) -> Dict[int, ColmapCamera]:
    cams = {}
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        cams[int(parts[0])] = ColmapCamera(
            int(parts[0]), parts[1], int(parts[2]), int(parts[3]),
            np.array([float(x) for x in parts[4:]]),
        )
    return cams


def read_images_text(path) -> Dict[int, ColmapImage]:
    # Pairs of (header, POINTS2D) lines; the POINTS2D line may be EMPTY for
    # unregistered/filtered images, so blank lines must be kept (only
    # dropping them before the first header) or the 2-line pairing derails.
    images = {}
    lines = [
        l.strip() for l in open(path) if not l.strip().startswith("#")
    ]
    while lines and not lines[0]:
        lines.pop(0)
    for i in range(0, len(lines) - 0, 2):
        if not lines[i]:
            continue  # trailing blank line(s)
        parts = lines[i].split()
        images[int(parts[0])] = ColmapImage(
            int(parts[0]),
            np.array([float(x) for x in parts[1:5]]),
            np.array([float(x) for x in parts[5:8]]),
            int(parts[8]),
            parts[9],
        )
    return images


def read_points3d_text(path):
    rows = [
        l.split()
        for l in open(path)
        if l.strip() and not l.startswith("#")
    ]
    xyz = np.array([[float(x) for x in r[1:4]] for r in rows], np.float32)
    rgb = np.array([[float(x) for x in r[4:7]] for r in rows], np.float32) / 255.0
    err = np.array([float(r[7]) for r in rows])
    return xyz, rgb, err


def intrinsics_to_fov(cam: ColmapCamera):
    """(fov_x, fov_y) from PINHOLE-family params."""
    import math

    if cam.model == "SIMPLE_PINHOLE" or cam.model in (
        "SIMPLE_RADIAL", "RADIAL", "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE",
    ):
        fx = fy = cam.params[0]
    else:  # PINHOLE / OPENCV family: fx, fy first
        fx, fy = cam.params[0], cam.params[1]
    fov_x = 2 * math.atan(cam.width / (2 * fx))
    fov_y = 2 * math.atan(cam.height / (2 * fy))
    return fov_x, fov_y


def load_colmap_model(sparse_dir):
    """Read cameras/images/points3D from a sparse/0-style dir (bin or txt)."""
    sparse_dir = Path(sparse_dir)
    if (sparse_dir / "cameras.bin").exists():
        cams = read_cameras_binary(sparse_dir / "cameras.bin")
        images = read_images_binary(sparse_dir / "images.bin")
        pts = (
            read_points3d_binary(sparse_dir / "points3D.bin")
            if (sparse_dir / "points3D.bin").exists()
            else None
        )
    else:
        cams = read_cameras_text(sparse_dir / "cameras.txt")
        images = read_images_text(sparse_dir / "images.txt")
        pts = (
            read_points3d_text(sparse_dir / "points3D.txt")
            if (sparse_dir / "points3D.txt").exists()
            else None
        )
    return cams, images, pts
