"""Camera model.

Port of semantic_gaussians_tpu.utils.camera. Matrices are plain
column-vector float32 tensors:
  p_cam  = world_view @ [p, 1]
  p_clip = full_proj  @ [p, 1]
They are built in float64 numpy and rounded once, exactly as the JAX
package does, so both packages see the same float32 matrices.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import numpy as np
import torch


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: float) -> float:
    return 2 * math.atan(pixels / (2 * focal))


def world_to_view(
    R: np.ndarray,
    t: np.ndarray,
    translate: np.ndarray = np.zeros(3),
    scale: float = 1.0,
) -> np.ndarray:
    """4x4 world->camera matrix; `R` is the camera-to-world rotation and `t`
    the world->camera translation (the reference's getWorld2View2 inputs)."""
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    C2W = np.linalg.inv(Rt)
    cam_center = (C2W[:3, 3] + translate) * scale
    C2W[:3, 3] = cam_center
    return np.linalg.inv(C2W).astype(np.float32)


def projection_matrix(
    znear: float, zfar: float, fov_x: float, fov_y: float
) -> np.ndarray:
    tan_half_fov_y = math.tan(fov_y / 2)
    tan_half_fov_x = math.tan(fov_x / 2)
    top = tan_half_fov_y * znear
    right = tan_half_fov_x * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    P[3, 2] = 1.0
    return P


@dataclasses.dataclass(frozen=True)
class Camera:
    """A single view: float32 matrices plus static sizes and fovs."""

    world_view: torch.Tensor  # [4,4] world->camera (column convention)
    full_proj: torch.Tensor  # [4,4] proj @ world_view
    camera_center: torch.Tensor  # [3]
    image: Optional[torch.Tensor]  # [H,W,3] in [0,1], or None
    width: int
    height: int
    fov_x: float
    fov_y: float
    znear: float = 0.01
    zfar: float = 100.0
    image_name: str = ""

    @property
    def tan_half_fov_x(self) -> float:
        return math.tan(self.fov_x / 2)

    @property
    def tan_half_fov_y(self) -> float:
        return math.tan(self.fov_y / 2)

    @property
    def focal_x(self) -> float:
        return fov2focal(self.fov_x, self.width)

    @property
    def focal_y(self) -> float:
        return fov2focal(self.fov_y, self.height)

    def resized(self, width: int, height: int) -> "Camera":
        """Same pose/fov, different render resolution."""
        return dataclasses.replace(self, width=width, height=height, image=None)

    def to(self, device: Union[str, torch.device]) -> "Camera":
        return dataclasses.replace(
            self,
            world_view=self.world_view.to(device),
            full_proj=self.full_proj.to(device),
            camera_center=self.camera_center.to(device),
            image=None if self.image is None else self.image.to(device),
        )


def make_camera(
    R: np.ndarray,
    t: np.ndarray,
    fov_x: float,
    fov_y: float,
    width: int,
    height: int,
    image: Optional[np.ndarray] = None,
    znear: float = 0.01,
    zfar: float = 100.0,
    translate: np.ndarray = np.zeros(3),
    scale: float = 1.0,
    image_name: str = "",
    device: Union[str, torch.device] = "cpu",
) -> Camera:
    """Camera from reference-style (R, t) extrinsics + FoVs."""
    wv = world_to_view(R, t, translate, scale)
    proj = projection_matrix(znear, zfar, fov_x, fov_y)
    full = (proj @ wv).astype(np.float32)
    cam_center = np.linalg.inv(wv)[:3, 3].astype(np.float32)
    return Camera(
        world_view=torch.from_numpy(wv).to(device),
        full_proj=torch.from_numpy(full).to(device),
        camera_center=torch.from_numpy(cam_center).to(device),
        image=None if image is None else torch.as_tensor(image).to(device),
        width=int(width),
        height=int(height),
        fov_x=float(fov_x),
        fov_y=float(fov_y),
        znear=float(znear),
        zfar=float(zfar),
        image_name=image_name,
    )


def make_camera_from_c2w(
    c2w: np.ndarray,
    fov_x: float,
    fov_y: float,
    width: int,
    height: int,
    **kw,
) -> Camera:
    """Camera from a 4x4 camera-to-world pose (viewer path)."""
    w2c = np.linalg.inv(np.asarray(c2w, dtype=np.float64))
    R = w2c[:3, :3].T  # reference convention: R stored transposed
    t = w2c[:3, 3]
    return make_camera(R, t, fov_x, fov_y, width, height, **kw)
