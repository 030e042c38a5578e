"""Shared inputs for the port's parity tests (tests/test_torch_*.py).

Scenes are made with numpy from a seed and handed to both packages: the
JAX reference (semantic_gaussians_tpu, on the CPU, Pallas in interpret
mode) and the PyTorch port (semantic_gaussians_torch, plain versions on the
CPU).
"""
import json

import numpy as np
import jax.numpy as jnp
import torch

from semantic_gaussians_tpu.core.gaussians import GaussianParams as JaxParams
from semantic_gaussians_tpu.ops.projection import ProjectedGaussians as JaxProj
from semantic_gaussians_tpu.utils.camera import make_camera as jax_camera
from semantic_gaussians_torch.core.gaussians import params_from_numpy
from semantic_gaussians_torch.ops.projection import ProjectedGaussians as TorchProj
from semantic_gaussians_torch.utils.camera import make_camera as torch_camera

# The suite runs in several worker processes at once; one intra-op thread
# each keeps torch's plain versions from oversubscribing the cores.
torch.set_num_threads(1)

W, H = 128, 64
TILE = (16, 32)
FIELDS = ("means", "sh_dc", "sh_rest", "log_scales", "quats", "opacity_logits")
PROJ_FIELDS = (
    "means2d", "depths", "conics", "opacities", "colors", "radii", "radii_xy",
    "cull_ellipse",
)


def scene_arrays(n=600, seed=0, dead=0, sh_rest_scale=0.05):
    """GaussianParams fields (numpy) + alive mask: a cloud 4 units in front
    of the camera with multi-tile splats; the last `dead` rows are dead."""
    rng = np.random.default_rng(seed)
    arrays = dict(
        means=(rng.normal(size=(n, 3)) * [1.2, 0.45, 0.8] + [0, 0, 4]).astype(np.float32),
        sh_dc=rng.normal(size=(n, 1, 3)).astype(np.float32),
        sh_rest=(rng.normal(size=(n, 15, 3)) * sh_rest_scale).astype(np.float32),
        log_scales=rng.uniform(-3.4, -1.6, size=(n, 3)).astype(np.float32),
        quats=rng.normal(size=(n, 4)).astype(np.float32),
        opacity_logits=rng.uniform(-2.0, 3.0, size=(n, 1)).astype(np.float32),
    )
    alive = np.ones(n, bool)
    if dead:
        alive[-dead:] = False
    return arrays, alive


def jax_params(arrays):
    return JaxParams(**{k: jnp.asarray(arrays[k]) for k in FIELDS})


def torch_params(arrays):
    return params_from_numpy(arrays, "cpu")


def cameras(w=W, h=H, fov_x=1.4, fov_y=0.8):
    args = (np.eye(3), np.zeros(3), fov_x, fov_y, w, h)
    return jax_camera(*args), torch_camera(*args)


def jax_to_torch_proj(proj):
    return TorchProj(**{
        f: None if getattr(proj, f) is None else torch.from_numpy(np.array(getattr(proj, f)))
        for f in PROJ_FIELDS
    })


def torch_to_jax_proj(proj):
    return JaxProj(**{
        f: None if getattr(proj, f) is None else jnp.asarray(getattr(proj, f).numpy())
        for f in PROJ_FIELDS
    })


def np_(x):
    """numpy view of a JAX array or a torch tensor."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def write_toy_blender_scene(root, views=6, w=64, h=48, seed=25):
    """A Blender-layout scene on disk: `views` cameras on an arc looking at
    the cloud of `scene_arrays` (centred 4 units down +z), with random
    images (fusion and evaluation read only their size and name)."""
    from semantic_gaussians_torch.cli.view_server import encode_png

    rng = np.random.default_rng(seed)
    (root / "train").mkdir(parents=True)
    frames = []
    for i in range(views):
        ang = 0.25 * (i - views / 2) * 6 / views
        pos = np.array([4 * np.sin(ang), 0.2 * (-1) ** i, 4 - 4 * np.cos(ang)])
        fwd = np.array([0.0, 0.0, 4.0]) - pos
        fwd /= np.linalg.norm(fwd)
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        c2w = np.eye(4)
        c2w[:3, :3] = np.stack([right, -down, -fwd], axis=1)  # OpenGL axes
        c2w[:3, 3] = pos
        img = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        (root / "train" / f"r_{i}.png").write_bytes(encode_png(img))
        frames.append({"file_path": f"./train/r_{i}", "transform_matrix": c2w.tolist()})
    (root / "transforms_train.json").write_text(
        json.dumps({"camera_angle_x": 1.0, "frames": frames}))
