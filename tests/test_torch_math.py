"""Port parity: SH, rotation/covariance math and camera matrices vs JAX.

Float results at rtol 1e-6 (with atol 1e-6 for values that cross zero:
the SH contraction and the covariance products sum in another order).
"""
import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import semantic_gaussians_tpu.utils.sh as jsh
import semantic_gaussians_tpu.utils.transforms as jtr
import semantic_gaussians_torch.utils.sh as tsh
import semantic_gaussians_torch.utils.transforms as ttr
from semantic_gaussians_tpu.utils.camera import make_camera_from_c2w as jax_c2w
from semantic_gaussians_torch.utils.camera import make_camera_from_c2w as torch_c2w
from torch_port_common import cameras, np_

RTOL, ATOL = 1e-6, 1e-6


def _close(a, b):
    np.testing.assert_allclose(np_(a), np_(b), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_eval_sh(deg):
    rng = np.random.default_rng(deg)
    dirs = rng.normal(size=(257, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    sh = rng.normal(size=(257, 3, (deg + 1) ** 2)).astype(np.float32)
    _close(
        jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(dirs)),
        tsh.eval_sh(deg, torch.from_numpy(sh), torch.from_numpy(dirs)),
    )


def test_rgb_sh_roundtrip():
    rgb = np.random.default_rng(1).uniform(size=(100, 3)).astype(np.float32)
    _close(jsh.rgb_to_sh(jnp.asarray(rgb)), tsh.rgb_to_sh(torch.from_numpy(rgb)))
    _close(jsh.sh_to_rgb(jnp.asarray(rgb)), tsh.sh_to_rgb(torch.from_numpy(rgb)))


@pytest.mark.parametrize(
    "fn", ["normalize_quat", "quat_to_rotmat", "build_covariance_3d", "strip_symmetric",
           "inverse_sigmoid"],
)
def test_transforms(fn):
    rng = np.random.default_rng(2)
    q = rng.normal(size=(200, 4)).astype(np.float32)
    s = np.exp(rng.uniform(-4, 0, size=(200, 3))).astype(np.float32)
    m = rng.normal(size=(200, 3, 3)).astype(np.float32)
    p = rng.uniform(0.01, 0.99, size=(200, 1)).astype(np.float32)
    args = {
        "normalize_quat": (q,),
        "quat_to_rotmat": (q / np.linalg.norm(q, axis=-1, keepdims=True),),
        "build_covariance_3d": (s, q),
        "strip_symmetric": (m,),
        "inverse_sigmoid": (p,),
    }[fn]
    _close(
        getattr(jtr, fn)(*(jnp.asarray(a) for a in args)),
        getattr(ttr, fn)(*(torch.from_numpy(a) for a in args)),
    )


def test_camera_matrices():
    jc, tc = cameras(96, 64, 1.2, 0.9)
    for f in ("world_view", "full_proj", "camera_center"):
        np.testing.assert_array_equal(np_(getattr(jc, f)), np_(getattr(tc, f)))
        assert getattr(tc, f).dtype == torch.float32
    for f in ("tan_half_fov_x", "tan_half_fov_y", "focal_x", "focal_y", "width", "height"):
        assert getattr(jc, f) == getattr(tc, f)
    small_j, small_t = jc.resized(48, 32), tc.resized(48, 32)
    assert (small_t.width, small_t.height) == (small_j.width, small_j.height) == (48, 32)
    np.testing.assert_array_equal(np_(small_j.full_proj), np_(small_t.full_proj))


def test_camera_from_c2w():
    c, s = math.cos(0.3), math.sin(0.3)
    c2w = np.array([[c, 0, s, 0.5], [0, 1, 0, -0.2], [-s, 0, c, -3.0], [0, 0, 0, 1]])
    jc = jax_c2w(c2w, 1.1, 0.8, 64, 48)
    tc = torch_c2w(c2w, 1.1, 0.8, 64, 48)
    for f in ("world_view", "full_proj", "camera_center"):
        np.testing.assert_array_equal(np_(getattr(jc, f)), np_(getattr(tc, f)))
