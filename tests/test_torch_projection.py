"""Port parity: project_gaussians vs the JAX package.

Floats at rtol 1e-5, atol 1e-6. `radii` and `radii_xy` are compared
exactly, with one named exception: they are ceil() of float32 values, and
the port's log/sqrt may differ from XLA's by an ulp, so a value within one
ulp of an integer may round up on one side only. Any other integer
difference fails.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from semantic_gaussians_tpu.ops.projection import project_gaussians as jax_project
from semantic_gaussians_tpu.utils.transforms import build_covariance_3d as jax_cov
from semantic_gaussians_tpu.utils.transforms import strip_symmetric as jax_strip
from semantic_gaussians_torch.ops.projection import project_gaussians as torch_project
from semantic_gaussians_torch.utils.transforms import build_covariance_3d as torch_cov
from semantic_gaussians_torch.utils.transforms import strip_symmetric as torch_strip
from torch_port_common import W, H, cameras, jax_params, np_, scene_arrays, torch_params

FLOAT_FIELDS = ("means2d", "depths", "conics", "opacities", "colors", "cull_ellipse")


def _assert_ceil_ints(j, t, pre_ceil, name):
    """Integer outputs equal, except a ceil flip of a value within 1 ulp
    of an integer (the exception named in the module doc)."""
    j, t = np_(j), np_(t)
    diff = j != t
    if not diff.any():
        return
    x = np.broadcast_to(pre_ceil, j.shape)[diff].astype(np.float32)
    near = np.abs(x - np.round(x)) <= np.spacing(np.abs(x))
    assert near.all() and (np.abs(j[diff] - t[diff]) == 1).all(), (
        f"{name}: {int(diff.sum())} entries differ beyond a 1-ulp ceil flip"
    )


def _project_both(case):
    arrays, alive = scene_arrays(n=500, seed=11, dead=60 if case == "dead" else 0)
    if case == "dead":
        arrays["means"][:15, 2] = -1.0  # behind the camera: near-culled
        arrays["means"][15:20] = 0.0  # on the camera centre
    jp, tp = jax_params(arrays), torch_params(arrays)
    jc, tc = cameras()
    common = dict(img_width=W, img_height=H)
    jkw, tkw = {}, {}
    if case == "override16":
        feats = np.random.default_rng(12).uniform(size=(500, 16)).astype(np.float32)
        jkw["override_color"] = jnp.asarray(feats)
        tkw["override_color"] = torch.from_numpy(feats)
    else:
        jkw.update(sh_coeffs=jp.sh_coeffs, sh_degree=3)
        tkw.update(sh_coeffs=tp.sh_coeffs, sh_degree=3)
    jmeans, tmeans = jp.means, tp.means
    if case == "world_rotate":
        q = np.array([0.9, 0.1, -0.3, 0.2], np.float32)
        q /= np.linalg.norm(q)
        w, x, y, z = q
        R = np.array(
            [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
             [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
             [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]],
            np.float32,
        )
        jR, tR = jnp.asarray(R), torch.from_numpy(R)
        jmeans, tmeans = jp.means @ jR, tp.means @ tR
        jkw["cov3d_precomp"] = jax_strip(jR.T @ jax_cov(jp.scales * 0.8, jp.quats) @ jR)
        tkw["cov3d_precomp"] = torch_strip(tR.T @ torch_cov(tp.scales * 0.8, tp.quats) @ tR)
    if case == "scaling_modifier":
        jkw["scaling_modifier"] = tkw["scaling_modifier"] = 0.6
    jproj = jax_project(
        jmeans, jp.scales, jp.quats, jp.opacity[:, 0], jc.world_view, jc.full_proj,
        jc.camera_center, tan_fov_x=jc.tan_half_fov_x, tan_fov_y=jc.tan_half_fov_y,
        alive=jnp.asarray(alive), **common, **jkw,
    )
    tproj = torch_project(
        tmeans, tp.scales, tp.quats, tp.opacity[:, 0], tc.world_view, tc.full_proj,
        tc.camera_center, tan_fov_x=tc.tan_half_fov_x, tan_fov_y=tc.tan_half_fov_y,
        alive=torch.from_numpy(alive), **common, **tkw,
    )
    return jproj, tproj, alive


@pytest.mark.parametrize("case", ["sh3", "override16", "world_rotate", "scaling_modifier", "dead"])
def test_project_matches_jax(case):
    jproj, tproj, alive = _project_both(case)
    for f in FLOAT_FIELDS:
        a, b = np_(getattr(jproj, f)), np_(getattr(tproj, f))
        assert a.shape == b.shape and b.dtype == np.float32, f
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6, err_msg=f)
    # pre-ceil values: 3 sigma_max for radii, r_mah * sigma_axis for radii_xy
    con = np_(tproj.conics).astype(np.float64)
    det = con[:, 0] * con[:, 2] - con[:, 1] ** 2
    a, b, c = con[:, 2] / det, -con[:, 1] / det, con[:, 0] / det  # 2D covariance
    mid = 0.5 * (a + c)
    sigma_max = np.sqrt(mid + np.sqrt(np.maximum(mid * mid - (a * c - b * b), 0.1)))
    r_mah = np.sqrt(2.0 * np.log(np.maximum(255.0 * np_(tproj.opacities), 1.0)))
    _assert_ceil_ints(jproj.radii, tproj.radii, 3.0 * sigma_max, "radii")
    _assert_ceil_ints(
        jproj.radii_xy, tproj.radii_xy,
        np.stack([r_mah * np.sqrt(a), r_mah * np.sqrt(c)], -1), "radii_xy",
    )
    assert tproj.radii.dtype == tproj.radii_xy.dtype == torch.int32
    if case == "dead":
        assert (np_(tproj.radii)[~alive] == 0).all()
        assert (np_(tproj.radii)[:15] == 0).all() and (np_(tproj.opacities)[:15] == 0).all()
        assert np.isfinite(np_(tproj.colors)).all()
    assert (np_(tproj.radii) > 0).sum() > 100  # the scene is on screen
