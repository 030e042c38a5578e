"""Port parity: the multi-device collectives and tile-band rendering.

The port's ranks are spawned gloo CPU processes (torch_dist_common); the
JAX side runs on `make_mesh(2)` of the conftest's 8 CPU devices. The
collectives against numpy; `render_sharded` against JAX's render_sharded
(render rtol 1e-4 / atol 1e-5, depth and final_T 1e-4, n_contrib, overflow
and radii exact), an empty band included; band gradients against the
port's single-device render (itself held against JAX in
test_torch_render.py) at 2e-3 of each leaf's largest.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_gaussians_tpu.parallel.mesh import make_mesh as jax_mesh
from semantic_gaussians_tpu.parallel.render_sharded import render_sharded as jax_render_sharded
from semantic_gaussians_tpu.utils.camera import make_camera as jax_camera
from semantic_gaussians_torch.core.gaussians import params_from_numpy
from semantic_gaussians_torch.ops.binning import band_pair_budget, default_pair_budget
from semantic_gaussians_torch.parallel import mesh as tmesh
from semantic_gaussians_torch.renderer import render as torch_render
from semantic_gaussians_torch.utils.camera import make_camera as torch_camera
from semantic_gaussians_tpu.ops.binning import band_pair_budget as jax_band_pair_budget
from torch_dist_common import run_ranks
from torch_parallel_ranks import collectives_rank, render_rank
from torch_port_common import jax_params, np_, scene_arrays

WORLD = 2


def cam_spec(w, h, image=None, t=(0.0, 0.0, 0.0)):
    return dict(R=np.eye(3), t=np.asarray(t), fov_x=1.4, fov_y=0.8, width=w, height=h,
                image=image)


def test_band_pair_budget_matches_jax():
    for cap in (256, 600, 4096, 102_400, 1_003_520):
        for nband in (1, 2, 3, 4, 8):
            assert band_pair_budget(cap, nband) == jax_band_pair_budget(cap, nband)
    assert band_pair_budget(102_400, 1) == 2 * default_pair_budget(102_400)


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_over_gloo(tmp_path, world):
    outs = run_ranks(collectives_rank, world, tmp_path)
    xs = [np.arange(4 * world, dtype=np.float32).reshape(2 * world, 2) + 100 * r
          for r in range(world)]
    total = sum(xs)
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["psum"], total)
        np.testing.assert_allclose(o["pmean"], total / world, rtol=1e-6)
        np.testing.assert_array_equal(o["pmax"], xs[-1])
        np.testing.assert_array_equal(o["scatter"], total[2 * r:2 * r + 2])
        np.testing.assert_array_equal(o["gather"], np.concatenate([x[:1] for x in xs]))
        np.testing.assert_array_equal(o["batch"], o["gather"])
        np.testing.assert_array_equal(o["many"][0], total)
        np.testing.assert_array_equal(o["many"][1], total[:, :1] * 2)
        np.testing.assert_array_equal(o["replicate"], xs[0])
        w = np.arange(2 * world, dtype=np.float32).reshape(world, 2)
        np.testing.assert_array_equal(o["gather_grad"], w[r:r + 1])
        np.testing.assert_array_equal(o["replicated_grad"],
                                      np.full(3, world * (world + 1) / 2, np.float32))
        x_bytes = 4 * world * 4
        assert o["comm"]["reduce_scatter"] == x_bytes
        assert o["comm"]["all_gather"] == 3 * (x_bytes // (2 * world))


def test_one_rank_mesh_without_process_group():
    """A process that no launcher started: a mesh of one rank whose
    collectives hand back their input; a larger mesh raises."""
    from semantic_gaussians_torch.parallel import collectives as col

    mesh = tmesh.make_mesh()
    assert mesh.shape == {"data": 1} and mesh.coord("data") == 0
    x = torch.arange(6.0).reshape(3, 2)
    for fn in (col.psum, col.pmax, col.psum_scatter, col.all_gather, col.gather_bands):
        assert torch.equal(fn(x, mesh, "data"), x)
    assert mesh.comm_bytes == {}
    with pytest.raises(ValueError, match="needs 2 ranks"):
        tmesh.make_mesh(2)


def _render_case(name):
    arrays, alive = scene_arrays(n=600, seed=31, dead=40)
    w, h = {"rgb": (128, 64), "empty_band": (128, 16), "features": (96, 48)}[name]
    override = None
    if name == "features":
        override = np.random.default_rng(32).normal(size=(600, 8)).astype(np.float32)
    bg = np.linspace(0.1, 0.3, 3 if override is None else 8).astype(np.float32)
    return arrays, alive, cam_spec(w, h), bg, override


@pytest.mark.parametrize("name", ["rgb", "empty_band", "features"])
def test_render_sharded_matches_jax(tmp_path, name):
    """Two bands (the empty_band image has one tile row, so the second band
    lies past it), RGB at SH degree 3 and 8 feature channels."""
    arrays, alive, spec, bg, override = _render_case(name)
    outs = run_ranks(render_rank, WORLD, tmp_path, arrays, alive, spec, bg, override)
    jcam = jax_camera(*(spec[k] for k in ("R", "t", "fov_x", "fov_y", "width", "height")))
    want = jax_render_sharded(
        jcam, jax_params(arrays), jnp.asarray(alive), jax_mesh(WORLD), jnp.asarray(bg),
        override_color=None if override is None else jnp.asarray(override),
    )
    assert int(want["overflow"]) == 0
    for got in outs:
        np.testing.assert_allclose(got["render"], np_(want["render"]), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got["depth"], np_(want["depth"]), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got["final_T"], np_(want["final_T"]), rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(got["n_contrib"], np_(want["n_contrib"]))
        np.testing.assert_array_equal(got["radii"], np_(want["radii"]))
        assert int(got["overflow"]) == 0
    # every rank holds the same image
    np.testing.assert_array_equal(outs[0]["render"], outs[1]["render"])
    assert (outs[0]["n_contrib"] > 0).mean() > 0.3


def test_band_gradients_sum_to_single_device(tmp_path):
    """The gradients of sum(render * weight) through two bands, every
    rank's, against the port's single-device render at 2e-3 of each leaf's
    largest (the JAX package's test_band_sharded_gradients_psum)."""
    arrays, alive = scene_arrays(n=400, seed=33)
    spec = cam_spec(96, 48)
    weight = np.random.default_rng(34).uniform(size=(48, 96, 3)).astype(np.float32)
    outs = run_ranks(render_rank, WORLD, tmp_path, arrays, alive, spec, np.zeros(3, np.float32),
                     None, weight)
    params = params_from_numpy(arrays, "cpu")
    leaves = {f: getattr(params, f).requires_grad_(True) for f in arrays}
    out = torch_render(torch_camera(**spec), dataclasses.replace(params, **leaves),
                       alive=torch.from_numpy(alive))
    grads = torch.autograd.grad((out["render"] * torch.from_numpy(weight)).sum(),
                                list(leaves.values()))
    for f, g in zip(leaves, grads):
        want = np_(g)
        scale = np.abs(want).max() + 1e-8
        for got in outs:
            np.testing.assert_allclose(got["grads"][f] / scale, want / scale, atol=2e-3,
                                       err_msg=f)
    np.testing.assert_array_equal(outs[0]["grads"]["means"], outs[1]["grads"]["means"])
