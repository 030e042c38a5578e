"""The slice as a whole: the port's render / render_chn vs the JAX package's
render(backend="pallas") on the same carried-across parameters.

render and final_T at rtol 1e-4, atol 1e-5; depth at 1e-4/1e-4 (as
tests/test_rasterize.py); n_contrib, radii, num_pairs and overflow exact.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from semantic_gaussians_tpu.renderer import render as jax_render
from semantic_gaussians_tpu.renderer import render_chn as jax_render_chn
from semantic_gaussians_torch.renderer import render as torch_render
from semantic_gaussians_torch.renderer import render_chn as torch_render_chn
from semantic_gaussians_torch.renderer import render_many
from torch_port_common import cameras, jax_params, np_, scene_arrays, torch_params

TOL = dict(render=(1e-4, 1e-5), final_T=(1e-4, 1e-5), depth=(1e-4, 1e-4))
EXACT = ("n_contrib", "radii", "num_pairs", "overflow")


@pytest.fixture(scope="module")
def scene():
    arrays, alive = scene_arrays(n=1200, seed=41, dead=100)
    return jax_params(arrays), torch_params(arrays), alive


def _compare(want, got):
    for k, (rtol, atol) in TOL.items():
        assert got[k].dtype == torch.float32, k
        np.testing.assert_allclose(np_(got[k]), np_(want[k]), rtol=rtol, atol=atol, err_msg=k)
    for k in EXACT:
        np.testing.assert_array_equal(np_(got[k]), np_(want[k]), err_msg=k)


@pytest.mark.parametrize("case", ["rgb", "foreground", "scaling_modifier", "override_shape", "chn16"])
def test_render_matches_jax(scene, case):
    jp, tp, alive = scene
    jc, tc = cameras()
    jkw, tkw = {}, {}
    if case == "foreground":
        fg = np.random.default_rng(42).uniform(size=alive.shape) < 0.6
        jkw["foreground"], tkw["foreground"] = jnp.asarray(fg), torch.from_numpy(fg)
    elif case == "scaling_modifier":
        jkw["scaling_modifier"] = tkw["scaling_modifier"] = 0.7
    elif case == "override_shape":
        jkw["override_shape"] = tkw["override_shape"] = (96, 48)
    bg = np.asarray([0.2, 0.1, 0.3], np.float32)
    if case == "chn16":
        feats = np.random.default_rng(43).normal(size=(alive.size, 16)).astype(np.float32)
        bg = np.linspace(0, 1, 16).astype(np.float32)
        want = jax_render_chn(jc, jp, jnp.asarray(feats), jnp.asarray(alive), jnp.asarray(bg))
        got = torch_render_chn(tc, tp, torch.from_numpy(feats), torch.from_numpy(alive),
                               torch.from_numpy(bg))
    else:
        want = jax_render(jc, jp, jnp.asarray(alive), jnp.asarray(bg), backend="pallas", **jkw)
        got = torch_render(tc, tp, torch.from_numpy(alive), torch.from_numpy(bg), **tkw)
    _compare(want, got)
    assert int(got["num_pairs"]) > 1000
    if case == "override_shape":
        assert got["render"].shape == (48, 96, 3)


def test_render_many_and_dense_backend(scene):
    _, tp, alive = scene
    _, tc = cameras()
    alive_t = torch.from_numpy(alive)
    outs = render_many([tc, tc.resized(64, 32)], tp, alive=alive_t)
    assert [o["render"].shape for o in outs] == [(64, 128, 3), (32, 64, 3)]
    tiled = torch_render(tc, tp, alive_t)
    dense = torch_render(tc, tp, alive_t, backend="dense")
    for k, (rtol, atol) in TOL.items():
        np.testing.assert_allclose(np_(tiled[k]), np_(dense[k]), rtol=rtol, atol=atol)
    np.testing.assert_array_equal(np_(tiled["n_contrib"]), np_(dense["n_contrib"]))
    # the tight cull is output-exact: the same contributors in the same
    # order (the colour sum's batch grouping shifts, hence the ulp slack)
    loose = torch_render(tc, tp, alive_t, tight_cull=False)
    assert int(loose["num_pairs"]) == int(tiled["num_pairs"])
    for k in ("final_T", "depth"):
        np.testing.assert_array_equal(np_(loose[k]), np_(tiled[k]))
    np.testing.assert_allclose(np_(loose["render"]), np_(tiled["render"]), rtol=1e-6, atol=1e-6)
