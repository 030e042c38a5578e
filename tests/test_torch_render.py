"""The slice as a whole: the port's render / render_chn vs the JAX package's
render(backend="pallas") on the same carried-across parameters.

render and final_T at rtol 1e-4, atol 1e-5; depth at 1e-4/1e-4 (as
tests/test_rasterize.py); n_contrib, radii, num_pairs and overflow exact.
Gradients (autograd vs jax.grad) at atol 1e-4 x each leaf's largest value.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from semantic_gaussians_tpu.renderer import render as jax_render
from semantic_gaussians_tpu.renderer import render_chn as jax_render_chn
from semantic_gaussians_torch.renderer import render as torch_render
from semantic_gaussians_torch.renderer import render_chn as torch_render_chn
from semantic_gaussians_torch.renderer import render_many
from torch_port_common import FIELDS, cameras, jax_params, np_, scene_arrays, torch_params

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


def _grad_case(scene, num_ch):
    """Gradients of sum(render * weights) w.r.t. every GaussianParams leaf
    and mean2d_offset (RGB), or the features (render_chn), from both
    packages on the same scene, camera, weights and background."""
    jp, tp, alive = scene
    jc, tc = cameras()
    rng = np.random.default_rng(45 + num_ch)
    wimg = rng.uniform(size=(tc.height, tc.width, num_ch)).astype(np.float32)
    bg = np.linspace(0.2, 0.4, num_ch).astype(np.float32)
    n = alive.size
    alive_j, alive_t = jnp.asarray(alive), torch.from_numpy(alive)
    if num_ch == 3:
        def jloss(p, off):
            out = jax_render(jc, p, alive_j, jnp.asarray(bg), backend="pallas",
                             mean2d_offset=off)
            return jnp.sum(out["render"] * wimg)

        want = jax.grad(jloss, argnums=(0, 1))(jp, jnp.zeros((n, 2), jnp.float32))
        want = {**{k: getattr(want[0], k) for k in FIELDS}, "mean2d_offset": want[1]}
        leaves = {k: getattr(tp, k).clone().requires_grad_(True) for k in FIELDS}
        off = torch.zeros((n, 2), requires_grad=True)
        out = torch_render(tc, type(tp)(**leaves), alive_t, torch.from_numpy(bg),
                           mean2d_offset=off)
        (out["render"] * torch.from_numpy(wimg)).sum().backward()
        got = {**{k: leaves[k].grad for k in FIELDS}, "mean2d_offset": off.grad}
    else:
        feats = rng.normal(size=(n, num_ch)).astype(np.float32)

        def jloss(f):
            out = jax_render_chn(jc, jp, f, alive_j, jnp.asarray(bg))
            return jnp.sum(out["render"] * wimg)

        want = {"features": jax.grad(jloss)(jnp.asarray(feats))}
        f = torch.from_numpy(feats).requires_grad_(True)
        out = torch_render_chn(tc, tp, f, alive_t, torch.from_numpy(bg))
        (out["render"] * torch.from_numpy(wimg)).sum().backward()
        got = {"features": f.grad}
    return want, got, alive


@pytest.mark.parametrize("num_ch", [3, 64])
def test_render_gradients_match_jax(scene, num_ch):
    """torch.autograd through the port's render vs jax.grad through the JAX
    render(backend="pallas"), with dead padded Gaussians and the tight cull
    on: every gradient at atol 1e-4 x its leaf's largest |value| (both walk
    the same pairs; the pixel sums differ in order), finite, and exactly
    zero on dead slots."""
    want, got, alive = _grad_case(scene, num_ch)
    for k, w in want.items():
        g = np_(got[k])
        assert np.isfinite(g).all(), k
        assert not np.any(g[~alive]), f"{k}: non-zero gradient on a dead slot"
        w = np_(w)
        scale = np.abs(w).max() + 1e-12
        assert scale > 1e-8, k
        np.testing.assert_allclose(g / scale, w / scale, rtol=0, atol=1e-4, err_msg=k)
