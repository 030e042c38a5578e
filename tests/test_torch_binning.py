"""Port parity: every TileBinning field bit-identical to the JAX package's
(Pallas expand kernel path, interpret mode), given identical projected
inputs, with the exact tile-ellipse cull on and off."""
import numpy as np
import jax.numpy as jnp
import pytest

from semantic_gaussians_tpu.ops.binning import bin_gaussians as jax_bin
from semantic_gaussians_tpu.ops.projection import project_gaussians as jax_project
from semantic_gaussians_torch.ops.binning import bin_gaussians as torch_bin
from semantic_gaussians_torch.ops.binning import default_pair_budget, tile_rects
from torch_port_common import TILE, cameras, jax_params, jax_to_torch_proj, np_, scene_arrays

W, H = 256, 128
GRID = (-(-H // TILE[0]), -(-W // TILE[1]))
FIELDS = ("pair_gaussian", "pair_tile", "tile_start", "tile_count", "num_pairs",
          "overflow", "gen_of_tile_pos", "gen_owner", "orig_to_dense", "gen_live")


@pytest.fixture(scope="module")
def projected():
    arrays, alive = scene_arrays(n=900, seed=21, dead=50)
    jp = jax_params(arrays)
    jc, _ = cameras(W, H, 1.4, 0.8)
    jproj = jax_project(
        jp.means, jp.scales, jp.quats, jp.opacity[:, 0], jc.world_view, jc.full_proj,
        jc.camera_center, W, H, jc.tan_half_fov_x, jc.tan_half_fov_y,
        sh_coeffs=jp.sh_coeffs, sh_degree=3, alive=jnp.asarray(alive),
    )
    return jproj, jax_to_torch_proj(jproj)


@pytest.mark.parametrize("cull", [False, True], ids=["nocull", "cull"])
def test_bin_gaussians_matches_jax(projected, cull):
    jproj, tproj = projected
    budget = default_pair_budget(900)
    assert budget % 512 == 0  # the JAX package runs its Pallas expand kernel
    jb = jax_bin(jproj.means2d, jproj.depths, jproj.radii_xy, TILE, GRID, budget,
                 cull_ellipse=jproj.cull_ellipse if cull else None)
    tb = torch_bin(tproj.means2d, tproj.depths, tproj.radii_xy, TILE, GRID, budget,
                   cull_ellipse=tproj.cull_ellipse if cull else None)
    for f in FIELDS:
        a, b = np_(getattr(jb, f)), np_(getattr(tb, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert int(tb.num_pairs) > 2000 and int(tb.overflow) == 0
    if cull:
        assert int(tb.tile_count.sum()) < int(tb.num_pairs)  # the cull fired


def test_tile_rects_match_jax(projected):
    from semantic_gaussians_tpu.ops.binning import tile_rects as jax_rects

    jproj, tproj = projected
    for a, b in zip(jax_rects(jproj.means2d, jproj.radii_xy, TILE, GRID),
                    tile_rects(tproj.means2d, tproj.radii_xy, TILE, GRID)):
        np.testing.assert_array_equal(np_(a), np_(b))


def test_overflow_counts_match_jax(projected):
    jproj, tproj = projected
    budget = 1024
    jb = jax_bin(jproj.means2d, jproj.depths, jproj.radii_xy, TILE, GRID, budget,
                 cull_ellipse=jproj.cull_ellipse)
    tb = torch_bin(tproj.means2d, tproj.depths, tproj.radii_xy, TILE, GRID, budget,
                   cull_ellipse=tproj.cull_ellipse)
    assert int(tb.overflow) > 0
    for f in FIELDS:
        np.testing.assert_array_equal(np_(getattr(jb, f)), np_(getattr(tb, f)), err_msg=f)
