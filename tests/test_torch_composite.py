"""Port parity: forward compositing.

* the port's plain forward composite vs the JAX Pallas kernel
  (`composite_pairs`, interpret mode) on the same projected Gaussians and
  the same binning, at C = 3 and C = 64;
* the port's plain backward (per-pair gradient rows) vs `jax.vjp` of
  `composite_pairs`, at C = 3 and C = 64, at atol 1e-4 x each column's
  largest value;
* the port's dense oracle vs the JAX `rasterize_dense`;
* the plain version's work counts (what chip_smoke.py's bound is computed
  from) vs a per-pixel walk;
* `pack_geometry`'s table and its gradients vs the same columns joined by
  torch.cat.
Tolerances are tests/test_rasterize.py's: render and final_T at rtol 1e-4,
atol 1e-5; depth at 1e-4/1e-4; n_contrib exact. The CUDA kernel is held
against the same plain version by chip_smoke.py.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from semantic_gaussians_tpu.ops.binning import bin_gaussians as jax_bin
from semantic_gaussians_tpu.ops.composite_pallas import CompositeConfig, composite_pairs
from semantic_gaussians_tpu.ops.composite_ref import rasterize_dense as jax_dense
from semantic_gaussians_tpu.ops.projection import project_gaussians as jax_project
from semantic_gaussians_tpu.ops.rasterize import _pack_pair_cols
from semantic_gaussians_torch.ops.binning import default_pair_budget
from semantic_gaussians_torch.ops.composite import (
    composite_backward_plain, composite_forward, composite_forward_plain, pack_geometry,
)
from semantic_gaussians_torch.ops.composite_ref import rasterize_dense as torch_dense
from torch_port_common import (
    W, H, TILE, cameras, jax_params, jax_to_torch_proj, np_, scene_arrays,
)

GRID = (-(-H // TILE[0]), -(-W // TILE[1]))
TOL = dict(render=(1e-4, 1e-5), final_T=(1e-4, 1e-5), depth=(1e-4, 1e-4))


def _projected(num_ch):
    arrays, alive = scene_arrays(n=800, seed=31, dead=40)
    jp = jax_params(arrays)
    jc, _ = cameras()
    colors = dict(sh_coeffs=jp.sh_coeffs, sh_degree=3)
    if num_ch != 3:
        feats = np.random.default_rng(32).uniform(size=(800, num_ch)).astype(np.float32)
        colors = dict(override_color=jnp.asarray(feats))
    return jax_project(
        jp.means, jp.scales, jp.quats, jp.opacity[:, 0], jc.world_view, jc.full_proj,
        jc.camera_center, W, H, jc.tan_half_fov_x, jc.tan_half_fov_y,
        alive=jnp.asarray(alive), **colors,
    )


def _assert_outputs(want, got):
    for k, (rtol, atol) in TOL.items():
        np.testing.assert_allclose(np_(got[k]), np_(want[k]), rtol=rtol, atol=atol, err_msg=k)
    np.testing.assert_array_equal(np_(got["n_contrib"]), np_(want["n_contrib"]))


@pytest.mark.parametrize("num_ch", [3, 64])
def test_plain_composite_matches_jax_kernel(num_ch):
    jproj = _projected(num_ch)
    tproj = jax_to_torch_proj(jproj)
    bg = np.linspace(0.1, 0.4, num_ch).astype(np.float32)
    budget = default_pair_budget(800)
    binning = jax_bin(jproj.means2d, jproj.depths, jproj.radii_xy, TILE, GRID, budget,
                      cull_ellipse=jproj.cull_ellipse)
    cfg = CompositeConfig(tile_h=TILE[0], tile_w=TILE[1], grid_h=GRID[0], grid_w=GRID[1],
                          num_channels=num_ch, interpret=True)
    want = composite_pairs(cfg, _pack_pair_cols(jproj, binning, cfg), jnp.asarray(bg),
                           binning.tile_start, binning.tile_count)
    got = composite_forward(
        pack_geometry(tproj.means2d, tproj.conics, tproj.opacities, tproj.depths),
        tproj.colors.contiguous(), torch.tensor(np_(binning.pair_gaussian)),
        torch.tensor(np_(binning.tile_start)), torch.tensor(np_(binning.tile_count)),
        torch.from_numpy(bg), GRID[1], TILE[0], TILE[1],
    )
    names = ("render", "depth", "final_T", "n_contrib")
    assert got[0].shape == (GRID[0] * GRID[1], num_ch, TILE[0] * TILE[1])
    assert got[3].dtype == torch.int32
    _assert_outputs(dict(zip(names, want)), dict(zip(names, got)))
    assert (np_(got[2]) < 0.5).sum() > 500  # dense coverage
    assert int(np_(got[3]).max()) > 10


def test_plain_composite_work_counts():
    """`work` counts, per (pixel, pair), the alphas evaluated before a pixel
    stops and the colours accumulated: checked against a per-pixel walk,
    with overlap dense enough that most pixels terminate. Asking for the
    counts leaves the outputs as they were."""
    rng = np.random.default_rng(5)
    n, grid_w, per_tile = 40, 2, 30
    geom = pack_geometry(
        torch.tensor(rng.uniform(0, 64, (n, 2)), dtype=torch.float32),
        torch.tensor(np.stack([rng.uniform(1e-3, 1e-2, n), rng.uniform(-1e-3, 1e-3, n),
                               rng.uniform(1e-3, 1e-2, n)], 1), dtype=torch.float32),
        torch.tensor(rng.uniform(0.6, 0.99, n), dtype=torch.float32),
        torch.tensor(rng.uniform(1, 5, n), dtype=torch.float32),
    )
    ids = np.concatenate([rng.choice(n, per_tile, replace=False) for _ in range(grid_w)])
    args = (geom, torch.rand((n, 3), generator=torch.Generator().manual_seed(5)),
            torch.tensor(ids, dtype=torch.int32),
            torch.arange(0, grid_w * per_tile, per_tile, dtype=torch.int32),
            torch.full((grid_w,), per_tile, dtype=torch.int32), torch.zeros(3),
            grid_w, TILE[0], TILE[1])
    work = {}
    got = composite_forward_plain(*args, work=work)
    for a, b in zip(got, composite_forward_plain(*args)):
        assert torch.equal(a, b)

    g = geom.numpy()
    evaluated = contributed = 0
    for t in range(grid_w):
        for p in range(TILE[0] * TILE[1]):
            x, y = t * TILE[1] + p % TILE[1], p // TILE[1]
            T = np.float32(1.0)
            for gid in ids[t * per_tile:(t + 1) * per_tile]:
                r = g[gid]
                evaluated += 1
                dx, dy = r[0] - x, r[1] - y
                power = -0.5 * (r[2] * dx * dx + r[4] * dy * dy) - r[3] * dx * dy
                alpha = min(0.99, r[5] * np.exp(min(power, 0.0)))
                if power > 0 or alpha < 1 / 255:
                    continue
                if T * (1 - alpha) < 1e-4:
                    break
                contributed += 1
                T = T * np.float32(1 - alpha)
    assert work == dict(evaluated=evaluated, contributed=contributed)
    assert evaluated < grid_w * per_tile * TILE[0] * TILE[1]  # some pixels stop early


def test_dense_oracle_matches_jax():
    jproj = _projected(3)
    bg = np.asarray([0.1, 0.2, 0.3], np.float32)
    want = jax_dense(jproj, W, H, jnp.asarray(bg), TILE)
    got = torch_dense(jax_to_torch_proj(jproj), W, H, torch.from_numpy(bg), TILE)
    _assert_outputs(want, got)


@pytest.mark.parametrize("num_ch", [3, 64])
def test_plain_backward_matches_jax_vjp(num_ch):
    """Per-pair gradient rows of the port's plain backward vs `jax.vjp` of
    `composite_pairs` (interpret mode) on identical pair buffers, and d_bg.
    Every row in a tile range is compared, at atol 1e-4 x the column's
    largest |value| (the two sum the pixels in different orders)."""
    jproj = _projected(num_ch)
    tproj = jax_to_torch_proj(jproj)
    bg = np.linspace(0.1, 0.4, num_ch).astype(np.float32)
    binning = jax_bin(jproj.means2d, jproj.depths, jproj.radii_xy, TILE, GRID,
                      default_pair_budget(800), cull_ellipse=jproj.cull_ellipse)
    cfg = CompositeConfig(tile_h=TILE[0], tile_w=TILE[1], grid_h=GRID[0], grid_w=GRID[1],
                          num_channels=num_ch, interpret=True)
    nt, px = GRID[0] * GRID[1], TILE[0] * TILE[1]
    gcol = np.random.default_rng(7).normal(size=(nt, num_ch, px)).astype(np.float32)
    _, vjp = jax.vjp(
        lambda pd, b: composite_pairs(cfg, pd, b, binning.tile_start, binning.tile_count)[0],
        _pack_pair_cols(jproj, binning, cfg), jnp.asarray(bg),
    )
    want_pairs, want_bg = vjp(jnp.asarray(gcol))
    in_pairs = int(np_(binning.tile_count).sum())
    want = np_(want_pairs)[:6 + num_ch, :in_pairs].T  # [pairs, 6 + C]

    args = (
        pack_geometry(tproj.means2d, tproj.conics, tproj.opacities, tproj.depths),
        tproj.colors.contiguous(), torch.tensor(np_(binning.pair_gaussian)),
        torch.tensor(np_(binning.tile_start)), torch.tensor(np_(binning.tile_count)),
        torch.from_numpy(bg),
    )
    _, _, final_t, n_contrib = composite_forward(*args, GRID[1], TILE[0], TILE[1])
    work = {}
    got = composite_backward_plain(*args, torch.from_numpy(gcol), final_t, n_contrib,
                                   GRID[1], TILE[0], TILE[1], work=work)
    assert got.shape == (np_(binning.pair_gaussian).shape[0], 6 + num_ch)
    got = np_(got)[:in_pairs]
    scale = np.abs(want).max(axis=0) + 1e-12
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-4)
    assert np.abs(want[:, :6]).max() > 0 and work["contributed"] > 1000
    assert work["evaluated"] == int(n_contrib.sum())
    got_bg = torch.einsum("tp,tcp->c", final_t, torch.from_numpy(gcol))
    np.testing.assert_allclose(np_(got_bg), np_(want_bg), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pack_geometry_is_the_joined_columns(dtype):
    gen = torch.Generator().manual_seed(3)
    n = 37
    ins = [torch.randn(shape, generator=gen, dtype=dtype).requires_grad_(True)
           for shape in ((n, 2), (n, 3), (n,), (n,))]
    geom = pack_geometry(*ins)
    joined = torch.cat([ins[0], ins[1], ins[2][:, None], ins[3][:, None],
                        torch.zeros((n, 1), dtype=dtype)], dim=-1).float()
    assert geom.dtype == torch.float32 and geom.is_contiguous()
    assert torch.equal(geom, joined)
    g = torch.randn((n, 8), generator=gen)
    got = torch.autograd.grad(geom, ins, g)
    want = torch.autograd.grad(joined, ins, g)
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.equal(a, b)
