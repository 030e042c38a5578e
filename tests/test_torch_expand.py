"""Port parity: pair expansion, bit for bit, against both JAX paths.

* the port's plain expand vs the JAX Pallas kernel (`expand_pairs`,
  interpret mode) on identical inputs, with the cull on and off and with an
  overflowing budget;
* the port's binning vs the JAX XLA fallback, reached by a budget that is
  not a multiple of 512 (binning.py's kernel gate);
* an independent check of the cull: every culled pair's splat has
  alpha < 1/255 at all 512 pixel centres of its tile (float64).
The CUDA kernel is held against the same plain version by chip_smoke.py.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from semantic_gaussians_tpu.ops.binning import bin_gaussians as jax_bin
from semantic_gaussians_tpu.ops.expand import expand_pairs as jax_expand
from semantic_gaussians_tpu.ops.projection import project_gaussians as jax_project
from semantic_gaussians_torch.ops.binning import bin_gaussians as torch_bin
from semantic_gaussians_torch.ops.binning import depth_sorted_rects
from semantic_gaussians_torch.ops.expand import expand_pairs, expand_pairs_plain
from torch_port_common import W, H, TILE, cameras, jax_params, jax_to_torch_proj, np_, scene_arrays

GRID = (-(-H // TILE[0]), -(-W // TILE[1]))


def _case(seed, n, budget, max_count=8, with_cull=False):
    """Synthetic expand inputs (the JAX package's tests/test_expand.py law):
    emitting Gaussians first, random rects, means inside their rects."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, max_count, n).astype(np.int32)
    counts = counts[np.argsort(counts == 0, kind="stable")]
    offsets = np.minimum(np.concatenate([[0], np.cumsum(counts)[:-1]]), budget + 1).astype(np.int32)
    x0 = rng.integers(0, 20, n).astype(np.int32)
    y0 = rng.integers(0, 12, n).astype(np.int32)
    w = rng.integers(1, 5, n).astype(np.int32)
    cull = None
    if with_cull:
        mx = (x0 * 32 + rng.uniform(0, 4 * 32, n)).astype(np.float32)
        my = (y0 * 16 + rng.uniform(0, 2 * 16, n)).astype(np.float32)
        e0 = rng.uniform(1e-4, 3e-3, n).astype(np.float32)
        e2 = rng.uniform(1e-4, 3e-3, n).astype(np.float32)
        e1 = (rng.uniform(-0.9, 0.9, n) * np.sqrt(e0 * e2)).astype(np.float32)
        cull = np.stack([mx, my, e0, e1, e2])
    return dict(
        offsets=offsets, rect=(x0 << 16) | (y0 << 8) | w,
        idx=rng.permutation(n).astype(np.int32), cull=cull,
        num_pairs=np.int32(min(int(counts.sum()), budget)),
        num_dense=np.int32(int((counts > 0).sum())),
    )


@pytest.mark.parametrize(
    "with_cull,budget", [(False, 2048), (True, 2048), (True, 1024)],
    ids=["nocull", "cull", "cull-overflow"],
)
def test_plain_expand_matches_jax_kernel(with_cull, budget):
    n = 1000
    c = _case(0, n, budget, with_cull=with_cull)
    assert with_cull is False or budget != 1024 or c["num_pairs"] == budget  # overflows
    kw = dict(pair_budget=budget, ntx=32, num_tiles=512, n=n, tile_w=32, tile_h=16)
    want = jax_expand(
        jnp.asarray(c["offsets"]), jnp.asarray(c["rect"]), jnp.asarray(c["idx"]),
        None if c["cull"] is None else jnp.asarray(c["cull"]),
        jnp.int32(c["num_pairs"]), jnp.int32(c["num_dense"]), interpret=True, **kw,
    )
    got = expand_pairs(
        torch.from_numpy(c["offsets"]), torch.from_numpy(c["rect"]), torch.from_numpy(c["idx"]),
        None if c["cull"] is None else torch.from_numpy(c["cull"]),
        torch.tensor(c["num_pairs"]), torch.tensor(c["num_dense"]), **kw,
    )
    for a, b, name in zip(want, got, ("tile", "g_key", "gen_owner")):
        assert b.dtype == torch.int32, name
        np.testing.assert_array_equal(np_(a), np_(b), err_msg=name)
    if with_cull:
        culled = (np_(got[0]) == 512)[: int(c["num_pairs"])].sum()
        assert culled > 0, "expected some tight-culled pairs"


def _projected(seed=3):
    arrays, alive = scene_arrays(n=700, seed=seed)
    arrays["log_scales"] += 0.4  # wide splats: multi-tile rects with cullable corners
    jp = jax_params(arrays)
    jc, _ = cameras()
    return jax_project(
        jp.means, jp.scales, jp.quats, jp.opacity[:, 0], jc.world_view, jc.full_proj,
        jc.camera_center, W, H, jc.tan_half_fov_x, jc.tan_half_fov_y,
        sh_coeffs=jp.sh_coeffs, sh_degree=3, alive=jnp.asarray(alive),
    )


@pytest.mark.parametrize("cull", [False, True], ids=["nocull", "cull"])
def test_binning_matches_jax_xla_fallback(cull):
    jproj = _projected()
    tproj = jax_to_torch_proj(jproj)
    budget = 5000  # not a multiple of 512: the JAX package takes its XLA path
    jb = jax_bin(jproj.means2d, jproj.depths, jproj.radii_xy, TILE, GRID, budget,
                 cull_ellipse=jproj.cull_ellipse if cull else None)
    tb = torch_bin(tproj.means2d, tproj.depths, tproj.radii_xy, TILE, GRID, budget,
                   cull_ellipse=tproj.cull_ellipse if cull else None)
    for f in ("pair_gaussian", "pair_tile", "tile_start", "tile_count", "num_pairs",
              "overflow", "gen_of_tile_pos", "gen_owner", "orig_to_dense", "gen_live"):
        np.testing.assert_array_equal(np_(getattr(jb, f)), np_(getattr(tb, f)), err_msg=f)
    assert int(tb.num_pairs) > 1000


def test_culled_pairs_fail_alpha_everywhere():
    """Independent of tile_min_qn: brute-force alpha over each culled tile."""
    tproj = jax_to_torch_proj(_projected(seed=5))
    n = tproj.means2d.shape[0]
    budget = 8192
    ex = depth_sorted_rects(tproj.means2d, tproj.depths, tproj.radii_xy, TILE, GRID,
                            budget, tproj.cull_ellipse)
    args = (ex.offsets, ex.rect_packed_d, ex.idx_d)
    tail = (ex.num_pairs, ex.num_dense, budget, GRID[1], GRID[0] * GRID[1], n, TILE[1], TILE[0])
    tile_cull, _, owner = expand_pairs_plain(*args, ex.cull_d, *tail)
    tile_all, _, _ = expand_pairs_plain(*args, None, *tail)
    valid = np.arange(budget) < int(ex.num_pairs)
    culled = valid & (np_(tile_cull) == GRID[0] * GRID[1])
    assert culled.sum() > 20, "expected tight-culled pairs in this scene"
    gid = np_(ex.idx_d)[np_(owner)[culled]]
    tiles = np_(tile_all)[culled]
    m = np_(tproj.means2d).astype(np.float64)[gid]
    con = np_(tproj.conics).astype(np.float64)[gid]
    op = np_(tproj.opacities).astype(np.float64)[gid]
    ty, tx = np.divmod(tiles, GRID[1])
    py, px = np.mgrid[0:TILE[0], 0:TILE[1]].reshape(2, 1, -1).astype(np.float64)
    dx = m[:, :1] - (tx[:, None] * TILE[1] + px)
    dy = m[:, 1:] - (ty[:, None] * TILE[0] + py)
    power = -0.5 * (con[:, :1] * dx * dx + con[:, 2:] * dy * dy) - con[:, 1:2] * dx * dy
    alpha = op[:, None] * np.exp(np.minimum(power, 0.0))
    assert alpha.max() < 1.0 / 255.0
