"""Port parity: the bench tools (semantic_gaussians_torch/tools/bench*.py,
common.py) against the root tools and the JAX package, on the CPU at small
sizes.

Bit for bit: `random_cloud_params`, bench.py's scene law (at a size with a
density shift), `room_voxels` and every input the tools draw from a seed.
Exact: pair counts, binnings, pair gathers at invalid slots, n_contrib and
the eval confusion matrices. Within a tolerance (as tests/test_torch_render.py
and tests/test_torch_composite.py): renders rtol 1e-4 / atol 1e-5 (depth
1e-4 / 1e-4), projected values rtol 1e-5 / atol 1e-6, gradients and the
bench chains' outputs atol 1e-4 x each leaf's (or column's) largest |value|;
the distill step's first loss within 1e-5; SAM's embedding and IoU at
test_torch_sam.py's 2e-4 / 2e-5, its masks equal wherever the logit is
further than 2e-4 x the largest |logit| from the threshold; band gradients
against the JAX render's at the gradient tolerance on one rank and at 2e-3
of each leaf's largest on two, as tests/test_torch_parallel_render.py
holds band gradients.
"""
import dataclasses
import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_port_common  # noqa: F401  (one torch thread per worker)
from semantic_gaussians_tpu.core.gaussians import GaussianParams as JaxParams
from semantic_gaussians_tpu.models import automask as jam
from semantic_gaussians_tpu.models import sam as jsam
from semantic_gaussians_tpu.ops.binning import bin_gaussians as jax_bin
from semantic_gaussians_tpu.ops.composite_pallas import CompositeConfig, composite_pairs
from semantic_gaussians_tpu.ops.projection import project_gaussians as jax_project
from semantic_gaussians_tpu.ops.rasterize import DEFAULT_TILE, _pack_pair_cols
from semantic_gaussians_tpu.pipelines import distill as jd
from semantic_gaussians_tpu.pipelines.eval_segmentation import eval_views as jax_eval_views
from semantic_gaussians_tpu.pipelines.train import tuned_pair_budget as jax_tuned_budget
from semantic_gaussians_tpu.renderer import render as jax_render
from semantic_gaussians_tpu.utils.camera import make_camera as jax_camera
from semantic_gaussians_torch.core.gaussians import FIELDS
from semantic_gaussians_torch.models.automask import masks_to_boxes
from semantic_gaussians_torch.models.unet3d import unet_state_to_flax
from semantic_gaussians_torch.pipelines import distill as td
from semantic_gaussians_torch.renderer import render as torch_render
from semantic_gaussians_torch.tools import (
    bench, bench_amg, bench_components, bench_distill, bench_eval, bench_scaling, common,
)
from torch_dist_common import run_ranks
from torch_parallel_ranks import band_grads_rank

REPO = pathlib.Path(__file__).resolve().parent.parent
TOL = dict(render=(1e-4, 1e-5), final_T=(1e-4, 1e-5), depth=(1e-4, 1e-4))
CHAIN_N, CHAIN_W, CHAIN_H = 3000, 96, 72


def _root_tool(name):
    """A root tools/ script as a module (they import JAX only in main())."""
    spec = importlib.util.spec_from_file_location(f"root_tools_{name}",
                                                  REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jax_params(params):
    return JaxParams(**{f: jnp.asarray(_np(getattr(params, f))) for f in FIELDS})


def _close_by_max(got, want, what, atol=1e-4, axis=None):
    """|got - want| <= atol x the largest |want| (per column with axis=0)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    if not want.size:
        return
    scale = np.abs(want).max(axis=axis) + 1e-30
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=atol, err_msg=what)


def _jax_mse_grad(cam, alive, target, budget):
    def loss(p):
        out = jax_render(cam, p, alive=alive, pair_budget=budget)
        return jnp.mean((out["render"] - target) ** 2)

    return jax.jit(jax.grad(loss))


# ---------------------------------------------------------------- scenes


@pytest.mark.parametrize("kw", [dict(n=500), dict(n=700, seed=3, sh_rest_k=2, spread=(1, 2, 3),
                                                   center=(0, 1, 5), log_scale_range=(-5, -1))])
def test_random_cloud_params_is_root_tools(kw):
    jparams, jalive, jrng = _root_tool("common").random_cloud_params(**kw)
    params, alive, rng = common.random_cloud_params(**kw)
    for f in FIELDS:
        a, b = _np(getattr(params, f)), np.asarray(getattr(jparams, f))
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), f
    assert bool(alive.all()) and bool(np.asarray(jalive).all())
    assert rng.bit_generator.state == jrng.bit_generator.state


def test_bench_scene_is_bench_law_with_density_shift():
    """bench.py:128-160 at 150,000 Gaussians (density_shift < 0), and its
    target: every array bit for bit."""
    n, w, h = 150_000, 64, 48
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(n, 3)).astype(np.float32) * np.array(
        [1.6, 1.1, 1.0], np.float32) + np.array([0, 0, 4], np.float32)
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    sh_dc = ((jnp.asarray(cols) - 0.5) / 0.28209479177387814)[:, None, :]
    density_shift = -np.log(max(n / 1e5, 1.0)) / 3.0
    assert density_shift < 0
    log_scales = (rng.uniform(-4.5, -3.0, size=(n, 3)) + density_shift).astype(np.float32)
    opacity = rng.uniform(-1.0, 1.5, size=(n, 1)).astype(np.float32)
    target = rng.uniform(size=(h, w, 3)).astype(np.float32)
    quats = np.asarray(jnp.zeros((n, 4)).at[:, 0].set(1.0))
    want = dict(means=pts, sh_dc=np.asarray(sh_dc), sh_rest=np.zeros((n, 15, 3), np.float32),
                log_scales=log_scales, quats=quats, opacity_logits=opacity)
    params, alive, cam, got_target = bench.bench_scene(n, w, h, "cpu")
    for f in FIELDS:
        a = _np(getattr(params, f))
        assert a.dtype == np.float32 and np.array_equal(a, want[f]), f
    assert np.array_equal(_np(got_target), target) and bool(alive.all())
    jcam = jax_camera(np.eye(3), np.zeros(3), 1.4, 1.1, w, h)
    np.testing.assert_array_equal(_np(cam.full_proj), np.asarray(jcam.full_proj))


# ---------------------------------------------------------------- bench.py


@pytest.fixture(scope="module")
def chain_scene():
    params, alive, cam, target = bench.bench_scene(CHAIN_N, CHAIN_W, CHAIN_H, "cpu")
    budget, pairs = bench.probe_budget(cam, params, alive)
    jcam = jax_camera(np.eye(3), np.zeros(3), 1.4, 1.1, CHAIN_W, CHAIN_H)
    jalive = jnp.ones((CHAIN_N,), bool)
    jgrad = _jax_mse_grad(jcam, jalive, jnp.asarray(_np(target)), budget)
    return params, alive, cam, target, budget, pairs, jcam, jalive, jgrad


def test_bench_pairs_match_jax(chain_scene):
    """The probe's pair count is the JAX render's num_pairs (exact), and the
    budget is the JAX package's tuned_pair_budget of it."""
    params, alive, cam, target, budget, pairs, jcam, jalive, jgrad = chain_scene
    jout = jax_render(jcam, _jax_params(params), alive=jalive, pair_budget=budget)
    assert int(jout["overflow"]) == 0
    assert pairs == int(jout["num_pairs"]) and budget == jax_tuned_budget(pairs)
    got = torch_render(cam, params, alive=alive, pair_budget=budget)
    for k, (rtol, atol) in TOL.items():
        np.testing.assert_allclose(_np(got[k]), np.asarray(jout[k]), rtol=rtol, atol=atol)


@pytest.mark.parametrize("forward_only", [False, True])
def test_bench_chain_matches_jax(chain_scene, forward_only):
    """bench.py's chained step (`p - 1e-30 dMSE/dp`, or the forward-only
    render folded into the means), two steps without a graph, against the
    same two steps through the JAX package. What each step computes is held
    at the parameters it starts from: the gradients (fwd+bwd) or the render
    (forward-only). In float32 `p - 1e-30 g` is p wherever p is not 0, so
    the fwd+bwd chain's output is held where p is 0 (the SH rest and the
    quaternions' vector part): there it is -1e-30 (g1 + g2)."""
    params, alive, cam, target, budget, pairs, jcam, jalive, jgrad = chain_scene
    jparams = _jax_params(params)
    if forward_only:
        step = bench.forward_step(cam, alive, budget)

        def jstep(p):
            out = jax_render(jcam, p, alive=jalive, pair_budget=budget)
            return dataclasses.replace(p, means=p.means + out["render"][0, 0, :3] * 1e-30)
    else:
        step = bench.fwd_bwd_step(cam, alive, target, budget)

        def jstep(p):
            return jax.tree.map(lambda x, y: x - 1e-30 * y, p, jgrad(p))
    p, jp = params, jparams
    for k in range(2):
        if forward_only:
            got = torch_render(cam, p, alive=alive, pair_budget=budget)
            jout = jax_render(jcam, jp, alive=jalive, pair_budget=budget)
            for key, (rtol, atol) in TOL.items():
                np.testing.assert_allclose(_np(got[key]), np.asarray(jout[key]), rtol=rtol,
                                           atol=atol, err_msg=f"step {k} {key}")
        else:
            got_g, overflow = bench.mse_grads(cam, alive, target, budget)(p)
            assert int(overflow) == 0
            want_g = jgrad(jp)
            for f, g in zip(FIELDS, got_g):
                _close_by_max(g, getattr(want_g, f), f"step {k} grad {f}")
        p, jp = step(p)[0], jstep(jp)
    carry, out = bench.chain(step, 2)({f: getattr(params, f) for f in FIELDS}, {})
    assert int(out["overflow"]) == 0
    for f in FIELDS:
        start = _np(getattr(params, f)).astype(np.float64)
        moved = _np(carry[f]).astype(np.float64) - start
        want_moved = np.asarray(getattr(jp, f), np.float64) - start
        if not forward_only and f in ("sh_rest", "quats"):
            assert np.abs(want_moved).max() > 0, f
        _close_by_max(moved, want_moved, f"chained {f}, moved from the start")
        np.testing.assert_array_equal(_np(carry[f]), _np(getattr(p, f)), err_msg=f)


@pytest.mark.parametrize("forward_only", [False, True])
def test_bench_main_prints_bench_py_line(capsys, forward_only):
    argv = ["--device", "cpu", "--n", "150", "--width", "64", "--height", "48"]
    record = bench.main(argv + (["--forward-only"] if forward_only else []))
    captured = capsys.readouterr()
    lines = captured.out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == record
    assert list(record) == ["metric", "value", "unit", "vs_baseline", "step_ms", "pairs",
                            "device"]
    mode = "forward/serving" if forward_only else "fwd+bwd"
    assert record["metric"] == f"rays/s per chip ({mode}), 64x48, 0k Gaussians"
    assert record["unit"] == "rays/s" and record["device"] == "cpu" and record["pairs"] > 0
    assert record["value"] > 0 and record["step_ms"] > 0
    assert record["vs_baseline"] == round(record["value"] / 1e8, 4)
    assert any(l.startswith("kernel launches {") for l in captured.err.splitlines())


def test_probe_backend(capsys):
    """The probe's child answers on the CPU; a timeout gives the JSON error
    line and exit code 3."""
    bench.probe_backend("cpu", timeout_s=120)
    with pytest.raises(SystemExit) as e:
        bench.probe_backend("cpu", timeout_s=1e-3)
    assert e.value.code == 3
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["error"] == "gpu_wedged"


def test_bench_budget_overflow_raises(chain_scene, monkeypatch):
    """A tuned budget the scene's pairs do not fit in raises (no bare
    assert): here the tuning is cut to half the probe's count."""
    params, alive, cam, *_ = chain_scene
    monkeypatch.setattr(bench, "tuned_pair_budget", lambda pairs: pairs // 2)
    with pytest.raises(RuntimeError, match="pair budget overflow"):
        bench.probe_budget(cam, params, alive)


@pytest.mark.parametrize("tool", ["bench", "bench_components", "bench_eval", "bench_distill",
                                  "bench_amg", "bench_scaling"])
def test_tools_raise_without_cuda(monkeypatch, tool):
    main = importlib.import_module(f"semantic_gaussians_torch.tools.{tool}").main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main([])


# ---------------------------------------------------------------- bench_components


@pytest.fixture(scope="module")
def components(chain_scene):
    """The port's stages on the chain's scene (3,000 Gaussians, 96x72, the
    probe's budget), and the JAX tool's intermediate values on it."""
    params, alive, cam, target, budget, _, jcam, jalive, jgrad = chain_scene
    stages, (proj0, bin0) = bench_components.make_stages(params, alive, cam, target, budget)
    jp = _jax_params(params)
    jproj = jax_project(jp.means, jp.scales, jp.quats, jp.opacity[:, 0], jcam.world_view,
                        jcam.full_proj, jcam.camera_center, jcam.width, jcam.height,
                        jcam.tan_half_fov_x, jcam.tan_half_fov_y, sh_coeffs=jp.sh_coeffs,
                        sh_degree=3, alive=jalive)
    grid = (-(-CHAIN_H // DEFAULT_TILE[0]), -(-CHAIN_W // DEFAULT_TILE[1]))
    jbin = jax_bin(jproj.means2d, jproj.depths, jproj.radii_xy, DEFAULT_TILE, grid, budget)
    cfg = CompositeConfig(tile_h=DEFAULT_TILE[0], tile_w=DEFAULT_TILE[1], grid_h=grid[0],
                          grid_w=grid[1], num_channels=3, interpret=True)
    return dict(stages=stages, bin0=bin0, budget=budget, jcam=jcam, jp=jp, jalive=jalive,
                jgrad=jgrad, jproj=jproj, jbin=jbin, cfg=cfg)


def _stage(c, name):
    fn, x0 = c["stages"][name]
    x1, out = fn(x0)
    assert set(x1) == set(x0) and all(x1[k].shape == x0[k].shape for k in x0)
    return out


def test_components_full_stages_match_jax(components):
    c = components
    out = _stage(c, "full fwd only")
    jout = jax_render(c["jcam"], c["jp"], alive=c["jalive"], pair_budget=c["budget"])
    for k, (rtol, atol) in TOL.items():
        np.testing.assert_allclose(_np(out[k]), np.asarray(jout[k]), rtol=rtol, atol=atol)
    np.testing.assert_array_equal(_np(out["n_contrib"]), np.asarray(jout["n_contrib"]))
    grads = _stage(c, "full fwd+bwd")
    want = c["jgrad"](c["jp"])
    for f in FIELDS:
        _close_by_max(grads[f], getattr(want, f), f)


def test_components_projection_and_binning_match_jax(components):
    c = components
    proj = _stage(c, "projection fwd")
    for f in ("means2d", "depths", "conics", "opacities", "colors"):
        np.testing.assert_allclose(_np(proj[f]), np.asarray(getattr(c["jproj"], f)), rtol=1e-5,
                                   atol=1e-6, err_msg=f)
    np.testing.assert_array_equal(_np(proj["radii"]), np.asarray(c["jproj"].radii))
    b = _stage(c, "binning")
    for f in ("pair_gaussian", "tile_start", "tile_count", "num_pairs", "overflow"):
        np.testing.assert_array_equal(_np(b[f]), np.asarray(getattr(c["jbin"], f)), err_msg=f)
    assert int(b["num_pairs"]) > 1000 and int(b["overflow"]) == 0


def test_components_pack_gather_matches_jax(components):
    """The port's [geometry, colour] row gather against the JAX pair
    columns (rows 0-5 geometry, 6-8 colour, 9 depth), and the gather's
    gradient (pair_grads_to_gaussians) against the JAX VJP."""
    c = components
    rows = _np(_stage(c, "pack gather fwd")["rows"])
    cols = np.asarray(_pack_pair_cols(c["jproj"], c["jbin"], c["cfg"]))[:, :c["budget"]].T
    want = np.concatenate([cols[:, :6], cols[:, 9:10], np.zeros_like(cols[:, :1]),
                           cols[:, 6:9]], axis=1)
    invalid = _np(c["bin0"].pair_gaussian) == CHAIN_N
    assert invalid.any() and not rows[invalid].any()
    np.testing.assert_allclose(rows, want, rtol=1e-5, atol=1e-6)

    got = _stage(c, "pack gather fwd+bwd")

    def pack_loss(m2d, colors):
        pr = dataclasses.replace(c["jproj"], means2d=m2d, colors=colors)
        return jnp.sum(_pack_pair_cols(pr, c["jbin"], c["cfg"]) * 1e-6)

    gm, gc = jax.grad(pack_loss, argnums=(0, 1))(c["jproj"].means2d, c["jproj"].colors)
    np.testing.assert_allclose(_np(got["means2d"]), np.asarray(gm), rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(_np(got["colors"]), np.asarray(gc), rtol=1e-5, atol=1e-12)
    assert np.asarray(gm).max() > 0


def test_components_composite_matches_jax(components):
    """composite fwd against composite_pairs; composite fwd+bwd's per-pair
    rows against the VJP of mean(color) in the pair columns, every slot in
    a tile range, at atol 1e-4 x the column's largest |value|."""
    c = components
    out = _stage(c, "composite fwd")
    pair0 = _pack_pair_cols(c["jproj"], c["jbin"], c["cfg"])
    jbin, bg = c["jbin"], jnp.zeros(3)
    want = composite_pairs(c["cfg"], pair0, bg, jbin.tile_start, jbin.tile_count)
    for (k, (rtol, atol)), w in zip([("render", TOL["render"]), ("depth", TOL["depth"]),
                                     ("final_T", TOL["final_T"])], want[:3]):
        got = out["color"] if k == "render" else out[k]
        np.testing.assert_allclose(_np(got), np.asarray(w), rtol=rtol, atol=atol, err_msg=k)
    np.testing.assert_array_equal(_np(out["n_contrib"]), np.asarray(want[3]))

    got = _stage(c, "composite fwd+bwd")
    grad = jax.grad(lambda pd: jnp.mean(composite_pairs(c["cfg"], pd, bg, jbin.tile_start,
                                                        jbin.tile_count)[0]))(pair0)
    live = int(np.asarray(jbin.tile_count).sum())
    assert live == int(_np(got["live"]).sum())
    _close_by_max(_np(got["rows"])[:live], np.asarray(grad)[:9, :live].T, "rows", axis=0)


# ---------------------------------------------------------------- bench_eval


def test_bench_eval_confusions_match_jax(capsys):
    """The tool at 2,000 Gaussians, C = 16, 4 views in chunks of 2, 64x48:
    its inputs are the root tool's draws; per-view and chunked confusions
    are identical, and equal, element for element, to the JAX eval_views'
    both ways."""
    argv = ["--device", "cpu", "--n", "2000", "--c", "16", "--views", "4", "--chunk", "2",
            "--w", "64", "--h", "48"]
    args = bench_eval.parse_args(argv)
    out = bench_eval.run(args)
    assert "confusions identical" in capsys.readouterr().out
    jparams, jalive, rng = _root_tool("common").random_cloud_params(2000)
    feats = rng.normal(size=(2000, 16)).astype(np.float32)
    text = rng.normal(size=(20, 16)).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    cams = [jax_camera(np.eye(3), np.array([0.02 * i, 0, 0], np.float32), 1.4, 1.1, 64, 48)
            for i in range(4)]
    gts = [rng.integers(0, 20, size=(48, 64)) for _ in range(4)]
    tin = bench_eval.eval_inputs(2000, 16, 4, 64, 48, 19, "cpu")
    np.testing.assert_array_equal(_np(tin[4]), feats)
    np.testing.assert_array_equal(tin[5], text)
    assert all(np.array_equal(a, b) for a, b in zip(tin[1], gts))
    labels = [f"c{i}" for i in range(19)]
    _, _, conf = jax_eval_views(cams, gts, jparams, jalive, jnp.asarray(feats), text, labels,
                                chunk_views=0)
    for way in ("per_view", "chunked"):
        np.testing.assert_array_equal(out[way]["confusion"], np.asarray(conf))
    assert out["per_view"]["confusion"].sum() == sum(int((g < 19).sum()) for g in gts)


# ---------------------------------------------------------------- bench_distill


@pytest.mark.parametrize("voxels", [2048, 131072])
def test_room_voxels_is_root_tools(voxels):
    root = _root_tool("bench_distill")
    r1, r2 = np.random.default_rng(0), np.random.default_rng(0)
    a, b = bench_distill.room_voxels(voxels, r1), root.room_voxels(voxels, r2)
    assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)
    assert r1.bit_generator.state == r2.bit_generator.state
    assert len(np.unique(a, axis=0)) == len(a) > 0.9 * voxels


def test_tiny_distill_first_loss_matches_jax():
    """--tiny: 2,048 room voxels, MinkUNet14A, 32 dims. The first step's
    loss on the same weights (the port's init carried to JAX with
    unet_state_to_flax; the converters are held both ways in
    test_torch_distill.py) within 1e-5 of the JAX step's, on the root
    tool's inputs."""
    coords, feats, gt, gt_mask, mask = bench_distill.distill_inputs(2048, 32, "cpu")
    rng = np.random.default_rng(0)
    want_coords = _root_tool("bench_distill").room_voxels(2048, rng)
    n = want_coords.shape[0]
    np.testing.assert_array_equal(_np(coords), want_coords)
    np.testing.assert_array_equal(_np(feats), rng.normal(size=(n, 56)).astype(np.float32))
    np.testing.assert_array_equal(_np(gt), rng.normal(size=(n, 32)).astype(np.float32))
    np.testing.assert_array_equal(_np(gt_mask), rng.uniform(size=(n,)) > 0.2)

    cfg = td.DistillConfig(model_3d="MinkUNet14A", feature_dim=32, in_channels=56)
    model, opt, schedule = td.make_distill_state(cfg, steps_per_epoch=100, device="cpu")
    variables = jax.tree.map(jnp.asarray, unet_state_to_flax(model))
    loss = float(td.make_distill_step(model, opt, schedule, cfg)(coords, feats, gt, gt_mask, mask))
    jcfg = jd.DistillConfig(model_3d="MinkUNet14A", feature_dim=32, in_channels=56)
    jmodel = jd.mink_unet(in_channels=56, out_channels=32, arch="MinkUNet14A")
    tx = optax.adamw(optax.cosine_decay_schedule(jcfg.lr, jcfg.epochs * 100),
                     weight_decay=jcfg.weight_decay)
    _, _, jloss = jd.make_distill_step(jmodel, tx, jcfg)(
        variables, tx.init(variables["params"]), *(jnp.asarray(_np(t)) for t in (
            coords, feats, gt, gt_mask, mask)))
    assert abs(loss - float(jloss)) <= 1e-5 and 0 < loss < 2


# ---------------------------------------------------------------- bench_amg


def test_amg_encoder_and_decode_batch_match_jax():
    """The tool's image and points (its draws from seed 0; 320x240, a batch
    of 16) through its tiny SAM (img_size 256, the port's seeded weights
    carried to JAX with params_from_sam_state_dict; the converters are held
    both ways in test_torch_sam.py): SamAutoMask.embed against the JAX
    `_encode`, and the timed batch (predict_batch) against `_predict_fn`:
    IoU; masks where the logit is not within rounding of the threshold;
    stability scores within the share of such pixels; boxes as JAX boxes
    the same masks."""
    gen, img, pts = bench_amg.amg_inputs(320, 240, 16, "cpu")
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(img, (rng.uniform(size=(240, 320, 3)) * 255).astype(np.uint8))
    cfg = jsam.SamConfig.tiny(img_size=256)
    want_pts = rng.uniform(0, cfg.img_size, (16, 1, 2)).astype(np.float32)
    np.testing.assert_array_equal(_np(pts), want_pts[:, 0])
    var = jsam.params_from_sam_state_dict(gen.model.state_dict(), cfg)
    jgen = jam.SamAutoMask(cfg, var, jam.AutoMaskConfig(points_per_side=16))

    emb, rhw = gen.embed(img)
    x, jrhw = jsam.preprocess_image(img, cfg.img_size)
    jemb = jgen._encode(var, jnp.asarray(x)[None])[0]
    assert rhw == jrhw
    np.testing.assert_allclose(_np(emb), np.asarray(jemb), rtol=2e-4, atol=2e-5)
    with torch.inference_mode():
        logits, _ = gen.decode_batch(emb, pts, (240, 320), rhw)
        masks, iou, stab, boxes = bench_amg.predict_batch(gen, emb, pts, (240, 320), rhw)
    jmasks, jiou, jstab, jboxes = map(np.asarray, jgen._predict_fn((240, 320))(
        var, jemb, jnp.asarray(want_pts)))
    np.testing.assert_allclose(_np(iou), jiou, rtol=2e-4, atol=2e-5)
    lg, thr, off = _np(logits), gen.amg.mask_threshold, gen.amg.stability_score_offset
    np.testing.assert_array_equal(_np(masks), lg > thr)
    eps = 2e-4 * np.abs(lg).max()
    clear = np.abs(lg - thr) > eps
    np.testing.assert_array_equal(_np(masks)[clear], jmasks[clear])
    assert clear.mean() > 0.99
    union = (lg > thr - off).sum((-2, -1))
    near = ((~clear).sum((-2, -1)) + (np.abs(lg - thr - off) <= eps).sum((-2, -1))
            + (np.abs(lg - thr + off) <= eps).sum((-2, -1)))
    assert (np.abs(_np(stab) - jstab) <= near / np.maximum(union, 1) + 1e-6).all()
    np.testing.assert_array_equal(_np(boxes), _np(masks_to_boxes(masks)))
    np.testing.assert_array_equal(_np(masks_to_boxes(torch.from_numpy(jmasks))), jboxes)


# ---------------------------------------------------------------- bench_scaling


@pytest.mark.parametrize("world", [1, 2])
def test_band_gradients_match_jax(tmp_path, world):
    """bench_scaling's band step (the MSE gradient through render_sharded)
    on `world` gloo ranks, on the tool's scene law at 2,000 Gaussians and
    96x72 (SH degree 0), against the JAX render's MSE gradients on the same
    arrays: at one rank within the render-gradient tolerance, at two
    within 2e-3 of each leaf's largest."""
    n, w, h, budget = 2000, 96, 72, 65_536
    outs = run_ranks(band_grads_rank, world, tmp_path, n, w, h, budget // world)
    params, alive, cam, target = bench_scaling.scaling_scene(n, w, h, "cpu")
    jcam = jax_camera(np.eye(3), np.zeros(3), 1.4, 1.1, w, h)
    want = _jax_mse_grad(jcam, jnp.asarray(_np(alive)), jnp.asarray(_np(target)),
                         budget)(_jax_params(params))
    for got in outs:
        for f, g in zip(FIELDS, got):
            _close_by_max(g, getattr(want, f), f, atol=1e-4 if world == 1 else 2e-3)
    np.testing.assert_array_equal(outs[0][0], outs[-1][0])


def test_scaling_rank_rows(tmp_path):
    """scaling_rank on two gloo ranks (tiny scene): one row a count on rank
    0, with the root tool's keys, efficiency 1 at one rank."""
    outs = run_ranks(bench_scaling.scaling_rank, 2, tmp_path, "cpu", 500, 64, 48, 1)
    rows = outs[0]["rows"]
    assert [r["devices"] for r in rows] == [1, 2]
    assert all(list(r) == ["mode", "devices", "rays_per_s", "step_ms", "scaling_efficiency"]
               for r in rows)
    assert rows[0]["scaling_efficiency"] == 1.0 and all(r["mode"] == "band" for r in rows)
    assert [r["devices"] for r in outs[1]["rows"]] == [2]
    assert set(outs[0]["launches"]) >= {"expand", "composite_fwd", "composite_bwd", "segsum"}
