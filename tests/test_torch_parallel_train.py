"""Port parity: the multi-device train steps and the hybrid loop.

The port's ranks are spawned gloo CPU processes (torch_dist_common); the
JAX side runs on `make_mesh(2)` of the conftest's 8 CPU devices.

  * view-DP, band and band-ZeRO steps against JAX's: one step from one
    carried-across state at the tolerances of
    test_torch_train.py::test_train_steps_match_jax;
  * the guard for a short camera batch;
  * ZeRO steps in lockstep with their replicated steps (band over 3 steps,
    hybrid 2x2 over 2; loss rtol 1e-5, params and moments 2e-4 of each
    leaf's largest, densify norms 2e-3, visibility exact);
  * hybrid 2x2 against view-DP on 2 ranks (loss 2e-4, params rtol 1e-3 /
    atol 1e-4, visibility exact, norms 2e-3);
  * the band step's densify statistics and trigger against the port's
    single-device train_step;
  * the hybrid loop's protocol, replicated and ZeRO, every rank bitwise
    equal at its end.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_gaussians_tpu.parallel import train_parallel as jtp
from semantic_gaussians_tpu.parallel.mesh import make_mesh as jax_mesh
from semantic_gaussians_tpu.pipelines import train as jtrain
from semantic_gaussians_tpu.utils.camera import make_camera as jax_camera
from semantic_gaussians_torch.core import optimizer as topt
from semantic_gaussians_torch.core.densify import DensifyConfig
from semantic_gaussians_torch.pipelines import train as ttrain
from semantic_gaussians_torch.utils.camera import make_camera as torch_camera
from torch_dist_common import run_ranks
from torch_parallel_ranks import loop_rank, short_batch_rank, steps_rank
from torch_port_common import FIELDS, jax_params, scene_arrays

W, H = 128, 64


def cam_specs(n, seed, shift=0.05, w=W, h=H):
    rng = np.random.default_rng(seed)
    return [dict(R=np.eye(3), t=np.array([shift * i, 0.0, 0.0]), fov_x=1.4, fov_y=0.8,
                 width=w, height=h, image=rng.uniform(size=(h, w, 3)).astype(np.float32))
            for i in range(n)]


def jcam(spec):
    return jax_camera(*(spec[k] for k in ("R", "t", "fov_x", "fov_y", "width", "height")),
                      image=jnp.asarray(spec["image"]))


def jax_state_numpy(state):
    leaves = lambda p: {f: np.asarray(getattr(p, f)) for f in FIELDS}  # noqa: E731
    return dict(
        params=leaves(state.params), alive=np.asarray(state.alive),
        adam=dict(count=np.asarray(state.adam.count), mu=leaves(state.adam.mu),
                  nu=leaves(state.adam.nu)),
        dstate={k: np.asarray(getattr(state.dstate, k)) for k in (
            "xyz_grad_accum", "denom", "max_radii2d")},
        step=np.asarray(state.step),
    )


def initial_state(n=600, seed=41, dead=60):
    arrays, alive = scene_arrays(n=n, seed=seed, dead=dead)
    jstate = jtrain.init_train_state(jax_params(arrays), jnp.asarray(alive))
    return jstate, jax_state_numpy(jstate)


def assert_one_step_matches(got, want, lrs):
    """test_train_steps_match_jax's tolerances for one step from a zero
    state: the gradient (mu / 0.1) at 1e-4 of its leaf's largest; each
    parameter within 2 lr, and within 1e-2 lr where |g| >= 1e-3 of the
    leaf's largest; moments at 1e-4 of their largest; counts and
    visibility exact; densify norms at 1e-4 of their largest."""
    for f in FIELDS:
        gj, gt = want["adam"]["mu"][f] / 0.1, got["adam"]["mu"][f] / 0.1
        scale = np.abs(gj).max() + 1e-20
        np.testing.assert_allclose(gt / scale, gj / scale, rtol=0, atol=1e-4, err_msg=f)
        strong = np.abs(gj) >= 1e-3 * scale
        lr = float(getattr(lrs, f))
        diff = np.abs(got["params"][f] - want["params"][f])
        assert diff.max() <= 2 * lr * 1.0001, f
        assert diff[strong].max(initial=0.0) <= 1e-2 * lr, f
        for m in ("mu", "nu"):
            w = want["adam"][m][f]
            s = np.abs(w).max() + 1e-30
            np.testing.assert_allclose(got["adam"][m][f] / s, w / s, rtol=0, atol=1e-4,
                                       err_msg=f"{m} {f}")
    for k in ("step",):
        assert int(got[k]) == int(want[k])
    assert int(got["adam"]["count"]) == int(want["adam"]["count"])
    for k in ("denom", "max_radii2d"):
        np.testing.assert_array_equal(got["dstate"][k], want["dstate"][k], err_msg=k)
    acc_t, acc_j = got["dstate"]["xyz_grad_accum"], want["dstate"]["xyz_grad_accum"]
    np.testing.assert_allclose(acc_t, acc_j, rtol=0, atol=1e-4 * acc_j.max())


@pytest.mark.parametrize("kind", ["dp", "band", "band_zero"])
def test_step_matches_jax(tmp_path, kind):
    jstate, state_np = initial_state()
    jcfg = jtrain.TrainConfig(spatial_lr_scale=2.0)
    tcfg = ttrain.TrainConfig(spatial_lr_scale=2.0)
    specs = cam_specs(2 if kind == "dp" else 1, seed=42)
    bg = np.asarray([0.1, 0.2, 0.3], np.float32)
    mesh = jax_mesh(2)
    if kind == "dp":
        step = jtp.make_parallel_train_step(mesh, jcfg, active_sh_degree=3)
        want, wm = step(jstate, jtp.stack_cameras([jcam(s) for s in specs]), jnp.asarray(bg))
    elif kind == "band":
        step = jtp.make_band_train_step(mesh, jcfg, active_sh_degree=3)
        want, wm = step(jstate, jcam(specs[0]), jnp.asarray(bg))
    else:
        step = jtp.make_band_train_step_zero(mesh, jcfg, active_sh_degree=3, img_height=H,
                                             img_width=W)
        want, wm = step(jstate, jcam(specs[0]), jnp.asarray(bg))
    outs = run_ranks(steps_rank, 2, tmp_path, kind, state_np, specs, bg, tcfg, 3, 1)
    for out in outs:
        np.testing.assert_allclose(out["metrics"][0]["loss"], float(wm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(out["metrics"][0]["psnr"], float(wm["psnr"]), rtol=1e-5)
        assert out["metrics"][0]["overflow"] == int(wm["overflow"]) == 0
        assert_one_step_matches(out["state"], jax_state_numpy(want),
                                topt.lr_tree(tcfg.hyper, 2.0, 0))
    for f in FIELDS:  # every rank holds the same state
        np.testing.assert_array_equal(outs[0]["state"]["params"][f],
                                      outs[1]["state"]["params"][f])


def test_short_camera_batch_raises(tmp_path):
    """Fewer stacked views than ranks fails with a clear error on every
    rank, as the JAX guard does."""
    _, state_np = initial_state(n=100, dead=0)
    msgs = run_ranks(short_batch_rank, 2, tmp_path, state_np, cam_specs(1, seed=43)[0],
                     ttrain.TrainConfig())
    for msg in msgs:
        assert msg is not None and "1 views" in msg and "2 devices" in msg


@pytest.mark.parametrize("maker", ["dp", "band", "band_zero", "hybrid", "hybrid_zero"])
def test_steps_refuse_a_feature_field(maker):
    """Every step maker's step checks its state on entry: the steps render
    no feature field, so a state with one raises a ValueError that names
    it (one-rank meshes, in this process)."""
    from semantic_gaussians_torch.core.gaussians import params_from_numpy, with_feature_field
    from semantic_gaussians_torch.parallel import train_parallel as tp
    from semantic_gaussians_torch.parallel.mesh import make_mesh_of

    arrays, alive = scene_arrays(n=64, seed=50)
    params = with_feature_field(params_from_numpy(arrays, "cpu"), 8)
    state = ttrain.init_train_state(params, torch.from_numpy(alive))
    cfg = ttrain.TrainConfig(feature_dim=8)
    cam = torch_camera(**cam_specs(1, seed=51)[0])
    line, grid = make_mesh_of((1,), ("data",)), make_mesh_of((1, 1), ("view", "band"))
    step, cams = dict(
        dp=lambda: (tp.make_parallel_train_step(line, cfg, 0), (cam,)),
        band=lambda: (tp.make_band_train_step(line, cfg, 0), cam),
        band_zero=lambda: (tp.make_band_train_step_zero(line, cfg, 0, H, W), cam),
        hybrid=lambda: (tp.make_hybrid_train_step(grid, cfg, 0, H, W), (cam,)),
        hybrid_zero=lambda: (tp.make_hybrid_train_step_zero(grid, cfg, 0, H, W), (cam,)),
    )[maker]()
    with pytest.raises(ValueError, match="'features' \\[N, 8\\]"):
        step(state, cams, torch.zeros(3))


def _states_close(a, b, rel=2e-4, moments=True):
    for f in FIELDS:
        for part in (("params",),) + ((("adam", "mu"),) if moments else ()):
            x, y = a, b
            for k in part:
                x, y = x[k], y[k]
            scale = np.abs(y[f]).max() + 1e-8
            np.testing.assert_allclose(x[f] / scale, y[f] / scale, atol=rel,
                                       err_msg=f"{part} {f}")
    acc_a, acc_b = a["dstate"]["xyz_grad_accum"], b["dstate"]["xyz_grad_accum"]
    np.testing.assert_allclose(acc_a / (acc_b.max() + 1e-12), acc_b / (acc_b.max() + 1e-12),
                               atol=2e-3)
    np.testing.assert_array_equal(a["dstate"]["denom"], b["dstate"]["denom"])


@pytest.mark.parametrize("kind,world,shape,steps", [
    ("band", 2, None, 3),
    ("hybrid", 4, (2, 2), 2),
])
def test_zero_steps_in_lockstep(tmp_path, kind, world, shape, steps):
    """The reduce-scatter + sharded-Adam step against its replicated-Adam
    step (the JAX package's two lockstep tests)."""
    _, state_np = initial_state(n=640, seed=44, dead=40)
    nview = 1 if kind == "band" else shape[0]
    specs = cam_specs(nview, seed=45, shift=0.06)
    cfg = ttrain.TrainConfig()
    bg = np.zeros(3, np.float32)
    rep = run_ranks(steps_rank, world, tmp_path, kind, state_np, specs, bg, cfg, 1, steps,
                    shape)
    zero = run_ranks(steps_rank, world, tmp_path, kind + "_zero", state_np, specs, bg, cfg, 1,
                     steps, shape)
    for z, r in zip(zero, rep):
        np.testing.assert_allclose(z["metrics"][-1]["loss"], r["metrics"][-1]["loss"],
                                   rtol=1e-5)
        assert int(z["state"]["adam"]["count"]) == int(z["state"]["step"]) == steps
        _states_close(z["state"], r["state"])
    assert zero[0]["comm"]["reduce_scatter"] > 0 and "reduce_scatter" not in rep[0]["comm"]


def test_hybrid_matches_view_dp(tmp_path):
    """Hybrid (2 views x 2 bands) against view-DP (2 ranks) on the same
    views: same update and densify statistics (the JAX package's
    test_hybrid_step_matches_view_dp)."""
    _, state_np = initial_state(n=560, seed=46, dead=20)
    specs = cam_specs(2, seed=47)
    cfg = ttrain.TrainConfig()
    bg = np.zeros(3, np.float32)
    hyb = run_ranks(steps_rank, 4, tmp_path, "hybrid", state_np, specs, bg, cfg, 1, 2, (2, 2))
    dp = run_ranks(steps_rank, 2, tmp_path, "dp", state_np, specs, bg, cfg, 1, 2)
    h, d = hyb[0], dp[0]
    assert abs(h["metrics"][-1]["loss"] - d["metrics"][-1]["loss"]) < 2e-4
    for f in FIELDS:
        np.testing.assert_allclose(h["state"]["params"][f], d["state"]["params"][f], rtol=1e-3,
                                   atol=1e-4, err_msg=f)
    np.testing.assert_array_equal(h["state"]["dstate"]["denom"], d["state"]["dstate"]["denom"])
    acc_h, acc_d = h["state"]["dstate"]["xyz_grad_accum"], d["state"]["dstate"]["xyz_grad_accum"]
    np.testing.assert_allclose(acc_h / acc_d.max(), acc_d / acc_d.max(), atol=2e-3)
    for other in hyb[1:]:
        np.testing.assert_array_equal(other["state"]["params"]["means"],
                                      h["state"]["params"]["means"])


def test_band_step_densify_stats_match_single_device(tmp_path):
    """Band training drives the same densify decisions as one device: the
    offset's gradient summed over bands is the single-device mean2D
    gradient (the JAX package's
    test_band_train_step_densify_stats_match_single_chip)."""
    _, state_np = initial_state(n=360, seed=48, dead=0)
    spec = cam_specs(1, seed=49)[0]
    cfg = ttrain.TrainConfig()
    bg = np.zeros(3, np.float32)
    band = run_ranks(steps_rank, 2, tmp_path, "band", state_np, [spec], bg, cfg, 1, 2)[0]
    state = ttrain.train_state_from_numpy(state_np, "cpu")
    cam = torch_camera(**spec)
    for _ in range(2):
        state, _ = ttrain.train_step(state, cam, torch.zeros(3), cfg, 1)
    one = ttrain.train_state_to_numpy(state)
    for k in ("denom", "max_radii2d"):
        np.testing.assert_array_equal(band["state"]["dstate"][k], one["dstate"][k], err_msg=k)
    acc_b, acc_1 = band["state"]["dstate"]["xyz_grad_accum"], one["dstate"]["xyz_grad_accum"]
    np.testing.assert_allclose(acc_b / acc_1.max(), acc_1 / acc_1.max(), atol=2e-3)
    thr = DensifyConfig().grad_threshold
    trig = lambda s: (s["dstate"]["xyz_grad_accum"]  # noqa: E731
                      / np.maximum(s["dstate"]["denom"], 1)) > thr
    np.testing.assert_array_equal(trig(band["state"]), trig(one))
    assert trig(one).any()


@pytest.mark.parametrize("zero", [False, True], ids=["replicated", "zero"])
def test_hybrid_train_loop_protocol(tmp_path, zero):
    """24 iterations on a 1x2 (view, band) mesh: densify every 6 from 4
    (capacity grows), an opacity reset at 18; every rank ends bitwise
    equal (the JAX package's test_hybrid_train_loop_protocol)."""
    arrays, alive = scene_arrays(n=200, seed=50)
    cap = 256  # 200 of 256 alive: densify soon passes 85% and doubles the capacity
    arrays = {f: np.concatenate([v, np.zeros((cap - 200,) + v.shape[1:], v.dtype)])
              for f, v in arrays.items()}
    arrays["opacity_logits"][200:] = -20.0
    alive = np.arange(cap) < 200
    state_np = jax_state_numpy(jtrain.init_train_state(jax_params(arrays), jnp.asarray(alive)))
    cfg = dataclasses.replace(ttrain.TrainConfig(), densify_from_iter=4,
                              densification_interval=6, opacity_reset_interval=18,
                              densify=DensifyConfig(grad_threshold=2e-5))
    outs = run_ranks(loop_rank, 2, tmp_path, (1, 2), state_np, cam_specs(4, seed=51, shift=0.04),
                     cfg, 24, zero, 2.0)
    a, b = outs
    assert int(a["state"]["step"]) == 24 and len(a["history"]) == 4
    assert np.isfinite(a["history"][-1][1]["loss"])
    assert a["state"]["params"]["means"].shape[0] > cap  # grown (by doubling)
    assert a["state"]["alive"].sum() > 200
    op = 1 / (1 + np.exp(-a["state"]["params"]["opacity_logits"][a["state"]["alive"]]))
    assert op.max() < 0.5  # reset at 18, 6 steps to recover
    for part in ("params", "dstate"):
        for k, v in a["state"][part].items():
            np.testing.assert_array_equal(v, b["state"][part][k], err_msg=f"{part} {k}")
    for m in ("mu", "nu"):
        for k, v in a["state"]["adam"][m].items():
            np.testing.assert_array_equal(v, b["state"]["adam"][m][k], err_msg=f"{m} {k}")
    np.testing.assert_array_equal(a["state"]["alive"], b["state"]["alive"])
