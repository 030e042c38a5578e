"""Port parity: the RGB training step and its parts, vs the JAX package.

Losses at rtol 1e-5; the lr schedule and Adam at rtol 1e-6; densify slot
assignment, `alive`, `dropped` and the zeroed moments exact, floats at
rtol 1e-6 (the split noise is JAX's own draws, handed to the port); KNN and
init at rtol 1e-5, atol 1e-5; and K = 3 train steps from one carried-across state vs
JAX `train_step(backend="pallas")` (tolerances at that test).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from semantic_gaussians_tpu.core import densify as jdens
from semantic_gaussians_tpu.core import gaussians as jgauss
from semantic_gaussians_tpu.core import optimizer as jopt
from semantic_gaussians_tpu.ops.knn import knn_mean_sq_dist as jax_knn
from semantic_gaussians_tpu.pipelines import train as jtrain
from semantic_gaussians_tpu.utils import losses as jloss
from semantic_gaussians_tpu.utils.camera import make_camera as jax_camera
from semantic_gaussians_tpu.utils.schedules import expon_lr_schedule as jax_sched
from semantic_gaussians_torch.core import densify as tdens
from semantic_gaussians_torch.core import gaussians as tgauss
from semantic_gaussians_torch.core import optimizer as topt
from semantic_gaussians_torch.ops.knn import knn_mean_sq_dist as torch_knn
from semantic_gaussians_torch.pipelines import train as ttrain
from semantic_gaussians_torch.utils import losses as tloss
from semantic_gaussians_torch.utils.camera import make_camera as torch_camera
from semantic_gaussians_torch.utils.schedules import expon_lr_schedule as torch_sched
from torch_port_common import FIELDS, W, H, np_, scene_arrays

T = torch.from_numpy


def _jparams(arrays):
    return jgauss.GaussianParams(**{f: jnp.asarray(arrays[f]) for f in FIELDS})


def _jax_state_numpy(state):
    """A JAX TrainState as train_state_from_numpy's dict of numpy arrays."""
    leaves = lambda p: {f: np.asarray(getattr(p, f)) for f in FIELDS}
    return dict(
        params=leaves(state.params), alive=np.asarray(state.alive),
        adam=dict(count=np.asarray(state.adam.count), mu=leaves(state.adam.mu),
                  nu=leaves(state.adam.nu)),
        dstate={k: np.asarray(getattr(state.dstate, k)) for k in (
            "xyz_grad_accum", "denom", "max_radii2d")},
        step=np.asarray(state.step),
    )


def _assert_state(got, want, rtol=1e-6, atol=0.0):
    got = ttrain.train_state_to_numpy(got)
    want = _jax_state_numpy(want)

    def walk(g, w, path):
        if isinstance(w, dict):
            for k in w:
                walk(g[k], w[k], f"{path}.{k}")
        elif w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=path)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=path)

    walk(got, want, "state")


@pytest.mark.parametrize("cut_edge", [False, True])
def test_losses_match_jax(cut_edge):
    rng = np.random.default_rng(3)
    a = rng.uniform(size=(H, W, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(size=a.shape).astype(np.float32) * 0.1, 0, 1)
    if cut_edge:  # the train step's 1% border crop
        ch, cw = ttrain._edge_crop(H, W, True)
        assert (ch, cw) == jtrain._edge_crop(H, W, True) == (0, 1)
        a, b = a[ch:H - ch, cw:W - cw], b[ch:H - ch, cw:W - cw]
    for name in ("l1_loss", "psnr", "ssim", "photometric_loss"):
        want = float(getattr(jloss, name)(jnp.asarray(a), jnp.asarray(b)))
        got = float(getattr(tloss, name)(T(a), T(b)))
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=name)


def test_ssim_is_full_f32_under_tf32_flags(monkeypatch):
    """The blur has no convolution for cuDNN to run in TF32: its result does
    not depend on the TF32 flags."""
    rng = np.random.default_rng(4)
    a, b = (T(rng.uniform(size=(32, 40, 3)).astype(np.float32)) for _ in range(2))
    ref = tloss.ssim(a, b)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert torch.equal(tloss.ssim(a, b), ref)


def test_lr_schedule_and_tree():
    hyper = topt.TrainHyper()
    jh = jopt.TrainHyper()
    for step in (0, 1, 7, 500, 9999, 10000, 25000):
        want = jopt.lr_tree(jh, 2.5, jnp.asarray(step, jnp.int32))
        got = topt.lr_tree(hyper, 2.5, torch.tensor(step, dtype=torch.int32))
        for f in FIELDS:
            np.testing.assert_allclose(np_(getattr(got, f)), np_(getattr(want, f)),
                                       rtol=1e-6, err_msg=f"{f} @ {step}")
    for kw in (dict(lr_delay_steps=100, lr_delay_mult=0.1), dict(lr_init=0.0)):
        args = dict(lr_init=1e-3, lr_final=1e-5, max_steps=1000)
        args.update(kw)
        for step in (-1, 0, 50, 100, 2000):
            np.testing.assert_allclose(float(torch_sched(**args)(step)),
                                       float(jax_sched(**args)(step)), rtol=1e-6)


def test_adam_update_matches_jax():
    arrays, _ = scene_arrays(n=200, seed=5)
    rng = np.random.default_rng(6)
    grads = {f: rng.normal(size=v.shape).astype(np.float32) for f, v in arrays.items()}
    moments = [{f: rng.normal(size=v.shape).astype(np.float32) * s for f, v in arrays.items()}
               for s in (0.1, 0.01)]
    moments[1] = {f: np.abs(v) for f, v in moments[1].items()}
    jh, th = jopt.TrainHyper(), topt.TrainHyper()
    jstate = jopt.AdamState(count=jnp.asarray(3, jnp.int32), mu=_jparams(moments[0]),
                            nu=_jparams(moments[1]))
    tstate = topt.AdamState(count=torch.tensor(3, dtype=torch.int32),
                            mu=tgauss.params_from_numpy(moments[0], "cpu"),
                            nu=tgauss.params_from_numpy(moments[1], "cpu"))
    want_p, want_s = jopt.adam_update(_jparams(grads), jstate, _jparams(arrays),
                                      jopt.lr_tree(jh, 1.0, 3), jh)
    got_p, got_s = topt.adam_update(tgauss.params_from_numpy(grads, "cpu"), tstate,
                                    tgauss.params_from_numpy(arrays, "cpu"),
                                    topt.lr_tree(th, 1.0, 3), th)
    assert int(got_s.count) == int(want_s.count) == 4
    for f in FIELDS:
        for g, w in ((got_p, want_p), (got_s.mu, want_s.mu), (got_s.nu, want_s.nu)):
            np.testing.assert_allclose(np_(getattr(g, f)), np_(getattr(w, f)), rtol=1e-6,
                                       atol=1e-12, err_msg=f)


def test_add_stats_matches_jax():
    rng = np.random.default_rng(8)
    cap = 300
    acc = [rng.uniform(size=cap).astype(np.float32) for _ in range(3)]
    grad = rng.normal(size=(cap, 2)).astype(np.float32) * 1e-3
    radii = (rng.integers(0, 3, cap) * rng.integers(1, 40, cap)).astype(np.int32)
    want = jdens.add_stats(jdens.DensifyState(*map(jnp.asarray, acc)), jnp.asarray(grad),
                           jnp.asarray(radii), W, H)
    got = tdens.add_stats(tdens.DensifyState(*map(T, acc)), T(grad), T(radii), W, H)
    for k in ("xyz_grad_accum", "denom", "max_radii2d"):
        np.testing.assert_allclose(np_(getattr(got, k)), np_(getattr(want, k)), rtol=1e-6,
                                   err_msg=k)


def _densify_case(case):
    """tests/test_train.py's clone+split and prune cases, with non-zero Adam
    moments (so the zeroing shows) and a screen-size variant."""
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(100, 3)).astype(np.float32)
    cols = rng.uniform(size=(100, 3)).astype(np.float32)
    params, alive = jgauss.init_from_pcd(pts, cols, sh_degree=2, capacity=1024)
    arrays = {f: np.asarray(getattr(params, f)).copy() for f in FIELDS}
    arrays["quats"] = rng.normal(size=arrays["quats"].shape).astype(np.float32)
    cap = 1024
    accum = np.zeros(cap, np.float32)
    cfg = dict(grad_threshold=0.5, percent_dense=0.01)
    if case in ("clone_split", "screen_size"):
        accum[:50] = 1.0
        ls = np.full((cap, 3), -10.0, np.float32)
        ls[:25] = -8.0  # tiny -> clone
        ls[25:50] = 2.0 if case == "clone_split" else -3.0  # large -> split
        arrays["log_scales"] = ls
        if case == "screen_size":
            cfg["max_screen_size"] = 20.0
            arrays["log_scales"][60:70] = 0.5  # pruned by the world-size test
    else:  # prune
        arrays["opacity_logits"][:30] = -10.0
        cfg["grad_threshold"] = 1e9
    dstate = (accum, np.ones(cap, np.float32), np.zeros(cap, np.float32))
    moments = [{f: rng.normal(size=v.shape).astype(np.float32) for f, v in arrays.items()}
               for _ in range(2)]
    return arrays, np.array(alive), dstate, moments, cfg


@pytest.mark.parametrize("case", ["clone_split", "prune", "screen_size"])
def test_densify_matches_jax(case):
    arrays, alive, dstate, moments, cfg = _densify_case(case)
    key = jax.random.PRNGKey(0)
    jadam = jopt.AdamState(jnp.asarray(5, jnp.int32), _jparams(moments[0]),
                           _jparams(moments[1]))
    want = jdens.densify_and_prune(
        _jparams(arrays), jnp.asarray(alive), jadam,
        jdens.DensifyState(*map(jnp.asarray, dstate)), key, 1.0, jdens.DensifyConfig(**cfg),
    )
    # the JAX pass's own split noise: one normal draw per child, in order
    noise, k = [], key
    for _ in range(2):
        k, sub = jax.random.split(k)
        noise.append(T(np.array(jax.random.normal(sub, arrays["means"].shape))))
    tadam = topt.AdamState(torch.tensor(5, dtype=torch.int32),
                           tgauss.params_from_numpy(moments[0], "cpu"),
                           tgauss.params_from_numpy(moments[1], "cpu"))
    got = tdens.densify_and_prune(
        tgauss.params_from_numpy(arrays, "cpu"), T(alive), tadam,
        tdens.DensifyState(*map(T, dstate)), 1.0, tdens.DensifyConfig(**cfg), noise=noise,
    )
    (gp, ga, gadam, gds, gdrop), (wp, wa, wadam, wds, wdrop) = got, want
    np.testing.assert_array_equal(np_(ga), np_(wa))
    assert int(gdrop) == int(wdrop)
    for f in FIELDS:
        # atol: a child mean is parent + R (scale eps) with scales up to
        # e^2, and rounds at that offset's ulp (one element of the split
        # case lands 1.2e-6 apart where the sum cancels to ~0.1)
        w = np_(getattr(wp, f))
        np.testing.assert_allclose(np_(getattr(gp, f)), w, rtol=1e-6,
                                   atol=1e-6 * np.abs(w).max(), err_msg=f)
        for g, w in ((gadam.mu, wadam.mu), (gadam.nu, wadam.nu)):
            # zeroed moments are exact zeros; the others are copies
            np.testing.assert_array_equal(np_(getattr(g, f)), np_(getattr(w, f)), err_msg=f)
    for k in ("xyz_grad_accum", "denom", "max_radii2d"):
        assert not np_(getattr(gds, k)).any()
    n_alive = int(np_(ga).sum())
    assert n_alive == {"clone_split": 150, "prune": 70, "screen_size": 140}[case]


def test_reset_grow_and_budget():
    arrays, alive = scene_arrays(n=96, seed=9, dead=10)
    arrays["opacity_logits"][:5] = -8.0
    jstate = jtrain.init_train_state(_jparams(arrays), jnp.asarray(alive))
    rng = np.random.default_rng(10)
    mu = {f: rng.normal(size=v.shape).astype(np.float32) for f, v in arrays.items()}
    jstate = dataclasses.replace(jstate, adam=jopt.AdamState(
        jnp.asarray(2, jnp.int32), _jparams(mu), _jparams(mu)))
    tstate = ttrain.train_state_from_numpy(_jax_state_numpy(jstate), "cpu")
    _assert_state(ttrain.opacity_reset_step(tstate), jtrain.opacity_reset_step(jstate))
    reset = ttrain.opacity_reset_step(tstate)
    assert float(reset.params.opacity.max()) <= 0.01 + 1e-7
    assert not reset.adam.mu.opacity_logits.any() and not reset.adam.nu.opacity_logits.any()
    grown = ttrain.grow_capacity(tstate)
    assert grown.params.capacity == 192
    _assert_state(grown, jtrain.grow_capacity(jstate), rtol=0)
    for pairs in (0, 100, 300_000, 1_000_003, 15_000_000, 1 << 26):
        assert ttrain.tuned_pair_budget(pairs) == jtrain.tuned_pair_budget(pairs)


def test_knn_and_init_from_pcd_match_jax():
    rng = np.random.default_rng(11)
    pts = (rng.normal(size=(700, 3)) * [1.0, 0.5, 2.0]).astype(np.float32)
    cols = rng.uniform(size=(700, 3)).astype(np.float32)
    # atol: both form d2 as |q|^2 + |p|^2 - 2 q.p in float32, which cancels
    # to ~1 ulp of |q|^2 (~5 here): 2.5e-6 apart seen on 3% of the points
    np.testing.assert_allclose(np_(torch_knn(T(pts), block_q=256)),
                               np_(jax_knn(jnp.asarray(pts))), rtol=1e-5, atol=1e-5)
    # tiny clouds: fewer than 3 neighbours, and none
    for m in (1, 2, 3):
        np.testing.assert_allclose(np_(torch_knn(T(pts[:m]))),
                                   np_(jax_knn(jnp.asarray(pts[:m]))), rtol=1e-5)
    want_p, want_a = jgauss.init_from_pcd(pts, cols, sh_degree=3, capacity=1024)
    got_p, got_a = tgauss.init_from_pcd(pts, cols, sh_degree=3, capacity=1024)
    np.testing.assert_array_equal(np_(got_a), np_(want_a))
    for f in FIELDS:  # log-scales carry the KNN's cancellation (above)
        np.testing.assert_allclose(np_(getattr(got_p, f)), np_(getattr(want_p, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    assert int(tgauss.num_alive(got_a)) == int(jgauss.num_alive(want_a)) == 700


K_STEPS = 3


def test_train_steps_match_jax():
    """K = 3 train steps from one carried-across TrainState (600 Gaussians,
    60 dead, 128x64, SH degree 3 active) vs JAX train_step(backend="pallas").

    Each step's gradient is read back from the Adam first moment on both
    sides, g_k = (mu_k - 0.9 mu_{k-1}) / 0.1, and compared at atol 1e-4 x
    its leaf's largest |g|. Parameters: Adam's first steps move every entry
    by about lr sign(g), so an entry whose gradient is noise-level can move
    2 lr apart between the packages with nothing wrong. The test therefore
    (a) bounds every entry by 2 K lr, and (b) holds entries whose |g| is at
    least 1e-3 x the leaf's largest at every step to 1e-2 lr. Moments (mu,
    nu) at atol 1e-4 x their leaf's largest value; alive, step, count and
    the densify statistics' visibility counts exact."""
    arrays, alive = scene_arrays(n=600, seed=21, dead=60)
    rng = np.random.default_rng(22)
    image = rng.uniform(size=(H, W, 3)).astype(np.float32)
    cam_args = (np.eye(3), np.zeros(3), 1.4, 0.8, W, H)
    jcam = jax_camera(*cam_args, image=jnp.asarray(image))
    tcam = torch_camera(*cam_args, image=image)
    jstate = jtrain.init_train_state(_jparams(arrays), jnp.asarray(alive))
    tstate = ttrain.train_state_from_numpy(_jax_state_numpy(jstate), "cpu")
    _assert_state(tstate, jstate, rtol=0)
    bg = np.asarray([0.1, 0.2, 0.3], np.float32)
    jcfg, tcfg = jtrain.TrainConfig(spatial_lr_scale=2.0), ttrain.TrainConfig(spatial_lr_scale=2.0)
    lrs = topt.lr_tree(tcfg.hyper, 2.0, 0)
    mu_prev = {f: (np.zeros_like(arrays[f]),) * 2 for f in FIELDS}
    strong = {f: np.ones(arrays[f].shape, bool) for f in FIELDS}
    for k in range(K_STEPS):
        jstate, jm = jtrain.train_step(jstate, jcam, jnp.asarray(bg), jcfg, 3, backend="pallas")
        tstate, tm = ttrain.train_step(tstate, tcam, T(bg), tcfg, 3)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        for key in ("num_points", "overflow", "num_pairs"):
            assert int(tm[key]) == int(jm[key]), key
        for f in FIELDS:
            jmu, tmu = np_(getattr(jstate.adam.mu, f)), np_(getattr(tstate.adam.mu, f))
            gj = (jmu - 0.9 * mu_prev[f][0]) / 0.1
            gt = (tmu - 0.9 * mu_prev[f][1]) / 0.1
            scale = np.abs(gj).max() + 1e-20
            np.testing.assert_allclose(gt / scale, gj / scale, rtol=0, atol=1e-4,
                                       err_msg=f"grad {f} @ step {k + 1}")
            assert not gt[~alive].any(), f"{f}: gradient on a dead slot"
            strong[f] &= np.abs(gj) >= 1e-3 * scale
            mu_prev[f] = (jmu, tmu)
    for f in FIELDS:
        lr = float(getattr(lrs, f))
        gp, wp = np_(getattr(tstate.params, f)), np_(getattr(jstate.params, f))
        diff = np.abs(gp - wp)
        assert diff.max() <= 2 * K_STEPS * lr * 1.0001, f
        assert diff[strong[f]].max(initial=0.0) <= 1e-2 * lr, f
        assert strong[f].sum() > 0.1 * strong[f].size * alive.mean() or f == "sh_rest", f
        for m in ("mu", "nu"):
            g = np_(getattr(getattr(tstate.adam, m), f))
            w = np_(getattr(getattr(jstate.adam, m), f))
            scale = np.abs(w).max() + 1e-30
            np.testing.assert_allclose(g / scale, w / scale, rtol=0, atol=1e-4,
                                       err_msg=f"{m} {f}")
    assert int(tstate.step) == int(jstate.step) == K_STEPS
    assert int(tstate.adam.count) == int(jstate.adam.count) == K_STEPS
    np.testing.assert_array_equal(np_(tstate.dstate.denom), np_(jstate.dstate.denom))
    np.testing.assert_array_equal(np_(tstate.dstate.max_radii2d),
                                  np_(jstate.dstate.max_radii2d))
    accum_t, accum_j = np_(tstate.dstate.xyz_grad_accum), np_(jstate.dstate.xyz_grad_accum)
    np.testing.assert_allclose(accum_t, accum_j, rtol=0, atol=1e-4 * accum_j.max())
