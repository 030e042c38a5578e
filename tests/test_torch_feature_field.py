"""Feature 3DGS on the port (a D-channel feature field trained jointly
with RGB) against the plain reference, benchmark/reference/
feature_train_step.py, on seeded random Gaussians: ~2,000 of them, 64x48
views, D = 40, so that the composite takes its wide (C >= 33) path. The
`card` test runs the same on CUDA; it imports neither JAX nor the JAX
package:

    python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_feature_field.py
"""
import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from benchmark.reference import feature_train_step as RF
from benchmark.reference import render as R
from benchmark.scenes.common import look_pose
from semantic_gaussians_torch.core.gaussians import (
    FEATURES,
    FIELDS,
    GaussianParams,
    leaf_names,
    params_from_numpy,
)
from semantic_gaussians_torch.core.optimizer import TrainHyper
from semantic_gaussians_torch.ops import composite
from semantic_gaussians_torch.pipelines.train import (
    FEATURE_STEPS,
    TrainConfig,
    densify_step,
    grow_capacity,
    init_train_state,
    train_loop,
    train_step,
)
from semantic_gaussians_torch.renderer import render
from semantic_gaussians_torch.utils.camera import make_camera_from_c2w
from semantic_gaussians_torch.utils.losses import l1_loss, photometric_loss

torch.set_num_threads(1)  # one torch thread a test worker, as the port's other tests
W, H, D, N = 64, 48, 40, 2000
FOV_X, FOV_Y = 1.2, 0.9
HYPER = dict(position_lr_init=0.00016, position_lr_final=0.0000016, position_lr_delay_mult=0.01,
             position_lr_max_steps=10000, feature_lr=0.0025, opacity_lr=0.05,
             scaling_lr=0.005, rotation_lr=0.001, semantic_feature_lr=0.001)
CFG = TrainConfig(hyper=TrainHyper(**HYPER), densify_from_iter=10_000, feature_dim=D)
REF_HYPER = dict(HYPER, lambda_dssim=CFG.lambda_dssim, lambda_feature=CFG.lambda_feature)


def _poses(views):
    return [look_pose(np.array([0.3 * (i - views / 2), 0.0, 0.1 * (-1) ** i]),
                      np.array([0.05 * (views / 2 - i), 1.0, 0.0])) for i in range(views)]


def _arrays(n=N, seed=0):
    """Flat, anisotropic splats about 4 units in front of the cameras (along
    +y; z is up), with unit feature rows."""
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(n, D))
    return dict(
        means=(rng.normal(size=(n, 3)) * [1.2, 0.6, 0.8] + [0, 4, 0]).astype(np.float32),
        sh_dc=rng.normal(size=(n, 1, 3)).astype(np.float32) * 0.8,
        sh_rest=(rng.normal(size=(n, 15, 3)) * 0.05).astype(np.float32),
        log_scales=(rng.uniform(-3.6, -2.0, size=(n, 3)) - [0, 0, 1.0]).astype(np.float32),
        quats=rng.normal(size=(n, 4)).astype(np.float32),
        opacity_logits=rng.uniform(-2.0, 3.0, size=(n, 1)).astype(np.float32),
        features=(f / np.linalg.norm(f, axis=1, keepdims=True)).astype(np.float32),
    )


def _inputs(dev, views=4, seed=0):
    """(params with a feature field, alive, port cameras, reference cameras,
    teacher maps [V, H, W, D] float16) on `dev`."""
    rng = np.random.default_rng(seed + 100)
    poses = _poses(views)
    params = params_from_numpy(_arrays(seed=seed), dev)
    alive = torch.ones(N, dtype=torch.bool, device=dev)
    images = rng.uniform(0.05, 0.95, size=(views, H, W, 3)).astype(np.float32)
    cams = [make_camera_from_c2w(p, FOV_X, FOV_Y, W, H, image=images[i], image_name=str(i),
                                 device=dev) for i, p in enumerate(poses)]
    refs = [R.camera(p, FOV_X, FOV_Y, W, H, dev) for p in poses]
    t = rng.normal(size=(views, H, W, D))
    teacher = torch.from_numpy((t / np.linalg.norm(t, axis=-1, keepdims=True)).astype(np.float16))
    return params, alive, cams, refs, teacher.to(dev)


def _ref_params(params):
    return {f: getattr(params, f).detach().clone() for f in leaf_names(params)}


def _gap(a, b):
    """The norm of the difference over the norm of the reference."""
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-30))


def _joint_gradients(dev):
    params, alive, cams, refs, teacher = _inputs(dev)
    names = leaf_names(params)
    leaves = {f: getattr(params, f).detach().requires_grad_(True) for f in names}
    out = render(cams[0], GaussianParams(**leaves), alive, bg=torch.zeros(3, device=dev),
                 active_sh_degree=3, features=leaves[FEATURES])
    loss = (photometric_loss(out["render"], cams[0].image, CFG.lambda_dssim)
            + CFG.lambda_feature * l1_loss(out["feature"], teacher[0]))
    grads = torch.autograd.grad(loss, [leaves[f] for f in names])
    ref = {f: v.requires_grad_(True) for f, v in _ref_params(params).items()}
    rgb, feat = RF.render_joint(ref, refs[0], 3, torch.zeros(3, device=dev))
    ref_loss = RF.loss_fn(rgb, cams[0].image, feat, teacher[0], REF_HYPER)
    ref_grads = torch.autograd.grad(ref_loss, [ref[f] for f in names])
    return (out, loss, dict(zip(names, grads))), (rgb, feat, ref_loss, dict(zip(names, ref_grads)))


def _check_joint(dev):
    (out, loss, grads), (rgb, feat, ref_loss, ref_grads) = _joint_gradients(dev)
    assert out["render"].shape == (H, W, 3) and out["feature"].shape == (H, W, D)
    # float32 both; the port steps T by products, the reference by a cumprod
    # over a tile's pairs: entries agree to a few ulps of their sums
    assert float((out["render"] - rgb).detach().abs().max()) < 1e-5
    assert float((out["feature"] - feat).detach().abs().max()) < 1e-5
    assert float(feat.detach().abs().max()) > 0.1  # the field is drawn
    assert abs(float(loss.detach()) - float(ref_loss.detach())) <= 1e-5 * float(ref_loss.detach())
    # every leaf's gradient, the field's included, to float32 round-off of
    # sums over ~10^4 pairs in other orders (observed 1e-7 to 1e-5)
    for f in FIELDS + (FEATURES,):
        assert float(torch.linalg.vector_norm(ref_grads[f])) > 0, f
        assert _gap(grads[f], ref_grads[f]) < 1e-4, (f, _gap(grads[f], ref_grads[f]))


def test_joint_render_loss_and_every_gradient_match_the_reference():
    _check_joint(torch.device("cpu"))


def test_one_adam_step_matches_the_reference():
    """train_step (the render, the loss with its feature term, Adam with
    the field's own rate) against the reference's step from the same
    inputs: the loss, Adam's first moment and the parameters' change, by
    leaf."""
    params, alive, cams, refs, teacher = _inputs(torch.device("cpu"))
    state = init_train_state(params, alive)
    state = dataclasses.replace(state, step=torch.full((), 16000, dtype=torch.int32))
    new, m = train_step(state, cams[1], torch.zeros(3), CFG, 3, teacher=teacher[1])
    ref = RF.follow(_ref_params(params), [refs[1]], [cams[1].image], [teacher[1]], REF_HYPER,
                    CFG.spatial_lr_scale, 16001, 3)
    assert abs(float(m["loss"]) - ref["losses"][0]) <= 1e-5 * ref["losses"][0]
    for f in FIELDS + (FEATURES,):
        mu = float(torch.linalg.vector_norm(getattr(new.adam.mu, f).double()))
        change = float(torch.linalg.vector_norm(getattr(new.params, f).double()
                                                - getattr(params, f).double()))
        # the moment is 0.1 x the gradient (round-off as above); the change
        # of a first Adam step is lr x sign(g) but where g is ~0
        assert abs(mu - ref["moment_norms"][f]) <= 1e-4 * ref["moment_norms"][f], f
        assert abs(change - ref["change_norms"][f]) <= 1e-4 * ref["change_norms"][f], f
    assert new.params.features.shape == (N, D) and new.adam.nu.features.shape == (N, D)
    lr = float(torch.abs(new.params.features - params.features).max())
    assert lr == pytest.approx(HYPER["semantic_feature_lr"], rel=1e-3)  # the field's own rate


def test_train_loop_over_two_chunks_matches_its_steps():
    """Two 10-step chunks of train_loop carry the field and its moments and
    give each step's state bit for bit; the feature-step counter counts one
    joint composite of 3 + D channels a step."""
    dev = torch.device("cpu")
    params, alive, cams, _, teacher = _inputs(dev)
    state = init_train_state(params, alive)
    before = FEATURE_STEPS.snapshot()
    looped, log = train_loop(state, cams, CFG, num_iters=20, steps_per_dispatch=10,
                             shuffle_seed=4, teacher=teacher)
    assert FEATURE_STEPS.since(before) == (20, {3 + D: 20})
    assert log["chunks"] == [(1, 10), (11, 10)]
    st = state
    for j, name in enumerate(log["cameras"]):
        st, mj = train_step(st, cams[int(name)], torch.zeros(3), CFG, 0,
                            teacher=teacher[int(name)])
        assert float(mj["loss"]) == float(log["loss"][j])
    for f in leaf_names(params):
        for a, b in ((looped.params, st.params), (looped.adam.mu, st.adam.mu),
                     (looped.adam.nu, st.adam.nu)):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert not torch.equal(looped.params.features, params.features)


def test_densify_prune_and_growth_carry_feature_rows():
    """A clone and both split children copy their parent's feature row
    (and the Adam moments of the slots they take are zero, the field's
    included); growth pads the field and its moments with zeros."""
    dev = torch.device("cpu")
    arrays = _arrays(n=600, seed=3)
    cap = 1024
    pad = {k: np.concatenate([v, np.zeros((cap - 600,) + v.shape[1:], np.float32)])
           for k, v in arrays.items()}
    pad["opacity_logits"][600:] = -20.0
    pad["features"][:, 0] = np.arange(cap)  # each row names its slot
    faint = np.arange(0, 600, 50)
    pad["opacity_logits"][faint] = -8.0  # opacity below min_opacity: pruned
    params = params_from_numpy(pad, dev)
    alive = torch.arange(cap) < 600
    state = init_train_state(params, alive)
    ones = {f: torch.ones_like(getattr(params, f)) for f in leaf_names(params)}
    state = dataclasses.replace(state, adam=dataclasses.replace(
        state.adam, mu=GaussianParams(**ones), nu=GaussianParams(**ones)))
    rng = np.random.default_rng(5)
    grads = torch.from_numpy(rng.uniform(0, 4e-4, size=cap).astype(np.float32))
    state = dataclasses.replace(state, dstate=dataclasses.replace(
        state.dstate, xyz_grad_accum=grads * alive, denom=alive.float()))
    noise = [torch.from_numpy(rng.normal(size=(cap, 3)).astype(np.float32)) for _ in range(2)]
    new, dropped = densify_step(state, scene_extent=1.5, cfg=CFG, use_screen_size=False,
                                noise=noise)
    src = new.params.features[:, 0].round().long()
    born = new.alive & (src != torch.arange(cap))
    assert int(born.sum()) > 20 and int(dropped) == 0
    for f in ("sh_dc", "sh_rest", "quats", "opacity_logits"):  # copied from the parent
        assert torch.equal(getattr(new.params, f)[born], getattr(params, f)[src[born]]), f
    assert torch.equal(new.params.features[new.alive][:, 1:],
                       params.features[src[new.alive]][:, 1:])
    for f in leaf_names(params):
        assert float(getattr(new.adam.mu, f)[born].abs().max()) == 0.0, f
    split = new.alive & torch.any(new.params.means != params.means[src], 1)
    assert int(split.sum()) > 10  # split children, some in their parent's own slot
    faint = torch.from_numpy(faint)
    assert torch.all(~new.alive[faint] | (src[faint] != faint))  # pruned or taken by a child
    grown = grow_capacity(new)
    assert grown.params.features.shape == (2 * cap, D)
    assert torch.equal(grown.params.features[:cap], new.params.features)
    for t in (grown.params.features, grown.adam.mu.features, grown.adam.nu.features):
        assert float(t[cap:].abs().max()) == 0.0


def test_rgb_only_training_is_unchanged_bit_for_bit():
    """With feature_dim 0 a chunked train_loop on this scene gives the state
    it gave before feature fields existed: the digest below was taken from
    the parent tree's train_loop on the same inputs (CPU, one thread)."""
    dev = torch.device("cpu")
    arrays = {k: v for k, v in _arrays(seed=9).items() if k != "features"}
    params = params_from_numpy(arrays, dev)
    assert params.features is None and leaf_names(params) == FIELDS
    _, alive, cams, _, _ = _inputs(dev)
    cfg = dataclasses.replace(CFG, feature_dim=0)
    state, log = train_loop(init_train_state(params, alive), cams, cfg, num_iters=12,
                            steps_per_dispatch=10, shuffle_seed=2)
    h = hashlib.sha256()
    for tree in (state.params, state.adam.mu, state.adam.nu):
        for f in FIELDS:
            h.update(getattr(tree, f).numpy().tobytes())
    for k in ("xyz_grad_accum", "denom", "max_radii2d"):
        h.update(getattr(state.dstate, k).numpy().tobytes())
    h.update(log["loss"].numpy().tobytes())
    assert h.hexdigest() == RGB_DIGEST


RGB_DIGEST = "9cd1c9865a849232864fe1eed0090044714898347cc043d84ef728d4ec3f0c0b"


def _write_scene(root, rng, views=11):
    """A Blender-layout scene: `views` cameras on an arc looking at the
    origin, noise images (the train CLI fits them), a 400-point cloud, label
    images of views 0 and 10 (eval takes every 10th view) and their TSV."""
    import json

    from PIL import Image

    from semantic_gaussians_torch.cli.view_server import encode_png
    from semantic_gaussians_torch.io.ply import save_point_cloud

    (root / "train").mkdir(parents=True)
    (root / "label-filt").mkdir()
    frames = []
    for i in range(views):
        ang = 0.6 * (i - views / 2) / views
        pos = np.array([4 * np.sin(ang), 0.2 * (-1) ** i, -4 * np.cos(ang)])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        c2w = np.eye(4)
        c2w[:3, :3] = np.stack([right, np.cross(fwd, right), -fwd], axis=1)  # OpenGL axes
        c2w[:3, 3] = pos
        img = rng.integers(0, 256, size=(H, W, 3), dtype=np.uint8)
        (root / "train" / f"r_{i}.png").write_bytes(encode_png(img))
        frames.append({"file_path": f"./train/r_{i}", "transform_matrix": c2w.tolist()})
    (root / "transforms_train.json").write_text(
        json.dumps({"camera_angle_x": 1.0, "frames": frames}))
    pts = (rng.normal(size=(400, 3)) * [1.0, 0.6, 0.6]).astype(np.float32)
    save_point_cloud(root / "points3d.ply", pts, rng.uniform(size=(400, 3)), np.zeros_like(pts))
    rows = ["id\traw_category\tscannetid\tcocomapid"] + [f"{i + 1}\tc{i}\t{i}\t{i}"
                                                         for i in range(20)]
    (root / "scannetv2-labels.modified.tsv").write_text("\n".join(rows) + "\n")
    for i in (0, 10):
        raw = np.repeat(np.repeat(rng.integers(1, 22, size=(H // 8, W // 8)), 8, 0), 8, 1)
        Image.fromarray(raw.astype(np.uint8)).save(root / "label-filt" / f"r_{i}.png")


def _cli_round_trip(tmp_path, dim, device):
    """The train CLI with model.feature_dim trains a field from per-view
    teacher maps, writes it beside the PLY in fusion's {feat, mask_full}
    layout, and the eval CLI (mode 2d) renders it as fused features."""
    from semantic_gaussians_torch.cli import eval_segmentation as eval_cli
    from semantic_gaussians_torch.cli.train import main as train_main
    from semantic_gaussians_torch.config.config import default_config_dir
    from semantic_gaussians_torch.io.ply import load_gaussian_ply
    from semantic_gaussians_torch.pipelines.fusion import load_fused_features

    rng = np.random.default_rng(11)
    scene = tmp_path / "toy_scene"
    _write_scene(scene, rng)
    maps = tmp_path / "lseg"
    maps.mkdir()
    for i in range(11):
        f = rng.normal(size=(H, W, dim))
        np.save(maps / f"r_{i}.npy", (f / np.linalg.norm(f, axis=-1, keepdims=True))
                .astype(np.float16))
    out = tmp_path / "model"
    summary = train_main([
        str(default_config_dir() / "official_train.yaml"), "--device", device,
        f"scene.scene_path={scene}", f"train.out_dir={out}", "train.iterations=12",
        "train.test_iterations=[]", "train.save_iterations=[12]", f"model.feature_dim={dim}",
        f"train.feature_dir={maps}", "train.densify_from_iter=100", "scene.test_cameras=false"])
    state = summary["state"]
    assert state.params.features.shape[1] == dim
    assert float(state.params.features.abs().max()) > 0  # trained from its zero start
    feats_dir = out / "point_cloud" / "iteration_12" / "features"
    assert summary["features"] == [feats_dir / "toy_scene" / "0.pt"]
    arrays, alive = load_gaussian_ply(out / "point_cloud" / "iteration_12" / "point_cloud.ply")
    feats, mask = load_fused_features(feats_dir / "toy_scene" / "0.pt", capacity=len(alive))
    assert torch.equal(mask, torch.from_numpy(alive))
    want = state.params.features[state.alive].half().float().cpu()
    assert torch.equal(feats[: int(alive.sum())], want)  # the PLY's rows, in its order
    miou, macc, conf = eval_cli.main([
        str(default_config_dir() / "eval.yaml"), "--device", device,
        f"scene.scene_path={scene}", f"model.model_dir={out}", f"fusion.out_dir={feats_dir}",
        f"fusion.embedding_dim={dim}", "eval.eval_mode=2d", f"eval.width={W}",
        f"eval.height={H}", f"eval.log_file={tmp_path / 'eval.log'}"])
    assert conf.shape == (20, 21) and conf.sum() > 0
    assert 0 <= miou <= 1 and 0 <= macc <= 1
    return summary


def test_saved_features_load_and_render_in_eval_2d(tmp_path):
    _cli_round_trip(tmp_path, 8, "cpu")


@pytest.mark.card
def test_the_train_cli_trains_a_512_channel_field_on_the_card(tmp_path):
    """The CLI round trip on CUDA at LSeg's width: the steps replay graphs
    (the 10-step chunk, then a 2-step one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    summary = _cli_round_trip(tmp_path, 512, "cuda")
    assert summary["logs"][0]["graphs"]["replays"] == 2


@pytest.mark.card
def test_the_feature_path_on_the_card():
    """The joint render and every gradient on CUDA (the composite's walk and
    contraction at C = 43, its two backward passes, the wide segment sum)
    against the reference on CUDA; train_loop's 10-step replays against its
    single steps (one-step graphs, with a field), bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda:0")
    fwd, bwd = composite.LAUNCHES.snapshot(), composite.BWD_LAUNCHES.snapshot()
    _check_joint(dev)
    gained = {w: n for w, n in composite.LAUNCHES.since(fwd)[1].items() if n}
    assert gained == {3 + D: 2}  # one composite: walk + contraction
    assert composite.BWD_LAUNCHES.since(bwd)[0] == 2
    params, alive, cams, _, teacher = _inputs(dev)
    state = init_train_state(params, alive)
    graphed, log = train_loop(state, cams, CFG, num_iters=20, steps_per_dispatch=10,
                              shuffle_seed=4, teacher=teacher)
    single, log1 = train_loop(state, cams, CFG, num_iters=20, steps_per_dispatch=1,
                              shuffle_seed=4, teacher=teacher)
    assert log["graphs"]["captures"] == 1 and log["graphs"]["replays"] == 2
    assert log1["graphs"]["captures"] == 1 and log1["graphs"]["replays"] == 20
    assert torch.equal(log["loss"], log1["loss"])
    for f in leaf_names(params):
        assert torch.equal(getattr(graphed.params, f), getattr(single.params, f)), f
