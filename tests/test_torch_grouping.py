"""Gaussian Grouping on the port (a 16-channel identity field, its
256-class classifier and the 3D KNN term, trained jointly with RGB)
against the plain reference, benchmark/reference/grouping_train_step.py,
on seeded random Gaussians: ~2,000 of them, 64x48 views, D = 16 and 256
classes; the 3D term over 1,500 candidates and 300 samples, so that the
candidates are a subset. The `card` tests run the same on CUDA; this file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_grouping.py
"""
import dataclasses

import numpy as np
import pytest
import torch
from test_torch_feature_field import _write_scene

from benchmark.reference import grouping_train_step as RG
from benchmark.reference import render as R
from benchmark.scenes.common import look_pose
from semantic_gaussians_torch.core.gaussians import (
    FEATURES,
    GaussianParams,
    leaf_names,
    params_from_numpy,
    tree_leaves,
)
from semantic_gaussians_torch.core.grouping import (
    CLASSIFIER_LR,
    Classifier,
    GroupingConfig,
    identity_loss,
    init_classifier,
    reg3d_draws,
    reg3d_loss,
)
from semantic_gaussians_torch.core.optimizer import ADAM, TrainHyper
from semantic_gaussians_torch.ops import composite
from semantic_gaussians_torch.ops.knn import knn_indices
from semantic_gaussians_torch.pipelines.train import (
    GROUPING_STEPS,
    TrainConfig,
    adam_step,
    densify_step,
    grow_capacity,
    init_train_state,
    train_loop,
    train_state_from_numpy,
    train_state_to_numpy,
    train_step,
)
from semantic_gaussians_torch.renderer import render
from semantic_gaussians_torch.utils.camera import make_camera_from_c2w
from semantic_gaussians_torch.utils.losses import photometric_loss

torch.set_num_threads(1)  # one torch thread a test worker, as the port's other tests
W, H, D, N, C = 64, 48, 16, 2000, 256
FOV_X, FOV_Y = 1.2, 0.9
HYPER = dict(position_lr_init=0.00016, position_lr_final=0.0000016, position_lr_delay_mult=0.01,
             position_lr_max_steps=10000, feature_lr=0.0025, opacity_lr=0.05,
             scaling_lr=0.005, rotation_lr=0.001, semantic_feature_lr=0.0025)
GROUP = GroupingConfig(reg3d_max_points=1500, reg3d_sample=300, seed=7)
CFG = TrainConfig(hyper=TrainHyper(**HYPER), densify_from_iter=10_000, feature_dim=D,
                  grouping=GROUP)
REF_HYPER = dict(HYPER, lambda_dssim=CFG.lambda_dssim)
LATE = 16000  # the state's step: the position's rate is at its final value


def _poses(views):
    return [look_pose(np.array([0.3 * (i - views / 2), 0.0, 0.1 * (-1) ** i]),
                      np.array([0.05 * (views / 2 - i), 1.0, 0.0])) for i in range(views)]


def _arrays(n=N, seed=0):
    """Flat, anisotropic splats about 4 units in front of the cameras (along
    +y; z is up), with N(0, 1) identity rows."""
    rng = np.random.default_rng(seed)
    return dict(
        means=(rng.normal(size=(n, 3)) * [1.2, 0.6, 0.8] + [0, 4, 0]).astype(np.float32),
        sh_dc=rng.normal(size=(n, 1, 3)).astype(np.float32) * 0.8,
        sh_rest=(rng.normal(size=(n, 15, 3)) * 0.05).astype(np.float32),
        log_scales=(rng.uniform(-3.6, -2.0, size=(n, 3)) - [0, 0, 1.0]).astype(np.float32),
        quats=rng.normal(size=(n, 4)).astype(np.float32),
        opacity_logits=rng.uniform(-2.0, 3.0, size=(n, 1)).astype(np.float32),
        features=rng.normal(size=(n, D)).astype(np.float32),
    )


def _inputs(dev, views=4, seed=0):
    """(params with an identity field, alive, classifier, port cameras,
    reference cameras, object maps [V, H, W] uint8) on `dev`."""
    rng = np.random.default_rng(seed + 100)
    poses = _poses(views)
    params = params_from_numpy(_arrays(seed=seed), dev)
    alive = torch.ones(N, dtype=torch.bool, device=dev)
    images = rng.uniform(0.05, 0.95, size=(views, H, W, 3)).astype(np.float32)
    cams = [make_camera_from_c2w(p, FOV_X, FOV_Y, W, H, image=images[i], image_name=str(i),
                                 device=dev) for i, p in enumerate(poses)]
    refs = [R.camera(p, FOV_X, FOV_Y, W, H, dev) for p in poses]
    ids = torch.from_numpy(rng.integers(0, 40, size=(views, H, W)).astype(np.uint8)).to(dev)
    classifier = init_classifier(C, D, torch.Generator().manual_seed(seed + 5), dev)
    return params, alive, classifier, cams, refs, ids


def _ref_params(params, classifier):
    out = {f: getattr(params, f).detach().clone() for f in leaf_names(params)}
    out.update({f"classifier.{f}": getattr(classifier, f).detach().clone()
                for f in ("weight", "bias")})
    return out


def _gap(a, b):
    """The norm of the difference over the norm of the reference."""
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-30))


def _check_terms(dev):
    """The joint render, L_2d, L_3d (iteration LATE + 2, which adds it) and
    every gradient, the classifier's included, against the reference."""
    params, alive, classifier, cams, refs, ids = _inputs(dev)
    names = leaf_names(params)
    leaves = {f: getattr(params, f).detach().requires_grad_(True) for f in names}
    cls = Classifier(*(x.detach().requires_grad_(True) for x in (classifier.weight,
                                                                 classifier.bias)))
    step = torch.full((), LATE + 1, dtype=torch.int32, device=dev)
    out = render(cams[0], GaussianParams(**leaves), alive, bg=torch.zeros(3, device=dev),
                 active_sh_degree=3, features=leaves[FEATURES])
    photo = photometric_loss(out["render"], cams[0].image, CFG.lambda_dssim)
    l2d = identity_loss(out["feature"], ids[0], cls)
    l3d, near = reg3d_loss(leaves[FEATURES], cls, params.means, alive, step, GROUP)
    loss = photo + l2d + l3d
    grads = torch.autograd.grad(loss, [leaves[f] for f in names] + [cls.weight, cls.bias])
    ref = {f: v.requires_grad_(True) for f, v in _ref_params(params, classifier).items()}
    rgb, ident = RG.render_joint(ref, refs[0], 3, torch.zeros(3, device=dev))
    w, b = ref["classifier.weight"], ref["classifier.bias"]
    ref_l2d = RG.loss_2d(ident, ids[0], w, b)
    ref_l3d, ref_near = RG.loss_3d(ref["features"], w, b, ref["means"], alive, LATE + 2,
                                   dataclasses.asdict(GROUP))
    ref_loss = RG.RT.photometric_loss(rgb, cams[0].image, CFG.lambda_dssim) + ref_l2d + ref_l3d
    ref_grads = torch.autograd.grad(ref_loss, list(ref.values()))
    assert out["render"].shape == (H, W, 3) and out["feature"].shape == (H, W, D)
    # float32 both; the port steps T by products, the reference by a cumprod
    assert float((out["feature"] - ident).detach().abs().max()) < 1e-5
    assert float(ident.detach().abs().max()) > 0.1  # the field is drawn
    for a, r in ((l2d, ref_l2d), (l3d, ref_l3d), (loss, ref_loss)):
        a, r = float(a.detach()), float(r.detach())
        assert abs(a - r) <= 1e-5 * abs(r), (a, r)
    assert float(l3d.detach()) > 0
    assert near.shape == (GROUP.reg3d_sample, GROUP.reg3d_k) and torch.equal(near, ref_near)
    # every leaf's gradient to float32 round-off of sums in other orders
    for f, g, rg in zip(list(ref), grads, ref_grads):
        assert float(torch.linalg.vector_norm(rg)) > 0, f
        assert _gap(g, rg) < 1e-4, (f, _gap(g, rg))
    return near


def test_the_joint_render_both_terms_and_every_gradient_match_the_reference():
    _check_terms(torch.device("cpu"))


def test_the_draws_match_the_reference_exactly_and_are_subsets_of_the_alive_rows():
    """Candidates and samples, drawn from the hash of (seed, iteration,
    row) on the device, are the reference's rows bit for bit; they are
    distinct alive rows, other at every iteration; with fewer alive rows
    than candidates every alive row is one and the rest are marked."""
    gen = torch.Generator().manual_seed(3)
    alive = torch.rand(5000, generator=gen) < 0.7
    cfg = dataclasses.asdict(GROUP)
    seen = []
    for it in (LATE + 2, LATE + 4):
        cand, cand_ok, samp, samp_ok = reg3d_draws(GROUP, torch.tensor(it - 1), alive)
        ref = RG.draws(cfg, it, alive)
        for a, b in zip((cand, cand_ok, samp, samp_ok), ref):
            assert torch.equal(a, b)
        assert cand.shape == (GROUP.reg3d_max_points,) and bool(cand_ok.all())
        assert bool(alive[cand].all()) and cand.unique().numel() == cand.numel()
        assert samp.shape == (GROUP.reg3d_sample,) and samp.unique().numel() == samp.numel()
        seen.append(cand)
    assert not torch.equal(seen[0], seen[1])
    few = torch.arange(5000) < 1200  # fewer alive rows than candidates
    cand, cand_ok, samp, samp_ok = reg3d_draws(GROUP, torch.tensor(LATE), few)
    assert int(cand_ok.sum()) == 1200 and torch.equal(cand[cand_ok].sort().values,
                                                      torch.arange(1200))
    assert bool(samp_ok.all()) and bool(cand_ok[samp].all())
    for a, b in zip((cand, cand_ok, samp, samp_ok), RG.draws(cfg, LATE + 1, few)):
        assert torch.equal(a, b)


def test_neighbour_indices_match_the_reference_with_ties_to_the_lower_index():
    """knn_indices against the reference's full stable sort, on points with
    exact duplicates (ties) and points at infinity (invalid candidates)."""
    gen = torch.Generator().manual_seed(4)
    pts = torch.randn((3000, 3), generator=gen)
    pts[1000:1300] = pts[:300]  # each of these points twice
    pts[2000:2100] = pts[:100]  # and these three times
    pts[2900:] = float("inf")
    q = pts[torch.randperm(2900, generator=gen)[:400]]
    for k in (1, 5, 9):
        got = knn_indices(q, pts, k)
        assert torch.equal(got, RG.neighbours(q, pts, k)), k
        d2 = ((q[:, None] - pts[None]) ** 2).sum(-1)
        assert bool((d2.gather(1, got) < float("inf")).all())
    got = knn_indices(q, pts, 5)
    assert bool((got[:, 0] <= got[:, 1])[pts[got[:, 0]].eq(pts[got[:, 1]]).all(1)].all())


def test_one_adam_step_matches_the_reference():
    """train_step with the 3D term (the render, both terms, Adam with the
    field's rate and the classifier's own rate and eps 1e-8) against the
    reference's step from the same inputs: the loss, the neighbours, Adam's
    first moment and the parameters' change, by leaf."""
    dev = torch.device("cpu")
    params, alive, classifier, cams, refs, ids = _inputs(dev)
    state = init_train_state(params, alive, classifier)
    state = dataclasses.replace(state, step=torch.full((), LATE + 1, dtype=torch.int32))
    new, m = train_step(state, cams[1], torch.zeros(3), CFG, 3, object_ids=ids[1], reg3d=True)
    ref = RG.follow(_ref_params(params, classifier), [refs[1]], [cams[1].image], [ids[1]],
                    REF_HYPER, dataclasses.asdict(GROUP), CFG.spatial_lr_scale, LATE + 2, 3)
    assert abs(float(m["loss"]) - ref["losses"][0]) <= 1e-5 * ref["losses"][0]
    assert torch.equal(m["knn"], ref["knn"][0])
    mine = dict(tree_leaves(new.adam.mu), **tree_leaves(new.classifier.mu, "classifier."))
    after = dict(tree_leaves(new.params), **tree_leaves(new.classifier.params, "classifier."))
    before = _ref_params(params, classifier)
    for f in before:
        mu = float(torch.linalg.vector_norm(mine[f].double()))
        change = float(torch.linalg.vector_norm(after[f].double() - before[f].double()))
        # the moment is 0.1 x the gradient (round-off as above); the change
        # of a first Adam step is lr x sign(g) but where g is ~0
        assert abs(mu - ref["moment_norms"][f]) <= 1e-4 * ref["moment_norms"][f], f
        assert abs(change - ref["change_norms"][f]) <= 1e-4 * ref["change_norms"][f], f
    # each group's own rate: the first step moves an entry by ~lr where |g| >> eps
    step_w = (new.classifier.params.weight - classifier.weight).abs().max()
    assert float(step_w) == pytest.approx(CLASSIFIER_LR, rel=1e-3)
    step_f = (new.params.features - params.features).abs().max()
    assert float(step_f) == pytest.approx(HYPER["semantic_feature_lr"], rel=1e-3)


def test_the_classifier_s_eps_is_its_own():
    """A classifier gradient of ~1e-9 moves the classifier by lr g / (|g| +
    1e-8), a tenth of its rate, while the Gaussians' leaves, at eps 1e-15,
    move by their full rate: each leaf steps at its own eps."""
    from semantic_gaussians_torch.core.optimizer import lr_tree

    params, _, classifier, *_ = _inputs(torch.device("cpu"))
    grads = GaussianParams(**{f: torch.full_like(getattr(params, f), 1e-9)
                              for f in leaf_names(params)})
    cg = tuple(torch.full_like(x, 1e-9) for x in (classifier.weight, classifier.bias))
    state = init_train_state(params, torch.ones(params.capacity, dtype=torch.bool), classifier)
    lrs = lr_tree(CFG.hyper, 1.0, torch.tensor(LATE), features=True)
    new, _, cls = adam_step(state, grads, cg, lrs, CFG.hyper)
    moved = float((classifier.weight - cls.params.weight).max())
    assert moved == pytest.approx(CLASSIFIER_LR * 1e-9 / (1e-9 + 1e-8), rel=1e-4)
    assert float((params.features - new.features).max()) == pytest.approx(
        HYPER["semantic_feature_lr"], rel=1e-4)


def _steps_of(state, cams, ids, log, first):
    """The chunks' steps again, one train_step at a time."""
    st = state
    for j, name in enumerate(log["cameras"]):
        it = first + j
        st, mj = train_step(st, cams[int(name)], torch.zeros(3), CFG, min(3, it // 1000),
                            object_ids=ids[int(name)], reg3d=GROUP.reg3d_at(it))
        assert float(mj["loss"]) == float(log["loss"][j]), it
    return st, mj


def test_train_loop_chunks_of_either_parity_match_their_steps():
    """Iterations 981-1002 run as chunks of 10 (odd start), 9 (odd start),
    1 (iteration 1000, which adds the 3D term) and 2: the loop carries the
    field, the classifier and both sets of moments and gives each step's
    state bit for bit; the counter counts the identity term every step and
    the 3D term on the even iterations; the log keeps the last chunk's
    neighbours."""
    dev = torch.device("cpu")
    params, alive, classifier, cams, _, ids = _inputs(dev)
    state = init_train_state(params, alive, classifier)
    state = dataclasses.replace(state, step=torch.full((), 980, dtype=torch.int32))
    before = GROUPING_STEPS.snapshot()
    looped, log = train_loop(state, cams, CFG, num_iters=22, iter_offset=980,
                             steps_per_dispatch=10, shuffle_seed=4, object_ids=ids)
    assert log["chunks"] == [(981, 10), (991, 9), (1000, 1), (1001, 2)]
    assert GROUPING_STEPS.since(before) == (33, {"identity": 22, "reg3d": 11})
    st, last = _steps_of(state, cams, ids, log, 981)
    got, want = tree_leaves(looped), tree_leaves(st)
    assert list(got) == list(want) and "classifier.nu.weight" in got
    for k, x in want.items():
        assert torch.equal(got[k], x), k
    assert log["knn"].shape == (2, GROUP.reg3d_sample, GROUP.reg3d_k)
    assert bool((log["knn"][0] == -1).all()) and torch.equal(log["knn"][1], last["knn"])
    assert not torch.equal(looped.classifier.params.weight, classifier.weight)


def test_the_loop_asks_for_one_object_map_a_camera():
    params, alive, classifier, cams, _, ids = _inputs(torch.device("cpu"))
    state = init_train_state(params, alive, classifier)
    with pytest.raises(ValueError, match="one object map a camera"):
        train_loop(state, cams, CFG, num_iters=1, object_ids=ids[:2])
    with pytest.raises(ValueError, match="needs a classifier"):
        train_step(init_train_state(params, alive), cams[0], torch.zeros(3), CFG, 3,
                   object_ids=ids[0])


def test_densify_prune_and_growth_carry_identity_rows_and_leave_the_classifier():
    """At capacity 256, as wide as the classifier has classes: a clone and
    both split children copy their parent's identity row, their moments
    are zero; growth pads the field and its moments; the classifier and its
    moments come through both as the very tensors they were."""
    dev = torch.device("cpu")
    arrays = _arrays(n=150, seed=3)
    cap = 256
    pad = {k: np.concatenate([v, np.zeros((cap - 150,) + v.shape[1:], np.float32)])
           for k, v in arrays.items()}
    pad["opacity_logits"][150:] = -20.0
    pad["features"][:, 0] = np.arange(cap)  # each row names its slot
    pad["opacity_logits"][np.arange(0, 150, 30)] = -8.0  # pruned
    params = params_from_numpy(pad, dev)
    alive = torch.arange(cap) < 150
    classifier = init_classifier(C, D, torch.Generator().manual_seed(1), dev)
    state = init_train_state(params, alive, classifier)
    assert state.classifier.params.weight.shape[0] == cap
    rng = np.random.default_rng(5)
    grads = torch.from_numpy(rng.uniform(0, 4e-4, size=cap).astype(np.float32))
    state = dataclasses.replace(state, dstate=dataclasses.replace(
        state.dstate, xyz_grad_accum=grads * alive, denom=alive.float()))
    noise = [torch.from_numpy(rng.normal(size=(cap, 3)).astype(np.float32)) for _ in range(2)]
    new, dropped = densify_step(state, scene_extent=1.5, cfg=CFG, use_screen_size=False,
                                noise=noise)
    src = new.params.features[:, 0].round().long()
    born = new.alive & (src != torch.arange(cap))
    assert int(born.sum()) > 10 and int(dropped) == 0
    assert torch.equal(new.params.features[new.alive][:, 1:],
                       params.features[src[new.alive]][:, 1:])
    assert float(new.adam.mu.features[born].abs().max()) == 0.0
    grown = grow_capacity(new)
    assert grown.params.features.shape == (2 * cap, D)
    for t in (grown.params.features, grown.adam.mu.features, grown.adam.nu.features):
        assert float(t[cap:].abs().max()) == 0.0
    for after in (new, grown):
        for k, x in tree_leaves(state.classifier, "classifier.").items():
            assert tree_leaves(after)[k] is x, k
    nested = train_state_to_numpy(grown)
    assert set(nested["classifier"]) == {"params", "mu", "nu"}
    back = tree_leaves(train_state_from_numpy(nested, "cpu"))
    for k, x in tree_leaves(grown).items():
        assert torch.equal(back[k], x), k


def test_train_loop_densifies_and_grows_with_the_identity_field():
    """A train_loop whose densify fills capacity 256 and grows it: the
    classifier keeps its [256, 16], the field and its moments grow with the
    Gaussians, and the 3D term keeps running."""
    params, alive, classifier, cams, _, ids = _inputs(torch.device("cpu"))
    keep = {k: v[:256] for k, v in tree_leaves(params).items()}
    params = GaussianParams(**keep)
    cfg = dataclasses.replace(CFG, densify_from_iter=5, densification_interval=10,
                              densify=dataclasses.replace(CFG.densify, grad_threshold=1e-9))
    state = init_train_state(params, torch.arange(256) < 200, classifier)
    looped, log = train_loop(state, cams, cfg, num_iters=20, steps_per_dispatch=10,
                             object_ids=ids)
    assert [d[0] for d in log["densify"]] == [10, 20] and looped.params.capacity > 256
    assert looped.classifier.params.weight.shape == (C, D)
    assert looped.adam.nu.features.shape == (looped.params.capacity, D)
    assert bool(torch.isfinite(log["loss"]).all()) and int((log["knn"][-1] >= 0).sum()) > 0


def _write_objects(root, views=11):
    """Object maps of the toy scene's training views: 8-bit ids in blocks."""
    from PIL import Image

    rng = np.random.default_rng(12)
    root.mkdir()
    for i in range(views):
        ids = np.repeat(np.repeat(rng.integers(0, 30, size=(H // 8, W // 8)), 8, 0), 8, 1)
        Image.fromarray(ids.astype(np.uint8)).save(root / f"r_{i}.png")


def _cli(tmp_path, device):
    """The train CLI with model.num_objects trains the identity field and
    the classifier from per-view object maps and writes both beside the PLY."""
    from semantic_gaussians_torch.cli.train import main as train_main
    from semantic_gaussians_torch.config.config import default_config_dir

    scene = tmp_path / "toy_scene"
    _write_scene(scene, np.random.default_rng(11))
    _write_objects(tmp_path / "object_mask")
    out = tmp_path / "model"
    summary = train_main([
        str(default_config_dir() / "official_train.yaml"), "--device", device,
        f"scene.scene_path={scene}", f"train.out_dir={out}", "train.iterations=12",
        "train.test_iterations=[]", "train.save_iterations=[12]", f"model.num_objects={D}",
        f"train.object_dir={tmp_path / 'object_mask'}", "train.densify_from_iter=100",
        "train.reg3d_max_points=200", "train.reg3d_sample=50", "scene.test_cameras=false"])
    state = summary["state"]
    assert state.params.features.shape[1] == D and state.classifier is not None
    assert summary["logs"][0]["knn"].shape[1:] == (50, 5)
    it = out / "point_cloud" / "iteration_12"
    cls = torch.load(it / "classifier.pt")
    assert cls["weight"].shape == (C, D) and cls["bias"].shape == (C,)
    assert torch.equal(cls["weight"], state.classifier.params.weight.cpu())
    ident = torch.load(it / "identity.pt")["identity"]
    assert torch.equal(ident, state.params.features[state.alive].cpu())
    assert float(state.classifier.mu.weight.abs().max()) > 0  # trained
    return summary


def test_the_train_cli_trains_gaussian_grouping(tmp_path):
    _cli(tmp_path, "cpu")


@pytest.mark.card
def test_gaussian_grouping_on_the_card(tmp_path):
    """Both terms and every gradient on CUDA against the reference on CUDA
    (neighbours equal); train_loop's 10-step replays against its eager
    single steps, bit for bit; a 10-step replay counts 10 identity and 5
    3D steps and 10 Adam launches (the capture's warm-up counts the steps
    it ran eagerly); the CLI on CUDA."""
    from semantic_gaussians_torch.utils.graphs import GraphRunner

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda:0")
    fwd, bwd = composite.LAUNCHES.snapshot(), composite.BWD_LAUNCHES.snapshot()
    _check_terms(dev)
    assert {w: n for w, n in composite.LAUNCHES.since(fwd)[1].items() if n} == {3 + D: 1}
    assert {w: n for w, n in composite.BWD_LAUNCHES.since(bwd)[1].items() if n} == {3 + D: 1}
    params, alive, classifier, cams, _, ids = _inputs(dev)
    state = init_train_state(params, alive, classifier)
    state = dataclasses.replace(state, step=torch.full((), LATE, dtype=torch.int32, device=dev))
    runner = GraphRunner(dev)
    graphed, log = train_loop(state, cams, CFG, num_iters=20, iter_offset=LATE,
                              steps_per_dispatch=10, shuffle_seed=4, object_ids=ids,
                              runner=runner)
    single, log1 = train_loop(state, cams, CFG, num_iters=20, iter_offset=LATE,
                              steps_per_dispatch=1, shuffle_seed=4, object_ids=ids)
    assert log["graphs"]["captures"] == 1 and log["graphs"]["replays"] == 2
    assert log1["graphs"]["captures"] == 0
    assert torch.equal(log["loss"], log1["loss"]) and torch.equal(log["knn"][-1:], log1["knn"])
    got, want = tree_leaves(graphed), tree_leaves(single)
    for k, x in want.items():
        assert torch.equal(got[k], x), k
    counts, adam = GROUPING_STEPS.snapshot(), ADAM.snapshot()
    _, log2 = train_loop(graphed, cams, CFG, num_iters=10, iter_offset=LATE + 20,
                         steps_per_dispatch=10, shuffle_seed=5, object_ids=ids, runner=runner)
    assert log2["graphs"]["captures"] == 1 and log2["graphs"]["replays"] == 3  # the runner's
    assert GROUPING_STEPS.since(counts) == (15, {"identity": 10, "reg3d": 5})
    assert ADAM.since(adam)[0] == 10
    assert _cli(tmp_path, "cuda")["logs"][0]["graphs"]["replays"] == 2
