"""Traffic driver `train_feature`: the late phase of Feature 3DGS training.

As the `train` driver (traffic/train.py), on a configuration with a
`feature_dim`: besides the scene law's Gaussians and colour images, the
seed draws each Gaussian's feature (features.feature_field) and each
training view's 2D teacher map (features.teacher_maps, float16, held on
the card for the whole run, as the train CLI holds them). Every step
renders RGB and the D-channel field in one composite and adds the feature
L1 to the loss (pipelines/train.py), through `train_loop` with one
`GraphRunner`, in calls of `call_iters` at the configuration's pinned pair
budget.

1. Check chunk: the state's first call, one 10-step replay; each step's
   loss, and after it Adam's first moment and the parameters' change by
   leaf, the feature field among the leaves.
2. Warm-up: a call across a multiple of 1000 (its 9-step chunk and eager
   step included) captures every graph the window replays; a second one is
   timed to size the window.
3. Window: consecutive calls; `train_step_ms` is their wall over their
   iterations. The feature-step counter and the composite's launches by
   channel width are noted (one composite at 3 + D channels a step).
4. Check: the Feature 3DGS reference (reference/feature_train_step.py)
   follows the check chunk's ten steps from the inputs made again.

With `--trace 1` traced calls of `trace_iters` take the window's place and
the work of their steps is counted from the initial scene, view by view.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.common import checks as C
from benchmark.common.trace import profiled
from benchmark.reference import feature_train_step as RF
from benchmark.reference import render as R
from benchmark.scenes.common import scene_extent, target_images
from benchmark.scenes.features import feature_field, teacher_maps
from benchmark.traffic.train import CHECK_STEPS, _drift, _law, _layer_counts, loop_views

FEATURE_SEED = 1 << 40  # added to the scene's and the images' seeds


def _norm(a: torch.Tensor, b=None, rows: int = 1 << 16) -> float:
    """The float64 norm of `a` (or of a - b), a block of rows at a time: a
    float64 copy of the field alone is 4 GB."""
    total = 0.0
    for i in range(0, a.shape[0], rows):
        x = a[i:i + rows].double()
        if b is not None:
            x -= b[i:i + rows].double()
        total += float(torch.sum(x * x))
    return total ** 0.5


def _leaf_norms(tree, names) -> Dict[str, float]:
    return {f: _norm(getattr(tree, f)) for f in names}


def inputs(cfg, seed: int, dev, which=None):
    """(Gaussians with their features, teacher maps of the views `which`),
    made from the seed."""
    arrays = _law(cfg).scene(cfg, 2 * seed, dev)
    n, dim = arrays["means"].shape[0], int(cfg["feature_dim"])
    arrays["features"] = feature_field(n, dim, 2 * seed + FEATURE_SEED, dev)
    views = int(cfg["views"])
    teacher = teacher_maps(views, int(cfg["height"]), int(cfg["width"]), dim,
                           2 * seed + 1 + FEATURE_SEED, dev, which=which)
    return arrays, teacher


def _fresh(state):
    """`state` with Adam's zero moments as broadcast views of one zero: the
    first call copies its carry into the graphs' buffers and warms up while
    it holds the state handed in, so real zeros (4.6 GB at 1M and D = 512)
    would count twice there (where the card's memory peaks)."""
    from semantic_gaussians_torch.core.gaussians import GaussianParams, leaf_names

    def zeros(p):
        return GaussianParams(**{f: torch.zeros((), device=p.device).expand_as(getattr(p, f))
                                 for f in leaf_names(p)})

    adam = dataclasses.replace(state.adam, mu=zeros(state.params), nu=zeros(state.params))
    return dataclasses.replace(state, adam=adam)


def _counts():
    from semantic_gaussians_torch.ops import composite
    from semantic_gaussians_torch.pipelines.train import FEATURE_STEPS

    return dict(feature_steps=FEATURE_STEPS.snapshot(), fwd=composite.LAUNCHES.snapshot(),
                bwd=composite.BWD_LAUNCHES.snapshot())


def _gained(before: Dict, after: Dict) -> Dict:
    """Steps with a feature field by channels composited, and the
    composite's launches (forward by width) over the same calls."""
    gain = {k: (after[k][0] - before[k][0],
                {w: n - before[k][1].get(w, 0) for w, n in after[k][1].items()
                 if n != before[k][1].get(w, 0)}) for k in after}
    return dict(feature_steps_by_channels=gain["feature_steps"][1],
                composite_fwd_launches_by_channels=gain["fwd"][1],
                composite_bwd_launches=gain["bwd"][0])


def run(ctx) -> Dict:
    from semantic_gaussians_torch.core.gaussians import FIELDS, GaussianParams, leaf_names
    from semantic_gaussians_torch.core.optimizer import TrainHyper
    from semantic_gaussians_torch.pipelines.train import TrainConfig, init_train_state, train_loop
    from semantic_gaussians_torch.utils.camera import make_camera_from_c2w
    from semantic_gaussians_torch.utils.graphs import GraphRunner

    cfg, wl, dev = ctx.config, ctx.workload, ctx.device
    tr = cfg["train"]
    dim = int(cfg["feature_dim"])
    tcfg_kw = dict(
        hyper=TrainHyper(**{k: tr[k] for k in (
            "position_lr_init", "position_lr_final", "position_lr_delay_mult",
            "position_lr_max_steps", "feature_lr", "opacity_lr", "scaling_lr", "rotation_lr",
            "semantic_feature_lr")}),
        lambda_dssim=tr["lambda_dssim"], densify_until_iter=tr["densify_until_iter"],
        max_sh_degree=int(cfg["sh_degree"]), white_background=tr["white_background"],
        feature_dim=dim, lambda_feature=tr["lambda_feature"])
    ctx.mark("imports")
    law = _law(cfg)
    poses = law.train_poses(cfg)
    views = len(poses)
    w, h = int(cfg["width"]), int(cfg["height"])
    extent = scene_extent(poses)
    tcfg = TrainConfig(spatial_lr_scale=extent, **tcfg_kw)
    arrays, teacher = inputs(cfg, ctx.seed, dev)
    images = target_images(views, h, w, 2 * ctx.seed + 1, dev)
    cams = [make_camera_from_c2w(p, cfg["fov_x"], cfg["fov_y"], w, h, image=images[i],
                                 image_name=str(i), device=dev) for i, p in enumerate(poses)]
    del images
    # the arrays themselves: a call leaves the state it is handed as it was
    params = GaussianParams(**{f: arrays[f] for f in FIELDS}, features=arrays["features"])
    names = leaf_names(params)
    alive = torch.ones(params.capacity, dtype=torch.bool, device=dev)
    state = _fresh(init_train_state(params, alive))
    check_offset = int(wl["check_offset"])
    state = dataclasses.replace(state, step=torch.full((), check_offset, dtype=torch.int32,
                                                       device=dev))
    del params
    runner = GraphRunner(dev)
    loop = dict(cameras=cams, cfg=tcfg, scene_extent=extent, pair_budget=tr["pair_budget"],
                steps_per_dispatch=int(tr["steps_per_dispatch"]), runner=runner,
                teacher=teacher)
    call_iters = int(wl["call_iters"])

    def calls(state, first: int, count: int, shuffle: int):
        logs = []
        for i in range(count):
            state, log = train_loop(state, num_iters=call_iters, iter_offset=first + i * call_iters,
                                    shuffle_seed=shuffle + i, **loop)
            logs.append(log)
        return state, logs

    ctx.sync()
    ctx.mark("scene")

    # 1. the check chunk: the state's first call, one replay of the 10-step graph
    state, log = train_loop(state, num_iters=CHECK_STEPS, iter_offset=check_offset,
                            shuffle_seed=ctx.seed, **loop)
    assert log["chunks"] == [(check_offset + 1, CHECK_STEPS)], log["chunks"]
    check_views = [int(c) for c in log["cameras"]]
    assert check_views == loop_views(ctx.seed, views, CHECK_STEPS), check_views
    check_losses = [float(x) for x in log["loss"].cpu()]
    moment = _leaf_norms(state.adam.mu, names)
    change = {f: _norm(getattr(state.params, f), arrays[f]) for f in names}
    del arrays
    ctx.mark("check_chunk")

    # 2. warm-up: capture every graph the window can replay, then time a call alike
    warm = int(wl["warmup_offset"])
    state, _ = calls(state, warm, 1, ctx.seed + 7)
    ctx.sync()
    ctx.mark("captures")
    t0 = time.perf_counter()
    state, _ = calls(state, warm, 1, ctx.seed + 8)
    ctx.sync()
    call_s = time.perf_counter() - t0
    ctx.mark("warm_up")
    captures_before = runner.captures

    # 3. the window (or the traced calls)
    count = (int(wl["trace_iters"]) // call_iters if ctx.trace
             else max(1, round(ctx.seconds / call_s)))
    iters = count * call_iters
    traced: Dict = {}
    before = _counts()
    ctx.window_start()
    if ctx.trace:
        with profiled(traced):
            state, logs = calls(state, int(wl["window_offset"]), count, ctx.seed + 1000)
        wall = traced["trace"].window_s
    else:
        t0 = time.perf_counter()
        state, logs = calls(state, int(wl["window_offset"]), count, ctx.seed + 1000)
        ctx.sync()
        wall = time.perf_counter() - t0
    ctx.window_end()
    counted = _gained(before, _counts())
    losses = torch.cat([lg["loss"] for lg in logs]).cpu().numpy()
    overflow = torch.cat([lg["overflow"] for lg in logs]).cpu().numpy()
    pairs = torch.cat([lg["num_pairs"] for lg in logs]).cpu().numpy()
    budgets = [b for lg in logs for b in lg["budget"]]
    steps = [int(c) for lg in logs for c in lg["cameras"]]
    failed = int(np.sum(~np.isfinite(losses) | (overflow > 0)))
    ctx.note("window", calls=count, iterations=iters, wall_s=wall,
             captures_in_window=runner.captures - captures_before, captures=runner.captures,
             replays=runner.replays, budgets=sorted(set(budgets)),
             pairs_min=int(pairs.min()), pairs_median=float(np.median(pairs)),
             pairs_max=int(pairs.max()), loss_first=float(losses[0]),
             loss_last=float(losses[-1]), overflow_steps=int(np.sum(overflow > 0)),
             warm_call_s=call_s, teacher_bytes=teacher.numel() * teacher.element_size())
    ctx.note("feature_counts", steps=iters, **counted)
    ctx.note("pair_drift", **_drift(steps, pairs))
    rec = dict(e2e={"train_step_ms": wall / iters * 1e3}, attempted=iters, failed=failed,
               memory_peak_bytes=ctx.memory_peak(), feature_counts=counted)
    del state, runner, logs, log, cams, alive, loop, teacher
    ctx.free()

    # 4. the reference, from the inputs made again
    if ctx.trace:
        arrays = _law(cfg).scene(cfg, 2 * ctx.seed, dev)
        rec["layer"] = _layer_counts(cfg, arrays, poses, steps, budgets, wall, traced["trace"])
        rec["layer"].update(channels=3 + dim, feature_dim=dim)
        del arrays
    t0 = time.perf_counter()
    rec["checks"], ref = check_train(cfg, wl, ctx.seed, poses, check_views, check_losses,
                                     moment, change, extent, dev)
    ctx.note("check_leaves", views=check_views, reference_s=time.perf_counter() - t0,
             losses=check_losses, ref_losses=ref["losses"], moment=moment,
             ref_moment=ref["moment_norms"], change=change, ref_change=ref["change_norms"],
             ref_grad=ref["grad_norms"])
    return rec


def follow_check(cfg, wl, seed, poses, views: List[int], extent, dev,
                 dtype=torch.float32) -> Dict:
    """The reference's steps of the check chunk, from the same inputs."""
    w, h = int(cfg["width"]), int(cfg["height"])
    arrays, teacher = inputs(cfg, seed, dev, which=views)
    cams = [R.camera(poses[v], cfg["fov_x"], cfg["fov_y"], w, h, dev) for v in views]
    imgs = target_images(len(poses), h, w, 2 * seed + 1, dev, which=views)
    hyper = dict(cfg["train"])
    return RF.follow(arrays, cams, list(imgs), list(teacher), hyper, extent,
                     int(wl["check_offset"]) + 1, int(cfg["sh_degree"]), dtype=dtype)


def check_train(cfg, wl, seed, poses, views, losses, moment, change, extent, dev) -> List:
    """The reference's steps against the program's: ([(name, value,
    limit)], the reference's numbers)."""
    ref = follow_check(cfg, wl, seed, poses, views, extent, dev)
    leaves = {"moment": moment, "change": change}
    return C.training_checks(losses, leaves, ref, wl["limits"]), ref
