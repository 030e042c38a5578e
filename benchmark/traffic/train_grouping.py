"""Traffic driver `train_grouping`: the late phase of Gaussian Grouping
training.

As the `train` driver (traffic/train.py), on a configuration with
`num_objects` and a `grouping` block: besides the scene law's Gaussians
and colour images, the seed draws each Gaussian's identity encoding and
the classifier (scenes/grouping.py), and each training view's object map
is cast from the room's layout, held on the card for the whole run as
the train CLI holds them. Every step renders RGB and the identity field
in one composite, adds the cross-entropy of the classifier's logits, and
on every `reg3d_interval`-th iteration the 3D KNN term, whose draws are
keyed by the seed (pipelines/train.py, core/grouping.py), through
`train_loop` with one `GraphRunner`, in calls of `call_iters`.

1. Check chunk: the state's first call, one 10-step replay; each step's
   loss, the 3D term's neighbour rows of each step, and after it Adam's
   first moment and the parameters' change by leaf, the identity field
   and the classifier's two leaves among them.
2. Warm-up: a call across a multiple of 1000 (its 9-step chunk and lone
   step included) captures every graph the window replays; a second one
   is timed to size the window.
3. Window: consecutive calls; `train_step_ms` is their wall over their
   iterations. The grouping-step counter (steps with the identity term,
   steps with the 3D term) and the composite's launches by width are
   noted.
4. Check: the Gaussian Grouping reference (reference/grouping_train_step.py)
   follows the check chunk's ten steps from the inputs made again; beside
   the train cells' three numbers, `knn_flips` counts the neighbour
   entries of the chunk's 3D steps where the program's rows differ from
   the reference's.

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
from benchmark.reference import grouping_train_step as RG
from benchmark.reference import render as R
from benchmark.scenes.common import scene_extent, target_images
from benchmark.scenes.grouping import classifier, identity_field, object_maps
from benchmark.traffic.train import CHECK_STEPS, _drift, _law, _layer_counts, loop_views

GROUPING_SEED = 1 << 41  # added to the scene's and the images' seeds
CLASSIFIER = ("weight", "bias")


def inputs(cfg, seed: int, dev) -> Dict[str, torch.Tensor]:
    """The Gaussians with their identity field and the classifier's two
    leaves ("classifier.weight", "classifier.bias"), made from the seed."""
    arrays = _law(cfg).scene(cfg, 2 * seed, dev)
    n, dim = arrays["means"].shape[0], int(cfg["num_objects"])
    arrays["features"] = identity_field(n, dim, 2 * seed + GROUPING_SEED, dev)
    arrays.update(classifier(int(cfg["grouping"]["num_classes"]), dim,
                             2 * seed + 1 + GROUPING_SEED, dev))
    return arrays


def grouping_config(cfg, seed: int) -> Dict:
    """The configuration's `grouping` block with the draws' seed."""
    return dict(cfg["grouping"], seed=int(seed))


def _norm(x: torch.Tensor, base=None) -> float:
    x = x.double() if base is None else x.double() - base.double()
    return float(torch.linalg.vector_norm(x))


def _counts():
    from semantic_gaussians_torch.ops import composite
    from semantic_gaussians_torch.pipelines.train import GROUPING_STEPS

    return dict(grouping=GROUPING_STEPS.snapshot(), fwd=composite.LAUNCHES.snapshot(),
                bwd=composite.BWD_LAUNCHES.snapshot())


def _gained(before: Dict, after: Dict) -> Dict:
    """Steps with each grouping term, and the composite's launches by
    width, over the same calls."""
    gain = {k: {w: n - before[k][1].get(w, 0) for w, n in after[k][1].items()
                if n != before[k][1].get(w, 0)} for k in after}
    return dict(grouping_steps=gain["grouping"], composite_fwd_launches_by_channels=gain["fwd"],
                composite_bwd_launches_by_channels=gain["bwd"])


def run(ctx) -> Dict:
    from semantic_gaussians_torch.core.gaussians import FIELDS, GaussianParams, leaf_names
    from semantic_gaussians_torch.core.grouping import Classifier, GroupingConfig
    from semantic_gaussians_torch.core.optimizer import TrainHyper
    from semantic_gaussians_torch.pipelines.train import TrainConfig, init_train_state, train_loop
    from semantic_gaussians_torch.utils.camera import make_camera_from_c2w
    from semantic_gaussians_torch.utils.graphs import GraphRunner

    cfg, wl, dev = ctx.config, ctx.workload, ctx.device
    tr = cfg["train"]
    dim = int(cfg["num_objects"])
    group = GroupingConfig(**grouping_config(cfg, ctx.seed))
    tcfg_kw = dict(
        hyper=TrainHyper(**{k: tr[k] for k in (
            "position_lr_init", "position_lr_final", "position_lr_delay_mult",
            "position_lr_max_steps", "feature_lr", "opacity_lr", "scaling_lr", "rotation_lr",
            "semantic_feature_lr")}),
        lambda_dssim=tr["lambda_dssim"], densify_until_iter=tr["densify_until_iter"],
        max_sh_degree=int(cfg["sh_degree"]), white_background=tr["white_background"],
        feature_dim=dim, grouping=group)
    ctx.mark("imports")
    law = _law(cfg)
    poses = law.train_poses(cfg)
    views = len(poses)
    w, h = int(cfg["width"]), int(cfg["height"])
    extent = scene_extent(poses)
    tcfg = TrainConfig(spatial_lr_scale=extent, **tcfg_kw)
    arrays = inputs(cfg, ctx.seed, dev)
    ids = object_maps(cfg, poses, dev)
    images = target_images(views, h, w, 2 * ctx.seed + 1, dev)
    cams = [make_camera_from_c2w(p, cfg["fov_x"], cfg["fov_y"], w, h, image=images[i],
                                 image_name=str(i), device=dev) for i, p in enumerate(poses)]
    del images
    params = GaussianParams(**{f: arrays[f].clone() for f in FIELDS},
                            features=arrays["features"].clone())
    names = leaf_names(params)
    alive = torch.ones(params.capacity, dtype=torch.bool, device=dev)
    state = init_train_state(params, alive, Classifier(
        *(arrays[f"classifier.{f}"].clone() for f in CLASSIFIER)))
    check_offset = int(wl["check_offset"])
    state = dataclasses.replace(state, step=torch.full((), check_offset, dtype=torch.int32,
                                                       device=dev))
    del params
    runner = GraphRunner(dev)
    loop = dict(cameras=cams, cfg=tcfg, scene_extent=extent, pair_budget=tr["pair_budget"],
                steps_per_dispatch=int(tr["steps_per_dispatch"]), runner=runner,
                object_ids=ids)
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
    check_knn = log["knn"].cpu()
    moment = {f: _norm(getattr(state.adam.mu, f)) for f in names}
    change = {f: _norm(getattr(state.params, f), arrays[f]) for f in names}
    for f in CLASSIFIER:
        moment[f"classifier.{f}"] = _norm(getattr(state.classifier.mu, f))
        change[f"classifier.{f}"] = _norm(getattr(state.classifier.params, f),
                                          arrays[f"classifier.{f}"])
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
             warm_call_s=call_s, object_map_bytes=ids.numel() * ids.element_size())
    ctx.note("grouping_counts", steps=iters, **counted)
    ctx.note("pair_drift", **_drift(steps, pairs))
    rec = dict(e2e={"train_step_ms": wall / iters * 1e3}, attempted=iters, failed=failed,
               memory_peak_bytes=ctx.memory_peak(), grouping_counts=counted)
    del state, runner, logs, log, cams, alive, loop, ids
    ctx.free()

    # 4. the reference, from the inputs made again
    if ctx.trace:
        arrays = _law(cfg).scene(cfg, 2 * ctx.seed, dev)
        rec["layer"] = _layer_counts(cfg, arrays, poses, steps, budgets, wall, traced["trace"])
        rec["layer"].update(channels=3 + dim, num_objects=dim,
                            grouping=dict(cfg["grouping"], reg3d_steps=counted[
                                "grouping_steps"].get("reg3d", 0)))
        del arrays
    t0 = time.perf_counter()
    rec["checks"], ref = check_train(cfg, wl, ctx.seed, poses, check_views, check_losses,
                                     check_knn, moment, change, extent, dev)
    ctx.note("check_leaves", views=check_views, reference_s=time.perf_counter() - t0,
             losses=check_losses, ref_losses=ref["losses"], moment=moment,
             ref_moment=ref["moment_norms"], change=change, ref_change=ref["change_norms"],
             ref_grad=ref["grad_norms"], knn_flips_by_step=ref["flips"])
    return rec


def follow_check(cfg, wl, seed, poses, views: List[int], extent, dev,
                 dtype=torch.float32) -> Dict:
    """The reference's steps of the check chunk, from the same inputs."""
    w, h = int(cfg["width"]), int(cfg["height"])
    arrays = inputs(cfg, seed, dev)
    ids = object_maps(cfg, poses, dev, which=views)
    cams = [R.camera(poses[v], cfg["fov_x"], cfg["fov_y"], w, h, dev) for v in views]
    imgs = target_images(len(poses), h, w, 2 * seed + 1, dev, which=views)
    return RG.follow(arrays, cams, list(imgs), list(ids), dict(cfg["train"]),
                     grouping_config(cfg, seed), extent, int(wl["check_offset"]) + 1,
                     int(cfg["sh_degree"]), dtype=dtype)


def knn_flips(knn: torch.Tensor, ref_knn: List) -> List[int]:
    """By step of the chunk, the neighbour entries where the program's rows
    differ from the reference's (a step without the 3D term: the program's
    must all be -1)."""
    out = []
    for j, want in enumerate(ref_knn):
        got = knn[j]
        want = torch.full_like(got, -1) if want is None else want.to(got.device)
        out.append(int((got != want).sum()) if got.shape == want.shape else got.numel())
    return out


def check_train(cfg, wl, seed, poses, views, losses, knn, moment, change, extent,
                dev) -> List:
    """The reference's steps against the program's: ([(name, value,
    limit)], the reference's numbers with `flips` by step)."""
    ref = follow_check(cfg, wl, seed, poses, views, extent, dev)
    ref["flips"] = knn_flips(knn, ref.pop("knn"))
    leaves = {"moment": moment, "change": change}
    checks = C.training_checks(losses, leaves, ref, wl["limits"])
    return checks + [("knn_flips", float(sum(ref["flips"])), wl["limits"]["knn_flips"])], ref
