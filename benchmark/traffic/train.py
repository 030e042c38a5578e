"""Traffic driver `train`: the steady late phase of 3DGS training.

The configuration's scene law makes the Gaussians and the training
cameras, and smooth colour fields stand for the training images, all from
the seed on the card. The program's state starts there with fresh Adam
moments, past `densify_until_iter` (no densify, no opacity reset). Every
step goes through `train_loop` with `steps_per_dispatch` 10 and one
`GraphRunner` shared by all calls, in calls of `call_iters` iterations,
as the program's parity harness chains them; the pair budget is the
configuration's (null: the loop's own adaptive budget).

1. Check chunk: the state's first call, of one 10-step chunk: the
   runner captures the 10-step graph that the window replays and replays
   it. Each step's loss, and Adam's first moment and the change of the
   parameters after the chunk, are kept by leaf, as norms.
2. Warm-up: a call across a multiple of 1000 (10-step replays, the
   9-step chunk and the single step before the multiple), so that every
   graph the window replays is captured; a second, alike, is timed to
   size the window.
3. Window: consecutive calls whose iterations fill `--seconds` at the
   timed call. `train_step_ms` is their wall over their iterations.
4. Check: the reference follows the check chunk's ten steps from the same
   inputs made again from the seed.

With `--trace 1` traced calls of `trace_iters` in all take the window's
place, and the work their steps ask of each kernel is counted by the
reference from the initial scene, view by view.
"""
from __future__ import annotations

import dataclasses
import importlib
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.common import checks as C
from benchmark.common.trace import profiled
from benchmark.reference import render as R
from benchmark.reference import train_step as RT
from benchmark.scenes.common import scene_extent, target_images

CHECK_STEPS = 10  # the check chunk: one replay of the window's 10-step graph


def _law(cfg):
    return importlib.import_module(f"benchmark.scenes.{cfg['law']}")


def loop_views(shuffle_seed: int, views: int, n: int) -> List[int]:
    """The first `n` cameras of a `train_loop` call, in its order: it pops
    the end of a permutation, and draws the next when one runs out (all
    differ while n <= views)."""
    rng, order, out = np.random.default_rng(shuffle_seed), [], []
    for _ in range(n):
        if not order:
            order = list(rng.permutation(views))
        out.append(int(order.pop()))
    return out


def _leaf_norms(tree) -> Dict[str, float]:
    from semantic_gaussians_torch.core.gaussians import FIELDS

    return {f: float(torch.linalg.vector_norm(getattr(tree, f).double())) for f in FIELDS}


def run(ctx) -> Dict:
    from semantic_gaussians_torch.core.gaussians import FIELDS, GaussianParams
    from semantic_gaussians_torch.core.optimizer import TrainHyper
    from semantic_gaussians_torch.pipelines.train import TrainConfig, init_train_state, train_loop
    from semantic_gaussians_torch.utils.camera import make_camera_from_c2w
    from semantic_gaussians_torch.utils.graphs import GraphRunner

    cfg, wl, dev = ctx.config, ctx.workload, ctx.device
    tr = cfg["train"]
    ctx.mark("imports")
    law = _law(cfg)
    poses = law.train_poses(cfg)
    views = len(poses)
    w, h = int(cfg["width"]), int(cfg["height"])
    extent = scene_extent(poses)
    arrays = law.scene(cfg, 2 * ctx.seed, dev)
    images = target_images(views, h, w, 2 * ctx.seed + 1, dev)
    cams = [make_camera_from_c2w(p, cfg["fov_x"], cfg["fov_y"], w, h, image=images[i],
                                 image_name=str(i), device=dev) for i, p in enumerate(poses)]
    del images
    params = GaussianParams(**{f: arrays[f].clone() for f in FIELDS})
    n = params.capacity
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    state = init_train_state(params, alive)
    check_offset = int(wl["check_offset"])
    state = dataclasses.replace(state, step=torch.full((), check_offset, dtype=torch.int32,
                                                       device=dev))
    tcfg = TrainConfig(
        hyper=TrainHyper(**{k: tr[k] for k in (
            "position_lr_init", "position_lr_final", "position_lr_delay_mult",
            "position_lr_max_steps", "feature_lr", "opacity_lr", "scaling_lr", "rotation_lr")}),
        lambda_dssim=tr["lambda_dssim"], densify_until_iter=tr["densify_until_iter"],
        max_sh_degree=int(cfg["sh_degree"]), white_background=tr["white_background"],
        spatial_lr_scale=extent)
    runner = GraphRunner(dev)
    loop = dict(cameras=cams, cfg=tcfg, scene_extent=extent, pair_budget=tr["pair_budget"],
                steps_per_dispatch=int(tr["steps_per_dispatch"]), runner=runner)
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
    moment = _leaf_norms(state.adam.mu)
    change = {f: float(torch.linalg.vector_norm(getattr(state.params, f).double()
                                                - arrays[f].double())) for f in FIELDS}
    check_budget = log["budget"][0]
    del arrays
    ctx.mark("check_chunk")

    # 2. warm-up: capture every graph the window can replay, then time a
    # call alike
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
    losses = torch.cat([lg["loss"] for lg in logs]).cpu().numpy()
    overflow = torch.cat([lg["overflow"] for lg in logs]).cpu().numpy()
    pairs = torch.cat([lg["num_pairs"] for lg in logs]).cpu().numpy()
    budgets = [b for lg in logs for b in lg["budget"]]
    names = [int(c) for lg in logs for c in lg["cameras"]]
    failed = int(np.sum(~np.isfinite(losses) | (overflow > 0)))
    ctx.note("window", calls=count, iterations=iters, wall_s=wall,
             captures_in_window=runner.captures - captures_before, captures=runner.captures,
             replays=runner.replays, check_budget=check_budget, budgets=sorted(set(budgets)),
             pairs_min=int(pairs.min()), pairs_median=float(np.median(pairs)),
             pairs_max=int(pairs.max()), loss_first=float(losses[0]),
             loss_last=float(losses[-1]), overflow_steps=int(np.sum(overflow > 0)),
             warm_call_s=call_s)
    ctx.note("pair_drift", **_drift(names, pairs))
    rec = dict(e2e={"train_step_ms": wall / iters * 1e3}, attempted=iters, failed=failed,
               memory_peak_bytes=ctx.memory_peak())
    del state, runner, logs, log, cams, params, alive, loop
    ctx.free()

    # 4. the reference, from the inputs made again
    arrays = law.scene(cfg, 2 * ctx.seed, dev)
    if ctx.trace:
        rec["layer"] = _layer_counts(cfg, arrays, poses, names, budgets, wall, traced["trace"])
    t0 = time.perf_counter()
    rec["checks"], ref = check_train(cfg, wl, ctx.seed, arrays, poses, check_views,
                                     check_losses, moment, change, extent, dev)
    ctx.note("check_leaves", views=check_views, reference_s=time.perf_counter() - t0,
             losses=check_losses, ref_losses=ref["losses"], moment=moment,
             ref_moment=ref["moment_norms"], change=change, ref_change=ref["change_norms"],
             ref_grad=ref["grad_norms"])
    return rec


def _drift(names: List[int], pairs) -> Dict:
    """How far the pair count of the window's most seen view moved from
    its first to its last visit."""
    by = {}
    for v, p in zip(names, pairs):
        by.setdefault(v, []).append(int(p))
    v = max(by, key=lambda k: len(by[k]))
    first, last = by[v][0], by[v][-1]
    return dict(view=v, visits=len(by[v]), first=first, last=last,
                drift_pct=100.0 * (last - first) / max(first, 1))


def follow_check(cfg, wl, seed, arrays, poses, views, extent, dev, dtype=torch.float32) -> Dict:
    """The reference's steps of the check chunk, from the same inputs."""
    w, h = int(cfg["width"]), int(cfg["height"])
    cams = [R.camera(poses[v], cfg["fov_x"], cfg["fov_y"], w, h, dev) for v in views]
    imgs = target_images(len(poses), h, w, 2 * seed + 1, dev, which=views)
    return RT.follow(arrays, cams, list(imgs), cfg["train"], extent, int(wl["check_offset"]) + 1,
                     int(cfg["sh_degree"]), dtype=dtype)


def check_train(cfg, wl, seed, arrays, poses, views, losses, moment, change, extent,
                dev) -> List:
    """The reference's steps against the program's: ([(name, value,
    limit)], the reference's numbers)."""
    ref = follow_check(cfg, wl, seed, arrays, poses, views, extent, dev)
    leaves = {"moment": moment, "change": change}
    return C.training_checks(losses, leaves, ref, wl["limits"]), ref


def _layer_counts(cfg, arrays, poses, names, budgets, wall, trace) -> Dict:
    """The work of the traced steps, counted view by view from the
    initial scene, averaged a step."""
    w, h = int(cfg["width"]), int(cfg["height"])
    per_view = {}
    for v in sorted(set(names)):
        cam = R.camera(poses[v], cfg["fov_x"], cfg["fov_y"], w, h, arrays["means"].device)
        per_view[v] = R.event_counts(arrays, cam, int(cfg["sh_degree"]))
    steps = len(names)
    avg = {k: sum(per_view[v][k] for v in names) / steps for k in per_view[names[0]]}
    return dict(steps=steps, wall_s=wall, trace=trace, counts=avg,
                budget=statistics.fmean(budgets), gaussians=int(cfg["num_gaussians"]),
                pixels=w * h, channels=3, sh_degree=int(cfg["sh_degree"]))
