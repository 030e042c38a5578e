"""Traffic driver `distill`: 3D distillation of a scene's fused features.

Set-up makes the configuration's scene and its fused 2D features (class
embeddings of 768 channels plus noise, on the configuration's share of
visited Gaussians) from the seed, writes them as the scene's PLY and fused
`.pt` with the program's own writers under TMPDIR, builds one
`FeatureDataset` over them and warms its raw cache and the step with a
call of two epochs. The window is one call of `train_distill` on that
dataset with as many epochs (one step each: one scene) as fill
`--seconds` at the warm-up's step, so that the program's own loop is
timed: the host item (elastic distortion, voxelization, the cut to the
budget), the topology, the UNet forward and backward, AdamW, `float(loss)`.

The dataset is handed to the loop behind a wrapper that times each item
on the host, keeps the first three items, and reads the optimizer's state
when the second and the fourth items are asked for (after one and three
steps). The check builds those items again from the inputs made anew,
compares them exactly, and follows the three steps with the reference.
"""
from __future__ import annotations

import importlib
import os
import tempfile
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from benchmark.common import checks as C
from benchmark.common.trace import profiled
from benchmark.reference import distill as RD

B1 = 0.9  # AdamW's beta1


def fused_features(cfg: Dict, n: int, seed: int, device):
    """(features [n, D] float16 on the host, visited [n] bool): a class
    embedding a Gaussian (20 classes, by a hash of its index) plus noise,
    unit length; `visited_share` of them visited."""
    from benchmark.scenes.common import generator

    d = cfg["distill"]
    g = generator(seed, device)
    emb = torch.randn((20, cfg["feature_dim"]), generator=g, device=device)
    cls = (torch.arange(n, device=device) * 2654435761) % 20
    f = emb[cls] + 0.5 * torch.randn((n, cfg["feature_dim"]), generator=g, device=device)
    f = f / torch.linalg.norm(f, dim=1, keepdim=True)
    visited = torch.rand(n, generator=g, device=device) < d["visited_share"]
    return f.half().cpu().numpy(), visited.cpu().numpy()


def packed(arrays: Dict[str, torch.Tensor]) -> np.ndarray:
    """The 56 raw parameters a Gaussian, [opacity logit, SH DC, SH rest,
    log-scales, quaternion], on the host."""
    n = arrays["means"].shape[0]
    return torch.cat([arrays["opacity_logits"], arrays["sh_dc"].reshape(n, -1),
                      arrays["sh_rest"].reshape(n, -1), arrays["log_scales"],
                      arrays["quats"]], 1).cpu().numpy()


def _norm(x) -> float:
    return 0.0 if x is None else float(torch.linalg.vector_norm(x.double()))


class Watch:
    """Stands in front of the program's dataset: times each item on the
    host, keeps the first three items, and reads the optimizer after one
    step and after three (when the second and the fourth items are asked
    for)."""

    def __init__(self, inner, holder: Dict):
        self.inner = inner
        self.holder = holder
        self.item_s: List[float] = []
        self.items: List = []
        self.asked: List[float] = []

    def __len__(self):
        return len(self.inner)

    def __getitem__(self, idx, seed=None):
        now = time.perf_counter()
        k = len(self.asked)
        self.asked.append(now)
        model, opt = self.holder.get("model"), self.holder.get("opt")
        if k == 1 and model is not None:
            self.holder["grad_norms"] = {
                n: _norm(opt.state.get(p, {}).get("exp_avg")) / (1 - B1)
                for n, p in model.named_parameters()}
        if k == 3 and model is not None:
            self.holder["change_norms"] = {
                n: float(torch.linalg.vector_norm(p.detach().double()
                                                  - self.holder["p0"][n].double()))
                for n, p in model.named_parameters()}
        item = self.inner.__getitem__(idx, seed=seed)
        self.item_s.append(time.perf_counter() - now)
        if k < 3:
            self.items.append(item)
        return item


class Capture:
    """Wraps the program's make_distill_state while a call runs, to hold
    the model and optimizer it makes (and the model's first weights)."""

    def __init__(self, module, holder: Dict):
        self.module, self.holder = module, holder
        self.orig = module.make_distill_state

    def __enter__(self):
        def wrapped(*a, **kw):
            model, opt, schedule = self.orig(*a, **kw)
            self.holder.update(model=model, opt=opt,
                               p0={n: p.detach().clone() for n, p in model.named_parameters()})
            return model, opt, schedule
        self.module.make_distill_state = wrapped
        return self

    def __exit__(self, *exc):
        self.module.make_distill_state = self.orig
        return False


def run(ctx) -> Dict:
    from semantic_gaussians_torch.core.gaussians import FIELDS, GaussianParams
    from semantic_gaussians_torch.data.feature_dataset import FeatureDataset
    from semantic_gaussians_torch.io.ply import save_gaussian_ply
    from semantic_gaussians_torch.pipelines import distill as PD
    from semantic_gaussians_torch.pipelines.fusion import save_fused_features

    cfg, wl, dev = ctx.config, ctx.workload, ctx.device
    d = cfg["distill"]
    ctx.mark("imports")
    law = importlib.import_module(f"benchmark.scenes.{cfg['law']}")
    arrays = law.scene(cfg, 2 * ctx.seed, dev)
    n = arrays["means"].shape[0]
    feats16, visited = fused_features(cfg, n, 2 * ctx.seed + 1, dev)
    ctx.mark("scene")
    tmp = Path(tempfile.mkdtemp(prefix="bench_distill_", dir=os.environ.get("TMPDIR")))
    ply, fused = tmp / "point_cloud.ply", tmp / "fused.pt"
    cpu = GaussianParams(**{f: arrays[f].cpu() for f in FIELDS})
    save_gaussian_ply(ply, cpu, np.ones(n, bool))
    save_fused_features(fused, feats16.astype(np.float32), visited)
    del cpu
    ctx.mark("files")
    dcfg = PD.DistillConfig(model_3d=d["model_3d"], feature_dim=cfg["feature_dim"],
                            in_channels=d["in_channels"], voxel_size=d["voxel_size"], lr=d["lr"],
                            weight_decay=d["weight_decay"], epochs=d["epochs"],
                            loss_type=d["loss_type"], aug=d["aug"])
    dataset = FeatureDataset([str(ply)], [str(fused)], voxel_size=d["voxel_size"], aug=d["aug"],
                             feature_type=d["feature_type"], voxel_budget=d["voxel_budget"])
    holder: Dict = {}
    warm = Watch(dataset, holder)
    PD.train_distill(warm, dcfg, num_epochs=int(wl["warmup_steps"]), seed=ctx.seed + 1,
                     device=dev)
    ctx.sync()
    step_s = warm.asked[-1] - warm.asked[-2]
    ctx.mark("warm_up")

    steps = int(wl["trace_steps"]) if ctx.trace else max(4, round(ctx.seconds / step_s))
    holder = {}
    watch = Watch(dataset, holder)
    traced: Dict = {}
    ctx.window_start()
    with Capture(PD, holder):
        if ctx.trace:
            with profiled(traced):
                _, _, losses = PD.train_distill(watch, dcfg, num_epochs=steps, seed=ctx.seed,
                                                device=dev)
            wall = traced["trace"].window_s
        else:
            t0 = time.perf_counter()
            _, _, losses = PD.train_distill(watch, dcfg, num_epochs=steps, seed=ctx.seed,
                                            device=dev)
            ctx.sync()
            wall = time.perf_counter() - t0
    ctx.window_end()
    failed = int(sum(not np.isfinite(x) for x in losses))
    prog_items, item_s = watch.items, watch.item_s
    rec = dict(e2e={"distill_step_ms": wall / steps * 1e3}, attempted=steps, failed=failed,
               memory_peak_bytes=ctx.memory_peak())
    g1, change = holder["grad_norms"], holder["change_norms"]
    ctx.note("window", steps=steps, wall_s=wall, warm_step_ms=step_s * 1e3,
             item_ms=[1e3 * s for s in item_s], losses=[float(x) for x in losses],
             voxels=[int(it.num_voxels) for it in prog_items])
    del holder, dataset, warm, watch
    ctx.free()
    for f in (ply, fused):
        f.unlink()
    tmp.rmdir()

    # the reference: the first three items made again, and three steps
    locs = arrays["means"].double().cpu().numpy()
    feats = packed(arrays)
    del arrays
    gt, gt_mask = fused_features(cfg, n, 2 * ctx.seed + 1, dev)
    gt = gt.astype(np.float32) * visited[:, None]
    items, mismatch = [], 0.0
    for k, (item_seed, rng) in enumerate(RD.loop_draws(ctx.seed, 3)):
        it = RD.make_item(locs, feats, gt, gt_mask, item_seed, d["voxel_size"], d["voxel_budget"])
        p = prog_items[k]
        diff = ((it["coords"] != p.coords).any(1) | (it["feats"] != p.feats).any(1)
                | (it["gt"] != p.gt).any(1) | (it["gt_mask"] != p.gt_mask) | (it["mask"] != p.mask))
        mismatch = max(mismatch, float(diff.mean()))
        hi = max(1, min(100, RD.U.GRID_MAX - int(it["coords"].max())))
        it["coords"] = it["coords"] + rng.integers(0, hi, size=(1, 3)).astype(np.int32)
        items.append(it)
    ctx.note("items", voxels_before_cut=[it["voxels_before_cut"] for it in items],
             voxels=[it["num_voxels"] for it in items])
    rcfg = dict(d, feature_dim=cfg["feature_dim"])
    if ctx.trace:
        rec["layer"] = dict(trace=traced["trace"], steps=steps, wall_s=wall,
                            item_ms=1e3 * float(np.mean(item_s)),
                            step_ops=3 * RD.count_ops(ctx.seed, items[0], rcfg, dev))
    ref = RD.follow(ctx.seed, items, rcfg, 1, dev)
    ctx.note("check_leaves", losses=[float(x) for x in losses[:3]], ref_losses=ref["losses"],
             grad=g1, ref_grad=ref["grad_norms"], change=change, ref_change=ref["change_norms"])
    rec["checks"] = [("item_mismatch", mismatch, wl["limits"]["item_mismatch"])] + \
        C.training_checks(losses[:3], {"grad": g1, "change": change}, ref, wl["limits"])
    return rec
