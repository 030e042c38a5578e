"""3DGS RGB training: the train step and its driver loop.

Port of semantic_gaussians_tpu.pipelines.train: loss 0.8 L1 + 0.2 (1 -
SSIM) (optionally on a 1% edge crop), per-group Adam with the exponential
xyz schedule, SH degree +1 every 1000 iterations, densify / prune every
`densification_interval` iterations in (densify_from, densify_until),
opacity reset every `opacity_reset_interval`, the adaptive pair budget.
The state is capacity-padded with an `alive` mask, as in the JAX package.

The gradient runs through the tiled rasterizer's autograd Function (the
composite backward and segment-sum kernels on the card). Not ported:
`train_scan_step`, which fuses K steps into one XLA dispatch to amortise
dispatch cost; eager PyTorch has no such dispatch to amortise.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..core.densify import (
    DensifyConfig,
    DensifyState,
    add_stats,
    densify_and_prune,
    reset_opacity,
)
from ..core.gaussians import FIELDS, GaussianParams, num_alive
from ..core.optimizer import AdamState, TrainHyper, adam_init, adam_update, lr_tree
from ..ops.binning import default_pair_budget
from ..renderer import render
from ..utils.camera import Camera
from ..utils.losses import photometric_loss, psnr
from ..utils.logging_utils import StepTimer


@dataclasses.dataclass(frozen=True)
class TrainState:
    params: GaussianParams
    alive: torch.Tensor  # [cap] bool
    adam: AdamState
    dstate: DensifyState
    step: torch.Tensor  # [] int32


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    hyper: TrainHyper = TrainHyper()
    densify: DensifyConfig = DensifyConfig()
    iterations: int = 30000
    lambda_dssim: float = 0.2
    cut_edge: bool = False  # ScanNet: crop 1% border from the loss
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15000
    max_sh_degree: int = 3
    white_background: bool = False
    random_background: bool = False
    spatial_lr_scale: float = 1.0


def init_train_state(params: GaussianParams, alive: torch.Tensor) -> TrainState:
    return TrainState(
        params=params,
        alive=alive,
        adam=adam_init(params),
        dstate=DensifyState.zeros(params.capacity, params.device),
        step=torch.zeros((), dtype=torch.int32, device=params.device),
    )


def train_state_from_numpy(arrays: dict, device) -> TrainState:
    """Carry a TrainState given as numpy arrays (e.g. the JAX package's
    leaves, via np.asarray) onto `device`: {"params": {field: array},
    "alive", "adam": {"count", "mu": {field: ...}, "nu": {...}},
    "dstate": {"xyz_grad_accum", "denom", "max_radii2d"}, "step"}.
    Values are copied bit for bit."""

    def t(x, dtype=torch.float32):
        return torch.from_numpy(np.array(x)).to(dtype=dtype, device=device)

    def params(d):
        return GaussianParams(**{f: t(d[f]) for f in FIELDS})

    adam = arrays["adam"]
    return TrainState(
        params=params(arrays["params"]),
        alive=t(arrays["alive"], torch.bool),
        adam=AdamState(count=t(adam["count"], torch.int32), mu=params(adam["mu"]),
                       nu=params(adam["nu"])),
        dstate=DensifyState(**{k: t(v) for k, v in arrays["dstate"].items()}),
        step=t(arrays["step"], torch.int32),
    )


def train_state_to_numpy(state: TrainState) -> dict:
    """The inverse of train_state_from_numpy."""

    def n(x):
        return x.detach().cpu().numpy()

    return dict(
        params=state.params.to_numpy(),
        alive=n(state.alive),
        adam=dict(count=n(state.adam.count), mu=state.adam.mu.to_numpy(),
                  nu=state.adam.nu.to_numpy()),
        dstate={k: n(getattr(state.dstate, k)) for k in ("xyz_grad_accum", "denom",
                                                        "max_radii2d")},
        step=n(state.step),
    )


def _edge_crop(h: int, w: int, cut_edge: bool):
    """Crop of h // 100, w // 100 pixels per border (cropping, not masking,
    keeps the loss mean and the SSIM windows as the reference has them)."""
    return (h // 100, w // 100) if cut_edge else None


def train_step(
    state: TrainState,
    camera: Camera,
    bg: torch.Tensor,
    cfg: TrainConfig,
    active_sh_degree: int,
    backend: str = "tiled",
    pair_budget: Optional[int] = None,
):
    """One optimization step. Returns (new_state, metrics dict of device
    scalars: loss, psnr, num_points, overflow, num_pairs)."""
    params = state.params
    leaves = {f: getattr(params, f).detach().requires_grad_(True) for f in FIELDS}
    offset = torch.zeros((params.capacity, 2), dtype=torch.float32, device=params.device,
                         requires_grad=True)
    out = render(
        camera, GaussianParams(**leaves), alive=state.alive, bg=bg,
        active_sh_degree=active_sh_degree, mean2d_offset=offset, backend=backend,
        pair_budget=pair_budget,
    )
    pred, gt = out["render"], camera.image
    crop = _edge_crop(camera.height, camera.width, cfg.cut_edge)
    if crop is not None:
        ch, cw = crop
        pred = pred[ch:camera.height - ch, cw:camera.width - cw]
        gt = gt[ch:camera.height - ch, cw:camera.width - cw]
    loss = photometric_loss(pred, gt, cfg.lambda_dssim)
    grads = torch.autograd.grad(loss, [leaves[f] for f in FIELDS] + [offset])
    gparams = GaussianParams(**dict(zip(FIELDS, grads[:-1])))
    dstate = add_stats(state.dstate, grads[-1], out["radii"], camera.width, camera.height)
    lrs = lr_tree(cfg.hyper, cfg.spatial_lr_scale, state.step)
    new_params, new_adam = adam_update(gparams, state.adam, params, lrs, cfg.hyper)
    with torch.no_grad():
        metrics = dict(
            loss=loss.detach(),
            psnr=psnr(out["render"].detach(), camera.image),
            num_points=num_alive(state.alive),
            overflow=out["overflow"],
            num_pairs=out["num_pairs"],
        )
    return (
        dataclasses.replace(state, params=new_params, adam=new_adam, dstate=dstate,
                            step=state.step + 1),
        metrics,
    )


def densify_step(
    state: TrainState,
    scene_extent: float,
    cfg: TrainConfig,
    use_screen_size: bool,
    generator: Optional[torch.Generator] = None,
    noise: Optional[List[torch.Tensor]] = None,
):
    """Densify and prune. Returns (new_state, dropped)."""
    dcfg = cfg.densify
    if use_screen_size:
        dcfg = dataclasses.replace(dcfg, max_screen_size=20.0)
    params, alive, adam, dstate, dropped = densify_and_prune(
        state.params, state.alive, state.adam, state.dstate, scene_extent, dcfg,
        noise=noise, generator=generator,
    )
    return (
        dataclasses.replace(state, params=params, alive=alive, adam=adam, dstate=dstate),
        dropped,
    )


def opacity_reset_step(state: TrainState) -> TrainState:
    params, adam = reset_opacity(state.params, state.adam)
    return dataclasses.replace(state, params=params, adam=adam)


def grow_capacity(state: TrainState, factor: int = 2) -> TrainState:
    """Capacity doubling: every capacity-sized leaf is padded; new slots are
    dead, with opacity logit -20 and zero moments."""
    cap = state.params.capacity
    new_cap = cap * factor

    def pad(x, fill=0.0):
        if x.dim() == 0 or x.shape[0] != cap:
            return x
        out = torch.full((new_cap,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                         device=x.device)
        out[:cap] = x
        return out

    def pad_params(p):
        return GaussianParams(**{f: pad(getattr(p, f)) for f in FIELDS})

    params = pad_params(state.params)
    logits = params.opacity_logits.clone()
    logits[cap:] = -20.0
    return TrainState(
        params=dataclasses.replace(params, opacity_logits=logits),
        alive=pad(state.alive, False),
        adam=AdamState(count=state.adam.count, mu=pad_params(state.adam.mu),
                       nu=pad_params(state.adam.nu)),
        dstate=DensifyState(**{k: pad(getattr(state.dstate, k)) for k in (
            "xyz_grad_accum", "denom", "max_radii2d")}),
        step=state.step,
    )


def tuned_pair_budget(pairs: int) -> int:
    """Pair budget for a measured pair count: 1.25x headroom rounded up to
    quarter-power-of-two granules, below binning's 2^24 ceiling."""
    want = max(8192, int(pairs * 1.25))
    granule = max(8192, 1 << max(int(np.log2(want)) - 2, 0))
    out = -(-want // granule) * granule
    return min(out, (1 << 24) - 8192)


def train_loop(
    state: TrainState,
    cameras: list,
    cfg: TrainConfig,
    generator: Optional[torch.Generator] = None,
    scene_extent: float = 1.0,
    num_iters: Optional[int] = None,
    backend: str = "tiled",
    log_every: int = 0,
    pair_budget: Optional[int] = None,
    iter_offset: int = 0,
    shuffle_seed: int = 0,
):
    """Single-device driver, the JAX package's train_loop step for step:
    cameras in the order `np.random.default_rng(shuffle_seed)` permutes
    them, SH warm-up, densify / reset cadence, and the adaptive pair budget
    (doubles on overflow, re-tunes every 50 iterations from the pair count;
    its decisions read the metrics of the previous check, 10 steps stale,
    so reading them never waits on the step in flight). An explicit
    `pair_budget` disables the adaptation.

    Returns (state, log): log["loss"] / ["psnr"] / ["overflow"] /
    ["num_pairs"] are device tensors with one entry per step, log["budget"]
    the pair budget of each step, log["densify"] a list of (iteration,
    alive count after, dropped) per densify, and log["history"] the
    (iteration, metrics as floats) printed every `log_every` steps."""
    iters = num_iters or cfg.iterations
    dev = state.params.device
    bg = torch.ones(3, device=dev) if cfg.white_background else torch.zeros(3, device=dev)
    rng = np.random.default_rng(shuffle_seed)
    order: list = []
    adaptive = pair_budget is None
    if adaptive:
        pair_budget = default_pair_budget(state.params.capacity)
    pending_check = None
    timer = StepTimer()
    keys = ("loss", "psnr", "overflow", "num_pairs")
    log = {k: torch.zeros(iters, dtype=torch.float32, device=dev) for k in keys}
    log.update(budget=[], densify=[], history=[])

    for rel in range(iters):
        it = iter_offset + rel + 1
        sh_deg = min(cfg.max_sh_degree, it // 1000)
        if not order:
            order = list(rng.permutation(len(cameras)))
        cam = cameras[order.pop()]
        step_bg = torch.rand(3, generator=generator, device=dev) if cfg.random_background else bg
        with timer:
            state, m = train_step(state, cam, step_bg, cfg, sh_deg, backend=backend,
                                  pair_budget=pair_budget)
        log["budget"].append(pair_budget)
        for k in keys:
            log[k][rel] = m[k]
        if adaptive and it % 10 == 0:
            skip_record = False
            if pending_check is not None:
                ov, pairs, chk_it = pending_check
                if int(ov) > 0:
                    pair_budget *= 2
                    # this step ran under the old budget: wait for one that
                    # ran under the new one before judging again
                    skip_record = True
                elif chk_it % 50 == 0:
                    want = tuned_pair_budget(int(pairs))
                    if want > pair_budget or want < pair_budget * 2 // 3:
                        pair_budget = want
            pending_check = None if skip_record else (m["overflow"], m["num_pairs"], it)
        if it < cfg.densify_until_iter:
            if it > cfg.densify_from_iter and it % cfg.densification_interval == 0:
                state, dropped = densify_step(
                    state, scene_extent, cfg,
                    use_screen_size=it > cfg.opacity_reset_interval, generator=generator,
                )
                alive_n = int(num_alive(state.alive))
                log["densify"].append((it, alive_n, int(dropped)))
                if alive_n > 0.85 * state.params.capacity:
                    state = grow_capacity(state)
            if it % cfg.opacity_reset_interval == 0 or (
                cfg.white_background and it == cfg.densify_from_iter
            ):
                state = opacity_reset_step(state)
        if log_every and it % log_every == 0:
            mf = {k: float(v) for k, v in m.items()}
            log["history"].append((it, mf))
            print(f"iter {it}: loss {mf['loss']:.4f} psnr {mf['psnr']:.2f} "
                  f"pts {int(mf['num_points'])} step {timer.value * 1e3:.1f} ms (host)")
    return state, log
