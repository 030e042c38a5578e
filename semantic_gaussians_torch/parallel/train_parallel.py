"""Multi-device train steps: view-parallel, tile-band, ZeRO band, hybrid.

Port of semantic_gaussians_tpu.parallel.train_parallel for torch.distributed,
one process per device. Where the JAX package writes a shard_map, every
rank here runs the same host code on the replicated state (P() inputs) and
takes its own slot of the sharded inputs (P(axis): its view of a camera
batch, its band of the image, its rows of the ZeRO moments); the psum /
pmean / pmax / psum_scatter / all_gather of the JAX bodies are
parallel.collectives over the axis's process group. A step builds the
same state as the JAX step and returns it with its metrics (loss, psnr,
overflow).

  * view-DP (`make_parallel_train_step`): each rank renders its own view;
    gradients averaged; densify statistics per view (each view's mean2D
    gradient norm taken locally, then norms and visibility counts summed:
    averaging before the norm would cancel across views).
  * tile band (`make_band_train_step`): one view a step, its tile rows
    split over the ranks (parallel.render_sharded); the loss on the whole
    image; gradients summed over bands.
  * ZeRO band (`make_band_train_step_zero`): each rank backpropagates its
    own band only; every gradient leaf, flattened to [capacity, D], is
    reduce-scattered, Adam updates this rank's rows with its rows of the
    moments, and the parameters are all-gathered.
  * hybrid (`make_hybrid_train_step[_zero]`): a (view, band) mesh; each
    view row trains its own view band-split over its ranks; the loss is the
    mean over views.
  * `hybrid_train_loop`: the training protocol over the hybrid steps.

The steps render no feature field: a state with one raises a ValueError.

A ZeRO TrainState holds full, replicated params, alive, dstate, step and
adam.count; its adam.mu / adam.nu leaves hold this rank's rows only:
rows [c * capacity / n, (c + 1) * capacity / n) of the full moments, c the
rank's band coordinate and n the band axis size (`shard_moments`,
`gather_moments`). Every rank must run every step and every host-side
decision alike.

The tiled renderer is the JAX package's "pallas" backend; the view-DP step
also takes "dense".
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.densify import add_stats, add_stats_prereduced
from ..core.gaussians import FEATURES, GaussianParams, num_alive, tree_build, tree_leaves, tree_map
from ..core.optimizer import AdamState, adam_update, lr_tree
from ..ops.binning import band_pair_budget
from ..ops.rasterize import DEFAULT_TILE, _untile
from ..pipelines.train import (
    TrainConfig, TrainState, _crop, _edge_crop, camera_statics, densify_step, grow_capacity,
    opacity_reset_step,
)
from ..renderer import render
from ..utils.camera import Camera
from ..utils.losses import photometric_loss, psnr
from .collectives import (
    all_gather, flat_rows, gather_bands, pmax, psum, psum_many, psum_scatter, split_rows,
)
from .mesh import Mesh
from .multihost import primary_print
from .render_sharded import band_grid, band_render_core, render_sharded


def stack_cameras(cams: Sequence[Camera]) -> tuple:
    """A batch of views, one a slot of the mesh axis: a tuple of cameras
    whose static fields (sizes, fovs, clip planes) match, as stacking their
    leaves requires in the JAX package. Each rank takes its own slot."""
    cams = tuple(cams)
    if any(camera_statics(c) != camera_statics(cams[0]) for c in cams):
        raise ValueError("stacked cameras must share sizes, fovs and clip planes")
    return cams


def _check_batch(cam_batch, n: int, axis: str) -> None:
    if len(cam_batch) != n:
        raise ValueError(
            f"cam_batch has {len(cam_batch)} views but mesh axis '{axis}' has {n} devices; "
            "stack exactly one camera per device (repeat views if the scene has fewer "
            "cameras than devices)"
        )


def _grad_inputs(params: GaussianParams):
    """Leaves that take gradients, and a zero mean2D offset whose gradient
    is the densify statistic."""
    if params.features is not None:
        raise ValueError(f"the multi-device train steps render no feature field, and the state "
                         f"has one: {FEATURES!r} [N, {params.feature_dim}]")
    leaves = tree_map(lambda x: x.detach().requires_grad_(True), params)
    offset = torch.zeros((params.capacity, 2), dtype=torch.float32, device=params.device,
                         requires_grad=True)
    return leaves, offset


def _grads(loss, leaves: GaussianParams, offset):
    flat = tree_leaves(leaves)
    g = torch.autograd.grad(loss, list(flat.values()) + [offset], allow_unused=True,
                            materialize_grads=True)
    return tree_build(GaussianParams, dict(zip(flat, g[:-1]))), g[-1]


def _flat(p: GaussianParams) -> torch.Tensor:
    """Every leaf flattened to [rows, D_i], side by side (flat_rows)."""
    return flat_rows(list(tree_leaves(p).values()))


def _unflat(flat: torch.Tensor, like: GaussianParams) -> GaussianParams:
    """The inverse of _flat, for `flat`'s own row count."""
    leaves = tree_leaves(like)
    return tree_build(GaussianParams, dict(zip(leaves, split_rows(flat, list(leaves.values())))))


def _rows(p: GaussianParams, start: int, n: int) -> GaussianParams:
    return tree_map(lambda x: x[start:start + n], p)


def _per_view_stats(goffset, radii, width, height, mesh, axis):
    """Densify statistics of one view a rank summed over `axis`: the norm
    of each view's mean2D gradient (pixel space, scaled to NDC half extents)
    and its visibility, then the max radii."""
    visible = radii > 0
    g = goffset * torch.tensor([[width * 0.5, height * 0.5]], device=goffset.device)
    norm = torch.where(visible, torch.linalg.norm(g, dim=-1), torch.zeros((), device=g.device))
    norm_sum, vis_sum = psum_many([norm, visible.to(torch.float32)], mesh, axis)
    return norm_sum, vis_sum, pmax(radii, mesh, axis)


def _reduce_scalars(values, mesh, axes, mean: bool):
    """Scalars summed (or averaged) over `axes` in one all-reduce an axis,
    in float64 (exact for counts). Returns float32 means or int32 sums."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    total = torch.stack([torch.as_tensor(v).detach().to(torch.float64) for v in values])
    for axis in axes:
        total = psum(total, mesh, axis)
    if not mean:
        return list(total.to(torch.int32))
    n = float(np.prod([mesh.size(a) for a in axes]))
    return list((total / n).to(torch.float32))


def make_parallel_train_step(
    mesh: Mesh,
    cfg: TrainConfig,
    active_sh_degree: int,
    backend: str = "tiled",
    pair_budget: Optional[int] = None,
    axis: str = "data",
):
    """step(state, cam_batch, bg) -> (state, metrics): each rank renders
    cam_batch[its coordinate] (one view a rank; anything else raises)."""
    nview = mesh.size(axis)

    def step(state: TrainState, cam_batch, bg):
        _check_batch(cam_batch, nview, axis)
        cam = cam_batch[mesh.coord(axis)].to(state.params.device)
        leaves, offset = _grad_inputs(state.params)
        out = render(cam, leaves, alive=state.alive, bg=bg,
                     active_sh_degree=active_sh_degree, mean2d_offset=offset, backend=backend,
                     pair_budget=pair_budget)
        loss = photometric_loss(out["render"], cam.image, cfg.lambda_dssim)
        grads, goffset = _grads(loss, leaves, offset)
        with torch.no_grad():
            gparams = _unflat(psum(_flat(grads), mesh, axis) / nview, grads)
            norm_sum, vis_sum, radii_any = _per_view_stats(
                goffset, out["radii"], cam.width, cam.height, mesh, axis)
            loss, step_psnr = _reduce_scalars(
                [loss, psnr(out["render"], cam.image)], mesh, axis, mean=True)
            (overflow,) = _reduce_scalars([out["overflow"]], mesh, axis, mean=False)
        dstate = add_stats_prereduced(state.dstate, norm_sum, vis_sum, radii_any)
        lrs = lr_tree(cfg.hyper, cfg.spatial_lr_scale, state.step)
        new_params, new_adam = adam_update(gparams, state.adam, state.params, lrs, cfg.hyper)
        new_state = dataclasses.replace(state, params=new_params, adam=new_adam, dstate=dstate,
                                        step=state.step + 1)
        return new_state, dict(loss=loss, psnr=step_psnr, overflow=overflow)

    return step


def make_band_train_step(
    mesh: Mesh,
    cfg: TrainConfig,
    active_sh_degree: int,
    pair_budget: Optional[int] = None,
    axis: str = "data",
):
    """step(state, cam, bg) -> (state, metrics): one view a step, its tile
    rows split over the axis (render_sharded), the loss on the whole image,
    replicated Adam. The offset's gradient comes out summed over bands: the
    single-device mean2D gradient, so densify decisions match one
    device's."""

    def step(state: TrainState, cam: Camera, bg):
        cam = cam.to(state.params.device)
        leaves, offset = _grad_inputs(state.params)
        out = render_sharded(cam, leaves, state.alive, mesh, bg,
                             active_sh_degree=active_sh_degree, pair_budget=pair_budget,
                             axis=axis, mean2d_offset=offset)
        pred, gt = _crop(_edge_crop(cam.height, cam.width, cfg.cut_edge), out["render"],
                         cam.image)
        loss = photometric_loss(pred, gt, cfg.lambda_dssim)
        grads, goffset = _grads(loss, leaves, offset)
        dstate = add_stats(state.dstate, goffset, out["radii"], cam.width, cam.height)
        lrs = lr_tree(cfg.hyper, cfg.spatial_lr_scale, state.step)
        new_params, new_adam = adam_update(grads, state.adam, state.params, lrs, cfg.hyper)
        new_state = dataclasses.replace(state, params=new_params, adam=new_adam, dstate=dstate,
                                        step=state.step + 1)
        with torch.no_grad():
            metrics = dict(loss=loss.detach(), psnr=psnr(out["render"], cam.image),
                           overflow=out["overflow"])
        return new_state, metrics

    return step


def shard_moments(state: TrainState, mesh: Mesh, axis: str = "band") -> TrainState:
    """A replicated TrainState as a ZeRO one: this rank's rows of the
    Adam moments (capacity must divide over the axis)."""
    cap, n = state.params.capacity, mesh.size(axis)
    if cap % n:
        raise ValueError(f"capacity {cap} must divide over the {n} ranks of '{axis}'")
    blk = cap // n
    start = mesh.coord(axis) * blk
    adam = AdamState(count=state.adam.count, mu=_rows(state.adam.mu, start, blk),
                     nu=_rows(state.adam.nu, start, blk))
    return dataclasses.replace(state, adam=adam)


def gather_moments(state: TrainState, mesh: Mesh, axis: str = "band") -> TrainState:
    """A ZeRO TrainState as a replicated one: the moments' rows gathered
    over the axis (every rank of the axis must call it)."""
    mu, nu = state.adam.mu, state.adam.nu
    like = [_flat(mu), _flat(nu)]
    full_mu, full_nu = split_rows(all_gather(flat_rows(like), mesh, axis), like)
    adam = AdamState(count=state.adam.count, mu=_unflat(full_mu, mu), nu=_unflat(full_nu, nu))
    return dataclasses.replace(state, adam=adam)


def _zero_update(state, grads, mesh, axis_band, axis_view, cfg):
    """Reduce-scatter the partial gradients over the band axis (one
    [capacity, D] matrix of every leaf side by side), sum the shard over the
    view axis, run Adam on this rank's rows and all-gather the new
    parameters. Returns (params, adam)."""
    cap, n = state.params.capacity, mesh.size(axis_band)
    if cap % n:
        raise ValueError(f"capacity {cap} must divide over the {n} ranks of '{axis_band}'")
    blk = cap // n
    start = mesh.coord(axis_band) * blk
    gshard = psum_scatter(_flat(grads), mesh, axis_band)
    if axis_view is not None:
        gshard = psum(gshard, mesh, axis_view)
    lrs = lr_tree(cfg.hyper, cfg.spatial_lr_scale, state.adam.count)
    new_shard, new_adam = adam_update(
        _unflat(gshard, grads), state.adam, _rows(state.params, start, blk), lrs, cfg.hyper)
    return _unflat(all_gather(_flat(new_shard), mesh, axis_band), new_shard), new_adam


def _band_loss(cam, state, leaves, offset, bg, mesh, axis_band, geometry, cfg, sh_degree,
               pair_budget):
    """Render this rank's band, gather the bands (the backward keeps this
    band's rows of the image cotangent) and compute the view's loss on the
    whole image. Returns (loss, psnr, overflow, radii)."""
    h, w, band_rows, grid_w = geometry
    nband = mesh.size(axis_band)
    budget = pair_budget or band_pair_budget(state.params.capacity, nband)
    color, _, _, _, overflow, radii, _ = band_render_core(
        cam, leaves, state.alive, None, bg, offset, mesh.coord(axis_band), band_rows,
        DEFAULT_TILE, grid_w, budget, sh_degree,
    )
    tiles = gather_bands(color, mesh, axis_band)
    img = _untile(tiles, (nband * band_rows, grid_w), DEFAULT_TILE, h, w)
    pred, gt = _crop(_edge_crop(h, w, cfg.cut_edge), img, cam.image)
    loss = photometric_loss(pred, gt, cfg.lambda_dssim)
    with torch.no_grad():
        step_psnr = psnr(img, cam.image)
    return loss, step_psnr, overflow, radii


def make_band_train_step_zero(
    mesh: Mesh,
    cfg: TrainConfig,
    active_sh_degree: int,
    img_height: int,
    img_width: int,
    pair_budget: Optional[int] = None,
    axis: str = "data",
):
    """step(state, cam, bg) -> (state, metrics) on a ZeRO TrainState (see
    the module docstring; `shard_moments` makes one): the band step with
    reduce-scattered gradients and Adam on this rank's rows. The offset's
    gradient is summed over bands in full for the densify statistics."""
    geometry = (img_height, img_width, *band_grid(img_width, img_height, mesh.size(axis)))

    def step(state: TrainState, cam: Camera, bg):
        cam = cam.to(state.params.device)
        leaves, offset = _grad_inputs(state.params)
        loss, step_psnr, overflow, radii = _band_loss(
            cam, state, leaves, offset, bg, mesh, axis, geometry, cfg, active_sh_degree,
            pair_budget)
        grads, goffset = _grads(loss, leaves, offset)
        with torch.no_grad():
            new_params, new_adam = _zero_update(state, grads, mesh, axis, None, cfg)
            goffset = psum(goffset, mesh, axis)
            (overflow,) = _reduce_scalars([overflow], mesh, axis, mean=False)
        dstate = add_stats(state.dstate, goffset, radii, cam.width, cam.height)
        new_state = dataclasses.replace(state, params=new_params, adam=new_adam, dstate=dstate,
                                        step=state.step + 1)
        return new_state, dict(loss=loss.detach(), psnr=step_psnr,
                               overflow=overflow)

    return step


def _hybrid_step(mesh, cfg, active_sh_degree, img_height, img_width, pair_budget, axis_view,
                 axis_band, zero):
    nview, nband = mesh.size(axis_view), mesh.size(axis_band)
    geometry = (img_height, img_width, *band_grid(img_width, img_height, nband))

    def step(state: TrainState, cam_batch, bg):
        _check_batch(cam_batch, nview, axis_view)
        cam = cam_batch[mesh.coord(axis_view)].to(state.params.device)
        leaves, offset = _grad_inputs(state.params)
        loss, step_psnr, overflow, radii = _band_loss(
            cam, state, leaves, offset, bg, mesh, axis_band, geometry, cfg, active_sh_degree,
            pair_budget)
        # the mean over views: each view row's gradients carry 1 / nview
        grads, goffset = _grads(loss / nview, leaves, offset)
        with torch.no_grad():
            if zero:
                new_params, new_adam = _zero_update(state, grads, mesh, axis_band, axis_view,
                                                    cfg)
            else:
                gparams = _unflat(psum_many([_flat(grads)], mesh, (axis_band, axis_view))[0],
                                  grads)
                lrs = lr_tree(cfg.hyper, cfg.spatial_lr_scale, state.step)
                new_params, new_adam = adam_update(gparams, state.adam, state.params, lrs,
                                                   cfg.hyper)
            # the view's mean2D gradient (bands summed), without the 1 / nview
            gview = psum(goffset, mesh, axis_band) * nview
            norm_sum, vis_sum, radii_any = _per_view_stats(
                gview, radii, img_width, img_height, mesh, axis_view)
            loss, step_psnr = _reduce_scalars([loss, step_psnr], mesh, axis_view, mean=True)
            (overflow,) = _reduce_scalars([overflow], mesh, (axis_band, axis_view), mean=False)
        dstate = add_stats_prereduced(state.dstate, norm_sum, vis_sum, radii_any)
        new_state = dataclasses.replace(state, params=new_params, adam=new_adam, dstate=dstate,
                                        step=state.step + 1)
        return new_state, dict(loss=loss, psnr=step_psnr, overflow=overflow)

    return step


def make_hybrid_train_step(
    mesh: Mesh,
    cfg: TrainConfig,
    active_sh_degree: int,
    img_height: int,
    img_width: int,
    pair_budget: Optional[int] = None,
    axis_view: str = "view",
    axis_band: str = "band",
):
    """step(state, cam_batch, bg) -> (state, metrics) over a (view, band)
    mesh: view row v trains cam_batch[v], its tile bands split over the
    row's ranks; the loss is the mean over views, the gradients are summed
    over bands and views (the per-pixel traffic stays in a row), and Adam
    runs replicated. Densify statistics as view-DP's: each view's mean2D
    gradient (its offset's, summed over its bands, without the 1 / nview of
    the mean) normed per view, norms and counts summed over views."""
    return _hybrid_step(mesh, cfg, active_sh_degree, img_height, img_width, pair_budget,
                        axis_view, axis_band, zero=False)


def make_hybrid_train_step_zero(
    mesh: Mesh,
    cfg: TrainConfig,
    active_sh_degree: int,
    img_height: int,
    img_width: int,
    pair_budget: Optional[int] = None,
    axis_view: str = "view",
    axis_band: str = "band",
):
    """The hybrid step on a ZeRO TrainState (moments sharded over the band
    axis, alike across view rows): each leaf is reduce-scattered over the
    band axis, its shard summed over the view axis (1 / nband of the
    replicated step's cross-row bytes), Adam on the shard, the parameters
    all-gathered over the band axis."""
    return _hybrid_step(mesh, cfg, active_sh_degree, img_height, img_width, pair_budget,
                        axis_view, axis_band, zero=True)


def hybrid_train_loop(
    state: TrainState,
    cameras: list,
    cfg: TrainConfig,
    generator: Optional[torch.Generator],
    mesh: Mesh,
    scene_extent: float = 1.0,
    num_iters: Optional[int] = None,
    log_every: int = 0,
    pair_budget: Optional[int] = None,
    iter_offset: int = 0,
    zero: bool = False,
    axis_view: str = "view",
    axis_band: str = "band",
):
    """Training loop over the hybrid (view, band) mesh, the multi-device
    counterpart of pipelines.train.train_loop. Returns (state, history of
    (iteration, metrics as floats) every `log_every`).

    Every rank runs the same host logic on the replicated state: the same
    permutation stream (`np.random.default_rng(0)`, nview views a step,
    view row v training slot v), the same densify decisions (`generator`
    must be seeded alike on every rank: it draws the split noise). Every
    rank holds every camera and takes its row's. The protocol: SH degree
    +1 every 1000 iterations (a step is built per degree), densify / prune
    every `densification_interval` in the window, capacity doubled past
    85% alive, opacity reset every `opacity_reset_interval`.

    `zero=True` steps with make_hybrid_train_step_zero. `state` comes in and
    goes out replicated; the loop shards the moments (capacity must divide
    over the band axis; doubling keeps it so), and around each densify or
    opacity reset, which touch the moments, gathers them, runs the host
    step on the full state on every rank and shards again."""
    nview = mesh.size(axis_view)
    h, w = cameras[0].height, cameras[0].width
    iters = num_iters or cfg.iterations
    dev = state.params.device
    rng = np.random.default_rng(0)
    order: list = []
    history = []
    make = make_hybrid_train_step_zero if zero else make_hybrid_train_step
    steps_by_degree: dict = {}
    bg = torch.ones(3, device=dev) if cfg.white_background else torch.zeros(3, device=dev)
    if zero:
        state = shard_moments(state, mesh, axis_band)
    for rel_it in range(1, iters + 1):
        it = iter_offset + rel_it
        while len(order) < nview:
            order = order + list(rng.permutation(len(cameras)))
        take, order = order[:nview], order[nview:]
        sh_deg = min(cfg.max_sh_degree, it // 1000)
        if sh_deg not in steps_by_degree:
            steps_by_degree[sh_deg] = make(mesh, cfg, sh_deg, h, w, pair_budget=pair_budget,
                                           axis_view=axis_view, axis_band=axis_band)
        state, metrics = steps_by_degree[sh_deg](
            state, stack_cameras([cameras[i] for i in take]), bg)
        if it < cfg.densify_until_iter:
            densify = it > cfg.densify_from_iter and it % cfg.densification_interval == 0
            reset = it % cfg.opacity_reset_interval == 0 or (
                cfg.white_background and it == cfg.densify_from_iter)
            if zero and (densify or reset):
                state = gather_moments(state, mesh, axis_band)
            if densify:
                state, _dropped = densify_step(
                    state, scene_extent, cfg, use_screen_size=it > cfg.opacity_reset_interval,
                    generator=generator,
                )
                if int(num_alive(state.alive)) > 0.85 * state.params.capacity:
                    state = grow_capacity(state)
            if reset:
                state = opacity_reset_step(state)
            if zero and (densify or reset):
                state = shard_moments(state, mesh, axis_band)
        if log_every and it % log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            history.append((it, m))
            primary_print(f"iter {it}: loss {m['loss']:.4f} psnr {m['psnr']:.2f} "
                          f"alive {int(num_alive(state.alive))}")
    if zero:
        state = gather_moments(state, mesh, axis_band)
    return state, history
