"""3DGS RGB training: the train step and its driver loop.

Port of semantic_gaussians_tpu.pipelines.train: loss 0.8 L1 + 0.2 (1 -
SSIM) (optionally on a 1% edge crop), per-group Adam with the exponential
xyz schedule, SH degree +1 every 1000 iterations, densify / prune every
`densification_interval` iterations in (densify_from, densify_until),
opacity reset every `opacity_reset_interval`, the adaptive pair budget.
The state is capacity-padded with an `alive` mask, as in the JAX package.

The gradient runs through the tiled rasterizer's autograd Function (the
composite backward and segment-sum kernels on the card). `train_scan_step`
runs K dependent steps as one replay of a CUDA graph (utils.graphs), the
counterpart of the JAX package's `lax.scan` dispatch: eager PyTorch pays
the host's launch of every small kernel of a step, hundreds of them, and a
replay launches them at once. `train_loop(steps_per_dispatch=K)` cuts the
run into such chunks at the JAX package's boundaries. One rule decides how
a chunk runs, for every model: with K > 1 every chunk whose cameras share
their statics is a train_scan_step, whatever its length (the lone step at
each multiple of 1000 included); with K = 1, and for a chunk whose
cameras' statics differ, train_step runs step by step.

Feature 3DGS (Zhou et al., CVPR 2024) trains on the same path: where
`TrainConfig.feature_dim` > 0 the state carries a feature field [N, D]
(GaussianParams.features) with its Adam moments, each step renders RGB and
the field in one composite (renderer.render's `features`) and adds
`lambda_feature` x the mean |F - F_t| against the view's 2D teacher map,
and densify, prune and capacity growth carry the field's rows. The teacher
maps are one tensor [V, H, W, D] (float16 or float32) in the order of the
cameras; a graphed chunk takes the indices of its views, not the maps.

Gaussian Grouping (Ye et al., ECCV 2024; core.grouping) trains the same
field by other terms, where `TrainConfig.grouping` is set: the field
(`feature_dim` wide, their identity encoding) is composited with the
colour in the same way, a classifier (the state's `classifier`, with its
own Adam moments, stepped in the same Adam launch) maps it to class
logits, and the loss adds L_2d, the cross-entropy against the view's
integer object map, and on every `reg3d_interval`-th iteration L_3d, the
KL between the class distributions of sampled Gaussians and their nearest
neighbours. Iterations count from 1, as theirs do: the step that takes
`state.step` from s to s + 1 is iteration s + 1. The object maps are one
uint8 tensor [V, H, W], read inside a graph by view index as the teacher
maps are; whether a step adds L_3d is part of a graph's body, so the
first iteration's residue modulo the interval keys a chunk's graph.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.densify import (
    DensifyConfig,
    DensifyState,
    add_stats,
    densify_and_prune,
    reset_opacity,
)
from ..core.gaussians import FEATURES, GaussianParams, num_alive, tree_build, tree_leaves
from ..core.grouping import (
    CLASSIFIER_EPS,
    CLASSIFIER_FIELDS,
    CLASSIFIER_LR,
    Classifier,
    ClassifierState,
    GroupingConfig,
    classifier_state,
    identity_loss,
    reg3d_loss,
)
from ..core.optimizer import (
    AdamState,
    TrainHyper,
    adam_init,
    adam_update,
    adam_update_with,
    lr_tree,
)
from ..ops import kernels
from ..ops.binning import default_pair_budget
from ..renderer import render
from ..utils import tracing
from ..utils.camera import Camera
from ..utils.graphs import GraphRunner
from ..utils.losses import l1_loss, photometric_loss, psnr
from ..utils.logging_utils import ChunkClock, TBLogger

# One count a step that trains a feature field, keyed by the channels its
# one composite carries (3 + D); graph replays add their steps' counts.
FEATURE_STEPS = kernels.LaunchCounter("feature_steps")
# One count a Gaussian Grouping step under key "identity", and one more
# under "reg3d" where the step adds the 3D term; replays add their steps'.
GROUPING_STEPS = kernels.LaunchCounter("grouping_steps")


@dataclasses.dataclass(frozen=True)
class TrainState:
    params: GaussianParams
    alive: torch.Tensor  # [cap] bool
    adam: AdamState
    dstate: DensifyState
    step: torch.Tensor  # [] int32
    classifier: Optional[ClassifierState] = None  # Gaussian Grouping's, with its moments


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
    feature_dim: int = 0  # D of a Feature 3DGS field (0: RGB only)
    lambda_feature: float = 1.0  # weight of the feature L1 in the loss
    # set: the field is Gaussian Grouping's identity field, trained by its
    # terms (core.grouping) and not by a teacher's L1
    grouping: Optional[GroupingConfig] = None


def init_train_state(params: GaussianParams, alive: torch.Tensor,
                     classifier: Optional[Classifier] = None) -> TrainState:
    """A fresh state (zero moments, step 0), with Gaussian Grouping's
    `classifier` where given."""
    return TrainState(
        params=params,
        alive=alive,
        adam=adam_init(params),
        dstate=DensifyState.zeros(params.capacity, params.device),
        step=torch.zeros((), dtype=torch.int32, device=params.device),
        classifier=None if classifier is None else classifier_state(classifier),
    )


def train_state_from_numpy(arrays: dict, device) -> TrainState:
    """Carry a TrainState given as numpy arrays (e.g. the JAX package's
    leaves, via np.asarray) onto `device`, nested as the state is: {"params":
    {field: array}, "alive", "adam": {"count", "mu": {...}, "nu": {...}},
    "dstate": {...}, "step"}. Values and types are copied bit for bit."""

    def leaves(d, prefix=""):
        for k, x in d.items():
            if isinstance(x, dict):
                yield from leaves(x, f"{prefix}{k}.")
            else:
                yield prefix + k, torch.from_numpy(np.array(x)).to(device)

    return tree_build(TrainState, dict(leaves(arrays)))


def train_state_to_numpy(state: TrainState) -> dict:
    """The inverse of train_state_from_numpy."""
    out: dict = {}
    for name, x in tree_leaves(state).items():
        *path, leaf = name.split(".")
        d = out
        for k in path:
            d = d.setdefault(k, {})
        d[leaf] = x.detach().cpu().numpy()
    return out


def _edge_crop(h: int, w: int, cut_edge: bool):
    """Crop of h // 100, w // 100 pixels per border (cropping, not masking,
    keeps the loss mean and the SSIM windows as the reference has them)."""
    return (h // 100, w // 100) if cut_edge else None


def _crop(crop, *images):
    """The images [H, W, ...] cut by `crop` (_edge_crop's; None: whole)."""
    if crop is None:
        return images
    (ch, cw), (h, w) = crop, images[0].shape[:2]
    return tuple(x[ch:h - ch, cw:w - cw] for x in images)


def train_step(
    state: TrainState,
    camera: Camera,
    bg: torch.Tensor,
    cfg: TrainConfig,
    active_sh_degree: int,
    backend: str = "tiled",
    pair_budget: Optional[int] = None,
    teacher: Optional[torch.Tensor] = None,  # [H, W, D]: the view's teacher map
    object_ids: Optional[torch.Tensor] = None,  # [H, W] integers: the view's object map
    reg3d: bool = False,  # Gaussian Grouping: this step adds the 3D term
):
    """One optimization step. Returns (new_state, metrics dict of device
    scalars: loss, psnr, num_points, overflow, num_pairs). With a feature
    field (cfg.feature_dim > 0) `teacher` is the view's 2D feature map; with
    Gaussian Grouping (cfg.grouping) `object_ids` is the view's object map,
    `reg3d` says whether this step adds L_3d, and the metrics add `knn`, the
    3D term's neighbour rows [m, k] (-1 on a step without it)."""
    params = state.params
    dev = params.device
    group = cfg.grouping
    if params.feature_dim != cfg.feature_dim:
        raise ValueError(f"the state's feature field has {params.feature_dim} channels, "
                         f"the config {cfg.feature_dim}")
    if group is not None:
        if state.classifier is None or object_ids is None:
            raise ValueError("Gaussian Grouping needs a classifier in the state and the "
                             "view's object map")
    elif cfg.feature_dim and (teacher is None or teacher.shape[-1] != cfg.feature_dim):
        raise ValueError(f"a feature field of {cfg.feature_dim} channels needs a teacher map "
                         f"of as many, got {None if teacher is None else tuple(teacher.shape)}")
    tracing.phase("project", dev)
    leaves = {f: x.detach().requires_grad_(True) for f, x in tree_leaves(params).items()}
    offset = torch.zeros((params.capacity, 2), dtype=torch.float32, device=dev,
                         requires_grad=True)
    cls = {} if group is None else {
        f: getattr(state.classifier.params, f).detach().requires_grad_(True)
        for f in CLASSIFIER_FIELDS}
    out = render(
        camera, GaussianParams(**leaves), alive=state.alive, bg=bg,
        active_sh_degree=active_sh_degree, mean2d_offset=offset, backend=backend,
        pair_budget=pair_budget, features=leaves.get(FEATURES),
    )
    crop = _edge_crop(camera.height, camera.width, cfg.cut_edge)
    pred, gt = _crop(crop, out["render"], camera.image)
    tracing.phase("loss", dev)
    loss = photometric_loss(pred, gt, cfg.lambda_dssim)
    knn = None
    if group is not None:
        GROUPING_STEPS.add(1, key="identity")
        tracing.phase("obj_loss", dev)
        # the identity terms' backward runs first; the photometric one opens loss_bwd
        ident = tracing.phase_in_backward(out["feature"], "loss_bwd")
        ident, ids = _crop(crop, ident, object_ids)
        classifier = Classifier(**cls)
        l2d = identity_loss(ident, ids, classifier)
        if reg3d:
            GROUPING_STEPS.add(1, key="reg3d")
            loss = loss + tracing.phase_in_backward(l2d, "obj_loss_bwd")
            tracing.phase("reg3d", dev)
            l3d, knn = reg3d_loss(leaves[FEATURES], classifier, params.means, state.alive,
                                  state.step, group)
            loss = loss + l3d
            tracing.phase("reg3d_bwd", dev)
        else:
            loss = loss + l2d
            knn = torch.full(reg3d_shape(group, params.capacity), -1, dtype=torch.int64,
                             device=dev)
            tracing.phase("obj_loss_bwd", dev)
    elif cfg.feature_dim:
        FEATURE_STEPS.add(1, key=3 + cfg.feature_dim)
        tracing.phase("feat_loss", dev)
        # the feature term's backward runs first; the photometric one opens loss_bwd
        feat = tracing.phase_in_backward(out["feature"], "loss_bwd")
        feat, teacher = _crop(crop, feat, teacher)
        loss = loss + cfg.lambda_feature * l1_loss(feat, teacher)
        tracing.phase("feat_loss_bwd", dev)
    else:
        tracing.phase("loss_bwd", dev)
    grads = torch.autograd.grad(loss, list(leaves.values()) + [offset] + list(cls.values()))
    tracing.phase("update", dev)
    gparams = GaussianParams(**dict(zip(leaves, grads[:len(leaves)])))
    dstate = add_stats(state.dstate, grads[len(leaves)], out["radii"], camera.width,
                       camera.height)
    lrs = lr_tree(cfg.hyper, cfg.spatial_lr_scale, state.step, features=bool(cfg.feature_dim))
    new_params, new_adam, new_cls = adam_step(state, gparams, grads[len(leaves) + 1:], lrs,
                                              cfg.hyper)
    with torch.no_grad():
        metrics = dict(
            loss=loss.detach(),
            psnr=psnr(out["render"].detach(), camera.image),
            num_points=num_alive(state.alive),
            overflow=out["overflow"],
            num_pairs=out["num_pairs"],
        )
    if knn is not None:
        metrics["knn"] = knn
    return (
        dataclasses.replace(state, params=new_params, adam=new_adam, dstate=dstate,
                            step=state.step + 1, classifier=new_cls),
        metrics,
    )


def adam_step(state: TrainState, grads: GaussianParams, classifier_grads, lrs: GaussianParams,
              hyper: TrainHyper):
    """Adam over the state's Gaussian leaves and, where the state has a
    classifier, its two leaves (`classifier_grads`, in CLASSIFIER_FIELDS'
    order) at CLASSIFIER_LR and CLASSIFIER_EPS, in one launch: (params,
    AdamState, ClassifierState or None)."""
    if state.classifier is None:
        return adam_update(grads, state.adam, state.params, lrs, hyper) + (None,)
    cs = state.classifier
    lr = torch.full((), CLASSIFIER_LR, dtype=torch.float32, device=state.params.device)
    rows = [(getattr(cs.params, f), g, getattr(cs.mu, f), getattr(cs.nu, f), lr, CLASSIFIER_EPS)
            for f, g in zip(CLASSIFIER_FIELDS, classifier_grads)]
    new_params, new_adam, out = adam_update_with(grads, state.adam, state.params, lrs, hyper,
                                                 rows)
    return new_params, new_adam, ClassifierState(
        *(Classifier(*(o[k] for o in out)) for k in range(3)))


def reg3d_shape(group: GroupingConfig, capacity: int) -> tuple:
    """(m, k): the 3D term's samples and neighbours at `capacity`."""
    cand = min(group.reg3d_max_points, capacity)
    return min(group.reg3d_sample, cand), min(group.reg3d_k, cand)


_CAMERA_TENSORS = ("world_view", "full_proj", "camera_center", "image")


def camera_statics(cam: Camera) -> tuple:
    """The fields a chunk's cameras must share (a graph's static shapes)."""
    return (cam.width, cam.height, cam.fov_x, cam.fov_y, cam.znear, cam.zfar)


def stack_camera_chunk(cams: list) -> Optional[Camera]:
    """The cameras' tensors stacked with a leading K (world_view [K, 4, 4],
    full_proj, camera_center [K, 3], image [K, H, W, 3] or None) and their
    shared statics, for train_scan_step; None where a static field (size,
    FoVs, clip planes) differs: the caller then takes single steps."""
    base = cams[0]
    if any(camera_statics(c) != camera_statics(base) for c in cams):
        return None
    return dataclasses.replace(
        base, image_name="",
        **{f: None if getattr(base, f) is None else torch.stack([getattr(c, f) for c in cams])
           for f in _CAMERA_TENSORS})


def camera_tensors(stack: Camera) -> Dict[str, torch.Tensor]:
    """A stacked camera's tensors, by field (the inputs of a graphed chunk)."""
    return {f: getattr(stack, f) for f in _CAMERA_TENSORS if getattr(stack, f) is not None}


def camera_at(stack: Camera, tensors: Dict[str, torch.Tensor], j: int) -> Camera:
    """View j of a chunk: the statics of `stack`, row j of each tensor."""
    return dataclasses.replace(
        stack, **{f: t[j] for f, t in tensors.items() if f in _CAMERA_TENSORS})


def train_scan_step(
    state: TrainState,
    cam_stack: Camera,  # tensors stacked with a leading K (stack_camera_chunk)
    bgs: torch.Tensor,  # [K, 3]
    cfg: TrainConfig,
    active_sh_degree: int,
    backend: str = "tiled",
    pair_budget: Optional[int] = None,
    runner: Optional[GraphRunner] = None,
    teacher: Optional[torch.Tensor] = None,  # [V, H, W, D] teacher maps of every view
    views: Optional[torch.Tensor] = None,  # [K] int64: each step's row of the map banks
    object_ids: Optional[torch.Tensor] = None,  # [V, H, W] object maps of every view
    iteration: int = 1,  # the global iteration of the chunk's first step
):
    """K dependent train steps in one dispatch: on a CUDA device one replay
    of a graph that captured the K steps (`runner` caches the graphs; pass
    the same runner for every chunk, or each call captures anew), on the
    CPU the K steps eagerly. Returns (state, metrics stacked [K]). With a
    feature field, step j's teacher map is row views[j] of `teacher`, read
    inside the graph (the maps are not copied into its inputs); with
    Gaussian Grouping so is its object map, of `object_ids`, and step j adds
    the 3D term where iteration + j falls on the term's interval.

    On CUDA the returned state's tensors are the runner's static buffers,
    rewritten by the next replay of the same graph; the state handed in is
    left as it was. The statics (K, SH degree, budget, backend, config,
    camera statics, the state's shapes and, with Gaussian Grouping, the
    first iteration's residue modulo the 3D term's interval) key the
    graph, so a chunk that changes any of them is captured anew."""
    k = bgs.shape[0]
    inputs = dict(camera_tensors(cam_stack), bgs=bgs)
    if teacher is not None or object_ids is not None:
        inputs["views"] = views
    group = cfg.grouping

    def row(bank, inp, j):
        return None if bank is None else torch.index_select(bank, 0, inp["views"][j:j + 1])[0]

    def body(carry, inp):
        st = tree_build(TrainState, carry)
        per_step = []
        for j in range(k):
            st, m = train_step(st, camera_at(cam_stack, inp, j), inp["bgs"][j], cfg,
                               active_sh_degree, backend, pair_budget,
                               teacher=row(teacher, inp, j), object_ids=row(object_ids, inp, j),
                               reg3d=group is not None and group.reg3d_at(iteration + j))
            per_step.append(m)
        return tree_leaves(st), {name: torch.stack([m[name] for m in per_step])
                                 for name in per_step[0]}

    def bank(x):
        return None if x is None else (x.data_ptr(), tuple(x.shape), x.dtype)

    runner = runner or GraphRunner(state.params.device)
    phase = None if group is None else iteration % group.reg3d_interval
    key = ("train", k, active_sh_degree, pair_budget, backend, cfg,
           camera_statics(cam_stack), bank(teacher), bank(object_ids), phase,
           state.params.capacity)
    # chunks that differ only in K share one warm-up
    carry, metrics = runner.run(key, body, tree_leaves(state), inputs, key[:1] + key[2:])
    return tree_build(TrainState, carry), metrics


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
    """Capacity growth: every tensor of a Gaussian's rows (the parameters,
    their moments, `alive` and the densify statistics; not the classifier)
    is padded; new slots are dead, with opacity logit -20 and zero
    moments."""
    cap = state.params.capacity

    def pad(name, x):
        if x.dim() == 0 or name.startswith("classifier."):
            return x
        fill = -20.0 if name == "params.opacity_logits" else 0
        out = torch.full((cap * factor,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                         device=x.device)
        out[:cap] = x
        return out

    return tree_build(TrainState, {k: pad(k, x) for k, x in tree_leaves(state).items()})


def tuned_pair_budget(pairs: int) -> int:
    """Pair budget for a measured pair count: 1.25x headroom rounded up to
    quarter-power-of-two granules, below binning's 2^24 ceiling."""
    want = max(8192, int(pairs * 1.25))
    granule = max(8192, 1 << max(int(np.log2(want)) - 2, 0))
    out = -(-want // granule) * granule
    return min(out, (1 << 24) - 8192)


def _to_device(ints: list, dev: torch.device) -> torch.Tensor:
    """int64 [len(ints)] on `dev`, copied from pinned memory so that the
    host does not wait for the stream's queued work."""
    host = torch.tensor(ints, dtype=torch.int64)
    if dev.type == "cuda":
        host = host.pin_memory()
    return host.to(dev, non_blocking=True)


def chunk_length(s: int, steps_per_dispatch: int, left: int) -> int:
    """Steps of the chunk that starts at global iteration `s`: at most
    `steps_per_dispatch` and `left`, ending at the next multiple of 10 (so
    that every cadence of the loop, all multiples of 10, falls on a chunk's
    end) and before the next multiple of 1000 (so that no chunk crosses a
    change of the SH degree): the JAX package's rule."""
    n = min(steps_per_dispatch, left)
    n = min(n, 10 * (-(-s // 10)) - s + 1)
    return min(n, 1000 * (s // 1000) + 1000 - s)


@tracing.spanned("sgt.train_loop")
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
    steps_per_dispatch: int = 1,
    tb_dir: Optional[str] = None,
    runner: Optional[GraphRunner] = None,
    teacher: Optional[torch.Tensor] = None,
    object_ids: Optional[torch.Tensor] = None,
):
    """Single-device driver, the JAX package's train_loop step for step:
    cameras in the order `np.random.default_rng(shuffle_seed)` permutes
    them, SH warm-up, densify / reset cadence, and the adaptive pair budget
    (doubles on overflow, re-tunes every 50 iterations from the pair count;
    its decisions read the largest overflow and pair count over the steps
    of the previous check, 10 steps stale). An explicit `pair_budget`
    disables the adaptation.

    Steps go in chunks of up to `steps_per_dispatch` (chunk_length). With
    `steps_per_dispatch` > 1 every chunk whose cameras share their statics
    is one train_scan_step, however short: on a CUDA device one CUDA-graph
    replay, captured once per set of statics (a new budget, SH degree or
    capacity captures anew; graphs whose SH degree or capacity cannot recur
    are dropped). With 1, and for a chunk of cameras whose statics differ,
    train_step runs step by step. A chunk's backgrounds are drawn at once.
    Densify, opacity reset and the capacity growth run eagerly between
    chunks. `tb_dir`
    logs the JAX package's TensorBoard scalars every 10 iterations and the
    opacity histogram every 1000 (utils.logging_utils.TBLogger; nothing
    without tensorboard); its `train/iter_time`, and the step time that
    `log_every` prints, is the newest finished chunk's time a step
    (utils.logging_utils.ChunkClock: on a CUDA device the device's, read
    without a wait). `runner` keeps the graphs across calls: a run cut
    into many calls (the parity harness's 50-iteration chunks) passes one
    runner to all of them and captures each set of statics once, as the
    JAX package's jit cache outlives a call; by default every call makes
    its own. With a feature field, `teacher` [V, H, W, D] holds the 2D
    teacher map of each of the V `cameras`, in their order; with Gaussian
    Grouping (cfg.grouping), `object_ids` [V, H, W] (uint8) their object
    maps.

    Returns (state, log): log["loss"] / ["psnr"] / ["overflow"] /
    ["num_pairs"] are device tensors with one entry per step, log["budget"]
    the pair budget of each step, log["cameras"] the image name of each
    step's camera, log["chunks"] the (first iteration, steps) of each
    chunk, log["densify"] a list of (iteration, alive count after, dropped)
    per densify, log["history"] the (iteration, metrics as floats) printed
    every `log_every` steps, and log["graphs"] the runner's captures and
    replays; with Gaussian Grouping log["knn"] holds the 3D term's neighbour
    rows of the last chunk's steps [n, m, k] (-1 on steps without it)."""
    iters = num_iters or cfg.iterations
    dev = state.params.device
    bg = torch.ones(3, device=dev) if cfg.white_background else torch.zeros(3, device=dev)
    rng = np.random.default_rng(shuffle_seed)
    order: list = []
    adaptive = pair_budget is None
    if adaptive:
        pair_budget = default_pair_budget(state.params.capacity)
    pending_check = None
    tb = TBLogger(tb_dir) if tb_dir else None
    clock = ChunkClock(dev, on=bool((tb is not None and tb.active) or log_every))
    runner = runner or GraphRunner(dev)
    keys = ("loss", "psnr", "overflow", "num_pairs")
    log = {k: torch.zeros(iters, dtype=torch.float32, device=dev) for k in keys}
    log.update(budget=[], cameras=[], chunks=[], densify=[], history=[])

    if cfg.grouping is not None:
        if object_ids is None or object_ids.shape[0] != len(cameras):
            raise ValueError("Gaussian Grouping needs one object map a camera")
    elif cfg.feature_dim and (teacher is None or teacher.shape[0] != len(cameras)):
        raise ValueError("a feature field needs one teacher map a camera")

    def pick_view():
        nonlocal order
        if not order:
            order = list(rng.permutation(len(cameras)))
        return order.pop()

    rel = 0
    while rel < iters:
        s = iter_offset + rel + 1  # the chunk's first global iteration
        n = chunk_length(s, steps_per_dispatch, iters - rel)
        sh_deg = min(cfg.max_sh_degree, s // 1000)
        with tracing.span("sgt.loop.prep"):
            picked = [pick_view() for _ in range(n)]
            cams = [cameras[i] for i in picked]
            if cfg.random_background:
                bgs = torch.rand((n, 3), generator=generator, device=dev)
            else:
                bgs = bg.expand(n, 3)
            stack = stack_camera_chunk(cams) if steps_per_dispatch > 1 else None
        with clock.chunk(n):
            if stack is not None:
                banked = teacher is not None or object_ids is not None
                views = _to_device(picked, dev) if banked else None
                state, per = train_scan_step(state, stack, bgs, cfg, sh_deg, backend,
                                             pair_budget, runner, teacher, views,
                                             object_ids, s)
            else:
                with tracing.span("sgt.train_step.eager"):
                    steps = []
                    for j, cam in enumerate(cams):
                        state, m = train_step(
                            state, cam, bgs[j], cfg, sh_deg, backend=backend,
                            pair_budget=pair_budget,
                            teacher=None if teacher is None else teacher[picked[j]],
                            object_ids=None if object_ids is None else object_ids[picked[j]],
                            reg3d=cfg.grouping is not None and cfg.grouping.reg3d_at(s + j))
                        steps.append(m)
                    per = {k: torch.stack([m[k] for m in steps]) for k in steps[0]}
                    tracing.phase("between", dev)
        it = s + n - 1  # the chunk's last global iteration
        with tracing.span("sgt.loop.log"):
            log["budget"] += [pair_budget] * n
            log["cameras"] += [c.image_name for c in cams]
            log["chunks"].append((s, n))
            for k in keys:
                log[k][rel:rel + n] = per[k]
            if "knn" in per:
                log["knn"] = per["knn"]
        if adaptive and it % 10 == 0:
            with tracing.span("sgt.loop.budget"):
                skip_record = False
                if pending_check is not None:
                    ov, pairs, chk_it = pending_check
                    if int(ov) > 0:
                        pair_budget *= 2
                        # this chunk ran under the old budget: wait for one
                        # that ran under the new one before judging again
                        skip_record = True
                    elif chk_it % 50 == 0:
                        want = tuned_pair_budget(int(pairs))
                        if want > pair_budget or want < pair_budget * 2 // 3:
                            pair_budget = want
                pending_check = None if skip_record else (
                    per["overflow"].max(), per["num_pairs"].max(), it)
        if tb is not None and tb.active and it % 10 == 0:
            with tracing.span("sgt.loop.log"):
                tb.scalar("train/loss", per["loss"][-1], it)
                tb.scalar("train/psnr", per["psnr"][-1], it)
                tb.scalar("train/total_points", per["num_points"][-1], it)
                tb.scalar("train/iter_time", clock.read(), it)
                tb.scalar("train/pair_overflow", per["overflow"].max(), it)
                if it % 1000 == 0:
                    tb.histogram("scene/opacity_histogram",
                                 state.params.opacity[state.alive].cpu().numpy(), it)
        if it < cfg.densify_until_iter:
            if it > cfg.densify_from_iter and it % cfg.densification_interval == 0:
                with tracing.span("sgt.loop.densify"):
                    state, dropped = densify_step(
                        state, scene_extent, cfg,
                        use_screen_size=it > cfg.opacity_reset_interval, generator=generator,
                    )
                    alive_n = int(num_alive(state.alive))
                    log["densify"].append((it, alive_n, int(dropped)))
                    if alive_n > 0.85 * state.params.capacity:
                        state = grow_capacity(state)
                        cap = state.params.capacity
                        runner.drop(lambda key: key[0] == "train" and key[-1] != cap)
            if it % cfg.opacity_reset_interval == 0 or (
                cfg.white_background and it == cfg.densify_from_iter
            ):
                with tracing.span("sgt.loop.densify"):
                    state = opacity_reset_step(state)
        if min(cfg.max_sh_degree, (it + 1) // 1000) > sh_deg:
            runner.drop(lambda key: key[0] == "train" and key[2] <= sh_deg)
        if log_every:
            with tracing.span("sgt.loop.log"):
                for j in range(n):
                    itj = s + j
                    if itj % log_every == 0:
                        mf = {k: float(v[j]) for k, v in per.items()}
                        log["history"].append((itj, mf))
                        print(f"iter {itj}: loss {mf['loss']:.4f} psnr {mf['psnr']:.2f} "
                              f"pts {int(mf['num_points'])} "
                              f"step {clock.read() * 1e3:.1f} ms ({clock.source})")
        rel += n
    if tb is not None:
        tb.close()
    log["graphs"] = dict(captures=runner.captures, replays=runner.replays)
    return state, log
