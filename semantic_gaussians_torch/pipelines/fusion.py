"""2D -> 3D projection: fuse per-view 2D features onto Gaussians.

Port of semantic_gaussians_tpu.pipelines.fusion. Every k-th training view
contributes a per-pixel feature map from a 2D predictor; each Gaussian's
centre is projected into the view, tested for occlusion against a depth map
(depth from 'image' | 'render' | 'surface' | none) and, where visible,
gathers the pixel's feature into a running sum with a visit count. The
average and a visited mask are written in the reference's `.pt` layout
{feat: half [M, C], mask_full: bool [N]}, optionally as random point
subsets for distillation.

The accumulators live on the device that holds the Gaussians and are
updated in place. Views go in chunks of `chunk_views` (`_fuse_chunk`: on
CUDA one CUDA-graph replay a chunk, the counterpart of the JAX package's
lax.scan chunk), the last one padded with zero-weight repeats, the chunk
length capped so that the stacked maps stay under
_CHUNK_FEAT_BYTES_BUDGET; `chunk_views` <= 1, a single view, or cameras
whose statics differ (a printed line says so) go view by view, one map on
the device at a time. A chunk accumulates with `fuse_view_dense`, whose
shapes do not depend on the data (a graph holds no data-dependent shape);
the per-view loop with `fuse_view`, which gathers only the visible rows;
the two give the same bits. `make_parallel_fuse_step` fuses one view a
rank and sums the deltas over the ranks (parallel.collectives).
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.gaussians import GaussianParams
from ..data.fusion_utils import compute_mapping, surface_depth
from ..parallel.collectives import psum_many
from ..renderer import render
from ..utils.camera import Camera, fov2focal
from ..utils.graphs import GraphRunner

DEPTH_MODES = ("render", "image", "surface", "none")


@dataclasses.dataclass(frozen=True)
class FusionConfig:
    img_dim: tuple = (648, 484)  # feature-map (W, H)
    every_k_views: int = 5
    depth: str = "render"  # image | render | surface | none
    depth_scale: float = 1000.0
    visibility_threshold: float = 0.05
    cut_boundary: int = 10
    # Views fused per dispatch (on CUDA one CUDA-graph replay); the last
    # chunk is padded with zero-weight repeats. 0 / 1: per view. Capped so
    # that the stacked maps stay under _CHUNK_FEAT_BYTES_BUDGET.
    chunk_views: int = 4
    # Host -> device dtype of the per-view feature maps. float16 halves the
    # dominant transfer and matches the precision 2D features are stored
    # in; accumulation stays float32 either way.
    feat_dtype: str = "float32"


def _intrinsic_for(camera: Camera, img_dim) -> np.ndarray:
    w, h = img_dim
    k = np.eye(3, dtype=np.float32)
    k[0, 0] = fov2focal(camera.fov_x, w)
    k[1, 1] = fov2focal(camera.fov_y, h)
    k[0, 2] = w / 2.0
    k[1, 2] = h / 2.0
    return k


def fuse_view(
    sem_sum: torch.Tensor,  # [cap, C] float32, updated in place
    counts: torch.Tensor,  # [cap] float32, updated in place
    means: torch.Tensor,  # [cap, 3]
    alive: torch.Tensor,  # [cap] bool
    world_view: torch.Tensor,  # [4, 4]
    intrinsic: torch.Tensor,  # [3, 3]
    feat_map: torch.Tensor,  # [H, W, C], float32 or float16
    depth_map: Optional[torch.Tensor],  # [H, W] or None
    img_dim: tuple,
    vis_thres: float,
    cut_bound: int,
    weight=None,  # 0/1 (a scalar or a [] tensor); 0 skips the view
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Accumulate one view's features onto the Gaussians; returns the two
    accumulators it was given. Only the visible Gaussians' rows are
    gathered (in the map's dtype) and added, so no [cap, C] temporary is
    built. `weight` gates the whole view (a padded slot of a batch of
    views contributes nothing)."""
    mapping = compute_mapping(
        world_view, means, intrinsic, img_dim, depth_map, vis_thres, cut_bound
    )
    mask = (mapping[:, 2] > 0) & alive
    if weight is not None:
        mask &= torch.as_tensor(weight, device=mask.device) > 0
    rows = torch.nonzero(mask)[:, 0]
    v, u = mapping[rows, 0].long(), mapping[rows, 1].long()
    # rows are distinct, so the adds below have one writer per element
    sem_sum.index_add_(0, rows, feat_map[v, u].to(sem_sum.dtype))
    counts.index_add_(0, rows, torch.ones_like(rows, dtype=counts.dtype))
    return sem_sum, counts


def fuse_view_dense(
    sem_sum: torch.Tensor,  # [cap, C] float32, updated in place
    counts: torch.Tensor,  # [cap] float32, updated in place
    means: torch.Tensor,
    alive: torch.Tensor,
    world_view: torch.Tensor,
    intrinsic: torch.Tensor,
    feat_map: torch.Tensor,
    depth_map: Optional[torch.Tensor],
    img_dim: tuple,
    vis_thres: float,
    cut_bound: int,
    weight: Optional[torch.Tensor] = None,  # [] 0/1; 0 adds nothing
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`fuse_view` in shapes that do not depend on the data, as the JAX
    package's fuse_view: every one of the `cap` rows gathers its pixel and
    adds it where the mask holds, exact zeros elsewhere. The sums start at
    +0 and never reach -0, so x + 0.0 is x; rows are distinct, so
    `fuse_view`'s scatter has one writer an element: the two give the same
    bits. Returns the two accumulators it was given."""
    mapping = compute_mapping(
        world_view, means, intrinsic, img_dim, depth_map, vis_thres, cut_bound
    )
    mask = (mapping[:, 2] > 0) & alive
    if weight is not None:
        mask &= weight > 0
    feats = feat_map[mapping[:, 0].long(), mapping[:, 1].long()].to(sem_sum.dtype)
    sem_sum.add_(torch.where(mask[:, None], feats, 0.0))
    counts.add_(mask.to(counts.dtype))
    return sem_sum, counts


def upload_map(feat: np.ndarray, dev: torch.device, staging: list) -> torch.Tensor:
    """One view's feature map on `dev`. For a CUDA device the copy goes
    through one pinned host buffer kept in `staging` (a list the caller
    owns, empty at first) and reused by every view of the same shape."""
    t = torch.from_numpy(np.ascontiguousarray(feat))
    if dev.type != "cuda":
        return t.to(dev)
    if not staging or staging[0].shape != t.shape or staging[0].dtype != t.dtype:
        staging[:] = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)]
    staging[0].copy_(t)
    on_dev = staging[0].to(dev, non_blocking=True)
    torch.cuda.current_stream(dev).synchronize()  # the buffer is reused
    return on_dev


def load_depth_image(depth_path: str, cfg: FusionConfig) -> np.ndarray:
    """A depth image in metres [H, W] float32, resized (nearest) to the
    feature maps' size."""
    from PIL import Image

    w, h = cfg.img_dim
    d = np.asarray(Image.open(depth_path)).astype(np.float32)
    if d.shape != (h, w):
        d = np.asarray(Image.fromarray(d).resize((w, h), Image.NEAREST))
    return d / np.float32(cfg.depth_scale)


def view_depth(
    depth_mode: str,
    camera: Camera,
    params: GaussianParams,
    alive: torch.Tensor,
    intrinsic: torch.Tensor,
    cfg: FusionConfig,
    depth_path: Optional[str] = None,
    backend: str = "tiled",
    tile_shape=None,
) -> Optional[torch.Tensor]:
    """The [H, W] depth map one view's occlusion test reads, or None:
    rendered ('render'), loaded from a depth image ('image'), made from
    the Gaussian centres ('surface')."""
    if depth_mode == "render":
        kw = {} if tile_shape is None else {"tile_shape": tile_shape}
        return render(camera, params, alive=alive, override_shape=cfg.img_dim,
                      backend=backend, **kw)["depth"]
    if depth_mode == "image":
        return torch.from_numpy(load_depth_image(depth_path, cfg)).to(params.device)
    if depth_mode == "surface":
        return surface_depth(camera.world_view, params.means, intrinsic, cfg.img_dim,
                             cfg.cut_boundary, valid=alive)
    return None


def make_parallel_fuse_step(
    mesh,
    img_dim: tuple,
    vis_thres: float,
    cut_bound: int,
    depth_mode: str = "render",
    backend: str = "tiled",
    axis: str = "data",
):
    """View-parallel fusion: a batch of views fused in one step, one view a
    rank. step(sem, counts, params, alive, cams, intrinsics, feats, weights)
    -> (sem, counts): rank c takes slot c of the batch (cams a sequence of
    Cameras, intrinsics [K, 3, 3], feats [K, H, W, C], weights [K] 0/1, 0 a
    padded slot), renders its depth ('render'; 'surface' from the centres;
    'none'), accumulates its own (features, counts) delta with fuse_view,
    and the deltas are summed over the ranks onto the replicated
    accumulators. The Gaussians are replicated (fusion only reads them), so
    the deltas' all-reduce is the one collective."""
    if depth_mode not in ("render", "surface", "none"):
        raise ValueError(f"unknown depth mode {depth_mode!r}")

    def step(sem, counts, params, alive, cams, intrinsics, feats, weights):
        k = mesh.coord(axis)
        if len(cams) != mesh.size(axis):
            raise ValueError(f"{len(cams)} views for the {mesh.size(axis)} ranks of '{axis}'")
        dev = params.device
        cam = cams[k].to(dev)
        intr = torch.as_tensor(intrinsics[k]).to(dev)
        with torch.no_grad():
            if depth_mode == "render":
                depth_map = render(cam, params, alive=alive, override_shape=img_dim,
                                   backend=backend)["depth"]
            elif depth_mode == "surface":
                depth_map = surface_depth(cam.world_view, params.means, intr, img_dim,
                                          cut_bound, valid=alive)
            else:
                depth_map = None
            dsem, dcnt = fuse_view(
                torch.zeros_like(sem), torch.zeros_like(counts), params.means, alive,
                cam.world_view, intr, torch.as_tensor(feats[k]).to(dev), depth_map, img_dim,
                vis_thres, cut_bound, weight=weights[k],
            )
            dsem, dcnt = psum_many([dsem, dcnt], mesh, axis)
        return sem + dsem, counts + dcnt

    return step


_CHUNK_FEAT_BYTES_BUDGET = 2_500_000_000  # stacked feature maps of a chunk, at 4 bytes a value


def _fuse_chunk(
    runner: GraphRunner,
    sem: torch.Tensor,
    counts: torch.Tensor,
    params: GaussianParams,
    alive: torch.Tensor,
    cam_stack: Camera,  # tensors stacked with a leading K, no images
    inputs: dict,  # intrinsic [K, 3, 3], feat (K maps [H, W, C]), weight [K], depth [K, H, W]
    cfg: FusionConfig,
    depth_mode: str,
    backend: str,
    tile_shape,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K views fused in one dispatch (on CUDA one replay of a graph
    captured per K and statics): each view's depth ('render' or 'surface'
    made inside, 'image' handed in) and its masked accumulation. Returns
    the two accumulators."""
    from .train import camera_at, camera_statics, camera_tensors

    k = inputs["weight"].shape[0]

    def body(carry, inp):
        sem_sum, cnt = carry["sem"], carry["counts"]
        for j in range(k):
            cam = camera_at(cam_stack, inp, j)
            if depth_mode == "image":
                depth_map = inp["depth"][j]
            else:
                depth_map = view_depth(depth_mode, cam, params, alive, inp["intrinsic"][j], cfg,
                                       backend=backend, tile_shape=tile_shape)
            fuse_view_dense(sem_sum, cnt, params.means, alive, cam.world_view,
                            inp["intrinsic"][j], inp["feat"][j], depth_map, cfg.img_dim,
                            cfg.visibility_threshold, cfg.cut_boundary, weight=inp["weight"][j])
        return {"sem": sem_sum, "counts": cnt}, {}

    key = ("fuse", k, depth_mode, backend, None if tile_shape is None else tuple(tile_shape),
           tuple(cfg.img_dim), cfg.visibility_threshold, cfg.cut_boundary,
           camera_statics(cam_stack))
    carry, _ = runner.run(key, body, {"sem": sem, "counts": counts},
                          dict(camera_tensors(cam_stack), **inputs))
    return carry["sem"], carry["counts"]


def fuse_scene(
    params: GaussianParams,
    alive: torch.Tensor,
    cameras: Sequence[Camera],
    feature_provider,
    cfg: FusionConfig = FusionConfig(),
    image_paths: Optional[Sequence[str]] = None,
    depth_paths: Optional[Sequence[str]] = None,
    tile_shape=None,
    backend: str = "tiled",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fuse features over every k-th view, on the device that holds
    `params`. Returns (features [cap, C] float32 averaged, visited [cap]
    bool). Views go in chunks of `cfg.chunk_views` (see the module
    docstring). Depth mode 'image' reads `depth_paths`, one depth PNG a
    camera, and raises a ValueError without them."""
    from .train import camera_statics, stack_camera_chunk

    dev = params.device
    cap = params.capacity
    c = feature_provider.embedding_dim
    sem = torch.zeros((cap, c), dtype=torch.float32, device=dev)
    counts = torch.zeros((cap,), dtype=torch.float32, device=dev)
    depth_mode = cfg.depth if cfg.depth not in (None, "None") else "none"
    if depth_mode not in DEPTH_MODES:
        raise ValueError(f"unknown depth mode {cfg.depth!r}")
    if depth_mode == "image" and depth_paths is None:
        raise ValueError("depth mode 'image' needs depth_paths, one depth PNG per camera")
    staging: list = []

    def load_feat(vi):
        path = image_paths[vi] if image_paths is not None else (
            cameras[vi].image_name or str(vi))
        feat = np.asarray(feature_provider.extract_image_feature(path, cfg.img_dim),
                          np.dtype(cfg.feat_dtype))
        return upload_map(feat, dev, staging)

    views = list(range(len(cameras)))[:: cfg.every_k_views]
    w, h = cfg.img_dim
    k = min(cfg.chunk_views, max(1, _CHUNK_FEAT_BYTES_BUDGET // (4 * w * h * c)))
    homogeneous = len({camera_statics(cameras[vi]) for vi in views}) <= 1
    if k > 1 and len(views) > 1 and not homogeneous:
        print(f"fusion: cameras are not homogeneous (width/height/fov/clip differ); falling "
              f"back to per-view dispatch for {len(views)} views (a chunk needs one captured "
              "shape)")
    with torch.no_grad():
        if k > 1 and len(views) > 1 and homogeneous:
            runner = GraphRunner(dev)
            for start in range(0, len(views), k):
                batch = views[start:start + k]
                pad = k - len(batch)
                idxs = batch + [batch[-1]] * pad
                cam_stack = stack_camera_chunk(
                    [dataclasses.replace(cameras[vi], image=None).to(dev) for vi in idxs])
                feats = [load_feat(vi) for vi in batch]
                inputs = dict(
                    feat=feats + [feats[-1]] * pad,
                    intrinsic=torch.from_numpy(np.stack(
                        [_intrinsic_for(cameras[vi], cfg.img_dim) for vi in idxs])).to(dev),
                    weight=torch.tensor([1.0] * len(batch) + [0.0] * pad, device=dev),
                )
                if depth_mode == "image":
                    inputs["depth"] = torch.from_numpy(np.stack(
                        [load_depth_image(depth_paths[vi], cfg) for vi in idxs])).to(dev)
                sem, counts = _fuse_chunk(runner, sem, counts, params, alive, cam_stack, inputs,
                                          cfg, depth_mode, backend, tile_shape)
                del feats, inputs
        else:
            for vi in views:
                cam = cameras[vi].to(dev)
                feat = load_feat(vi)
                intrinsic = torch.from_numpy(_intrinsic_for(cam, cfg.img_dim)).to(dev)
                depth_map = view_depth(
                    depth_mode, cam, params, alive, intrinsic, cfg,
                    depth_paths[vi] if depth_mode == "image" else None, backend, tile_shape,
                )
                fuse_view(
                    sem, counts, params.means, alive, cam.world_view, intrinsic, feat,
                    depth_map, cfg.img_dim, cfg.visibility_threshold, cfg.cut_boundary,
                )
                del feat
        visited = counts > 0
        sem = sem / torch.clamp(counts, min=1.0)[:, None]
    return sem, visited


def save_fused_features(
    out_path,
    features: np.ndarray,
    visited: np.ndarray,
    n_split_points: int = 999_999_999,
    num_rand_file_per_scene: int = 1,
    seed: int = 0,
):
    """Write {feat: half [M, C], mask_full: bool [N]} to `out_path`. With
    `n_split_points` below the visited count each file holds a random subset
    of that many visited points (numpy `default_rng(seed).choice`, as the
    JAX package draws it); with several files per scene they are named
    `<stem>_<k><suffix>`."""
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    features = np.asarray(features, np.float32)
    visited = np.asarray(visited).astype(bool)
    n = visited.shape[0]
    n_vis = int(visited.sum())
    rng = np.random.default_rng(seed)
    for k in range(num_rand_file_per_scene):
        if n_split_points < n_vis:
            sel_idx = rng.choice(np.where(visited)[0], n_split_points, replace=False)
            mask_full = np.zeros(n, bool)
            mask_full[sel_idx] = True
        else:
            mask_full = visited
        feat = torch.from_numpy(features[mask_full]).half()
        name = (
            out_path if num_rand_file_per_scene == 1
            else out_path.with_name(f"{out_path.stem}_{k}{out_path.suffix}")
        )
        torch.save({"feat": feat, "mask_full": torch.from_numpy(mask_full)}, name)


def load_fused_features(
    path,
    capacity: Optional[int] = None,
    device: Union[str, torch.device] = "cpu",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Load a {feat, mask_full} .pt file -> (features [cap, C] float32,
    visited [cap] bool) on `device`."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    mask = obj["mask_full"].bool()
    feat = obj["feat"].float()
    n = mask.shape[0]
    cap = capacity or n
    out = torch.zeros((cap, feat.shape[-1]), dtype=torch.float32)
    out_mask = torch.zeros(cap, dtype=torch.bool)
    out_mask[:n] = mask
    out[out_mask] = feat
    return out.to(device), out_mask.to(device)
