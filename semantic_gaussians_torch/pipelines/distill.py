"""3D distillation: train the sparse UNet to predict fused 2D features.

Port of semantic_gaussians_tpu.pipelines.distill (the reference's
distill.py:60-148): MinkUNet34A (56 -> embedding_dim), AdamW with a cosine
decay over all steps, the cosine-similarity loss over voxels with
supervision, a random global coordinate shift per item, periodic
checkpoints and an every-N-epoch semantic render of a validation scene.
Data preparation is host-side (FeatureDataset); the step (topology, UNet
forward and backward, AdamW) runs on the device the model lives on;
`make_parallel_distill_step` trains one scene a rank of a mesh axis. The
functions that make a model or a scene's tensors take `device` through
`utils.device.resolve_device`: CUDA unless the caller asks for the CPU.

Checkpoints use the JAX package's format: the Flax variables tree
({"params", "batch_stats"}) as numpy arrays, pickled to model_<epoch>.npz,
so that a checkpoint from either package loads in the other.
"""
from __future__ import annotations

import dataclasses
import pickle
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from ..data.feature_dataset import DistillItem, FeatureDataset
from ..models.unet3d import (
    GRID_MAX, MaskedBatchNorm, MinkUNet, build_topology, mink_unet, unet_state_from_flax,
    unet_state_to_flax,
)
from ..parallel.collectives import flat_rows, psum, split_rows
from ..utils.device import resolve_device
from ..utils.losses import cosine_distill_loss, l1_loss, l2_loss
from ..utils.schedules import cosine_decay_schedule

Device = Union[str, torch.device, None]


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    model_3d: str = "MinkUNet34A"
    feature_dim: int = 768
    in_channels: int = 56  # feature_type 'all'
    voxel_size: float = 0.02
    lr: float = 1e-3
    weight_decay: float = 0.01
    epochs: int = 100
    loss_type: str = "cosine"  # cosine | l1 | l2
    aug: bool = True
    # several 2D teachers: the net emits num_heads * feature_dim channels and
    # each fused-feature source supervises its head slice (distill.py:118-124)
    num_heads: int = 1
    head_id: int = 0


def make_distill_state(
    cfg: DistillConfig, steps_per_epoch: int, seed: int = 0, device: Device = None,
):
    """The model (weights drawn from `seed`) on `device` (CUDA by default),
    its AdamW (optax's adamw: b1 0.9, b2 0.999, eps 1e-8, decoupled weight
    decay on every parameter) and the learning-rate schedule the step sets
    before each update."""
    model = mink_unet(cfg.in_channels, cfg.feature_dim * cfg.num_heads, cfg.model_3d, seed=seed,
                      device=resolve_device(device))
    opt = torch.optim.AdamW(model.parameters(), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.weight_decay)
    schedule = cosine_decay_schedule(cfg.lr, cfg.epochs * max(steps_per_epoch, 1))
    return model, opt, schedule


def make_distill_step(model: MinkUNet, opt: torch.optim.Optimizer, schedule, cfg: DistillConfig):
    """step(coords, feats, gt, gt_mask, mask) -> loss (a device scalar):
    the topology, a training-mode forward (batch stats updated), the loss on
    the head slice, the backward, and one AdamW update at schedule(t), t
    the number of updates made before it. Inputs are tensors on the
    model's device."""
    loss_fns = {"l1": l1_loss, "l2": l2_loss}
    lo, hi = cfg.head_id * cfg.feature_dim, (cfg.head_id + 1) * cfg.feature_dim
    count = [0]

    def step(coords, feats, gt, gt_mask, mask):
        topo = build_topology(coords, mask)
        model.train()
        out = model(feats, topo)[:, lo:hi]
        if cfg.loss_type == "cosine":
            loss = cosine_distill_loss(out, gt, mask=gt_mask)
        else:
            m = gt_mask.to(out.dtype)[:, None]
            loss = loss_fns[cfg.loss_type](out * m, gt * m)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        for group in opt.param_groups:
            group["lr"] = schedule(count[0])
        opt.step()
        count[0] += 1
        return loss.detach()

    return step


def make_parallel_distill_step(model: MinkUNet, opt: torch.optim.Optimizer, schedule,
                               cfg: DistillConfig, mesh, axis: str = "data"):
    """Scene-parallel distillation, one scene a rank: step(coords, feats,
    gt, gt_mask, mask) -> loss, each argument a batch with one item a rank
    (stack_items) of which rank c takes slot c. Each rank runs the
    training-mode forward on its own scene (normalizing by its own batch
    statistics) and the backward; the gradients and the loss are averaged
    over the axis before the AdamW update at schedule(t), and the running
    batch statistics are averaged after it. The model, its optimizer and
    every rank's weights start alike."""
    lo, hi = cfg.head_id * cfg.feature_dim, (cfg.head_id + 1) * cfg.feature_dim
    params = list(model.parameters())
    stats = [b for m in model.modules() if isinstance(m, MaskedBatchNorm)
             for b in (m.mean, m.var)]
    n = mesh.size(axis)
    count = [0]

    def step(coords, feats, gt, gt_mask, mask):
        k = mesh.coord(axis)
        if coords.shape[0] != n:
            raise ValueError(f"{coords.shape[0]} scenes for the {n} ranks of '{axis}'")
        topo = build_topology(coords[k], mask[k])
        model.train()
        out = model(feats[k], topo)[:, lo:hi]
        loss = cosine_distill_loss(out, gt[k], mask=gt_mask[k])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        with torch.no_grad():
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            grads = [p.grad.reshape(1, -1) for p in params]
            flat = flat_rows(grads + [loss.reshape(1, 1)])
            mean = split_rows(psum(flat, mesh, axis) / n, grads + [loss.reshape(1, 1)])
            for p, g in zip(params, mean[:-1]):
                p.grad.copy_(g.reshape(p.shape))
            for group in opt.param_groups:
                group["lr"] = schedule(count[0])
            opt.step()
            count[0] += 1
            like = [b.reshape(1, -1) for b in stats]
            avg = split_rows(psum(flat_rows(like), mesh, axis) / n, like)
            for b, a in zip(stats, avg):
                b.copy_(a.reshape(b.shape))
        return mean[-1].reshape(())

    return step


def stack_items(items, device: Device = None):
    """Stack DistillItems into the batches of the parallel step, one item
    a slot: (coords, feats, gt, gt_mask, mask) on `device` (CUDA by
    default)."""
    dev = resolve_device(device)
    return tuple(
        torch.from_numpy(np.stack([getattr(it, f) for it in items])).to(dev)
        for f in ("coords", "feats", "gt", "gt_mask", "mask")
    )


def item_tensors(item: DistillItem, coords: np.ndarray, device):
    """(coords, feats, gt, gt_mask, mask) of an item on `device`."""
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in (
        coords, item.feats, item.gt, item.gt_mask, item.mask))


def distill_scene_features(model: MinkUNet, item: DistillItem) -> torch.Tensor:
    """Inference on one item: its topology built on the model's device and
    one eval-mode forward. Returns the per-voxel features [V, C] (padded
    voxels included)."""
    device = next(model.parameters()).device
    coords = torch.from_numpy(np.ascontiguousarray(item.coords)).to(device)
    mask = torch.from_numpy(np.ascontiguousarray(item.mask)).to(device)
    topo = build_topology(coords, mask)
    model.eval()
    with torch.no_grad():
        return model(torch.from_numpy(np.ascontiguousarray(item.feats)).to(device), topo)


def make_gaussian_features(params, alive, feature_type: str, voxel_size: float,
                           voxel_budget: int):
    """The distilled net's per-Gaussian features of a scene, voxelized once:
    the alive Gaussians' packed parameters (`feature_type`) are voxelized at
    `voxel_size` into `voxel_budget` voxels and the topology is built on the
    Gaussians' device. Returns (the net's input width, features), where
    features(model) runs one eval-mode forward and gives each Gaussian its
    voxel's output, [capacity, C] (zero if its voxel fell past the budget)."""
    from ..core.gaussians import packed_features
    from .eval_segmentation import voxel_feats_to_gaussians, voxelize_for_net

    device = params.means.device
    n_alive = int(alive.sum())
    pf = packed_features(params, alive, feature_type)[:n_alive].cpu().numpy()
    feats_in, topo, inverse, num_valid = voxelize_for_net(
        params.means[:n_alive].cpu().numpy(), pf, voxel_size, voxel_budget, device)

    def features(model: MinkUNet) -> torch.Tensor:
        model.eval()
        with torch.no_grad():
            vout = model(feats_in, topo)
        return voxel_feats_to_gaussians(vout.cpu().numpy(), inverse, n_alive, params.capacity,
                                        num_valid=num_valid, device=device)

    return pf.shape[-1], features


def make_eval_render_hook(
    ply_path,
    cameras,
    text_features,  # [num_classes, feature_dim] (unnormalized ok)
    out_dir,
    cfg: DistillConfig,
    feature_type: str = "all",
    voxel_size: float = 0.02,
    voxel_budget: int = 200_000,
    num_views: int = 3,
    backend: str = "tiled",
    device: Device = None,
):
    """The every-N-epoch semantic render of a validation scene (reference
    distill.py:151-232) on `device` (CUDA by default): the net runs on the
    scene's voxelized Gaussians, each Gaussian takes the palette colour of
    its most similar class, and a few views are rendered to
    out_dir/semantic/<epoch>/<i>.png. The voxelization and topology are
    built once; a call is one forward and `num_views` renders.
    hook(epoch, model) returns the PNGs' directory."""
    from PIL import Image

    from ..core.gaussians import params_from_numpy
    from ..data.scannet_constants import COLORMAP
    from ..io.ply import load_gaussian_ply
    from ..renderer import render

    device = resolve_device(device)
    arrays, alive_np = load_gaussian_ply(ply_path)
    params = params_from_numpy(arrays, device)
    alive = torch.from_numpy(alive_np).to(device)
    _, features = make_gaussian_features(params, alive, feature_type, voxel_size, voxel_budget)

    text = np.asarray(text_features, np.float32)
    text = text / np.maximum(np.linalg.norm(text, axis=-1, keepdims=True), 1e-8)
    text_t = torch.from_numpy(text).to(device)
    # class colours: palette entry i + 1 (0, black, stays for unlabeled)
    pal = torch.from_numpy((COLORMAP[1: len(text) + 1] / 255.0).astype(np.float32)).to(device)
    views = cameras[:num_views]
    out_dir = Path(out_dir)

    def hook(epoch, model):
        g = features(model)
        with torch.no_grad():
            g = g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True), min=1e-8)
            colors = pal[torch.argmax(g @ text_t.T, dim=-1)]
            dirp = out_dir / "semantic" / str(epoch)
            dirp.mkdir(parents=True, exist_ok=True)
            for i, cam in enumerate(views):
                out = render(cam, params, alive=alive, override_color=colors, backend=backend)
                img = torch.clamp(out["render"] * 255, 0, 255).to(torch.uint8).cpu().numpy()
                Image.fromarray(img).save(dirp / f"{i}.png")
        return str(dirp)

    return hook


def train_distill(
    dataset: FeatureDataset,
    cfg: DistillConfig = DistillConfig(),
    num_epochs: Optional[int] = None,
    log_every: int = 0,
    seed: int = 0,
    ckpt_dir: Optional[str] = None,
    save_interval: int = 10,
    eval_hook=None,
    eval_interval: int = 10,
    device: Device = None,
):
    """Epochs over the dataset on `device` (CUDA by default) with a random
    global coordinate shift per item (distill.py:104). The host draws come from one
    numpy default_rng(seed) in the JAX package's order: each epoch's
    permutation, then per item its seed and its shift. Returns (model, its
    AdamW, the per-step losses as floats)."""
    device = resolve_device(device)
    model, opt, schedule = make_distill_state(cfg, len(dataset), seed, device=device)
    step = make_distill_step(model, opt, schedule, cfg)
    rng = np.random.default_rng(seed)
    losses = []
    for epoch in range(num_epochs or cfg.epochs):
        order = rng.permutation(len(dataset))
        for i in order:
            item = dataset.__getitem__(int(i), seed=int(rng.integers(1 << 31)))
            # the shift is capped so that shifted coords stay inside the
            # int32-key grid (no key collisions)
            max_c = int(item.coords.max()) if item.coords.size else 0
            hi = max(1, min(100, GRID_MAX - max_c))
            coords = item.coords + rng.integers(0, hi, size=(1, 3)).astype(np.int32)
            loss = step(*item_tensors(item, coords, device))
            losses.append(float(loss))
        if log_every and (epoch + 1) % log_every == 0:
            print(f"epoch {epoch + 1}: loss {np.mean(losses[-len(dataset):]):.4f}")
        if ckpt_dir and (epoch + 1) % save_interval == 0:
            save_distill_checkpoint(Path(ckpt_dir) / f"model_{epoch + 1}.npz", model)
        if eval_hook and (epoch + 1) % eval_interval == 0:
            eval_hook(epoch + 1, model)  # ref distill.py:141-142
    return model, opt, losses


def save_distill_checkpoint(path, model: MinkUNet) -> None:
    """Pickle the model's weights as the JAX package's variables tree."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(unet_state_to_flax(model), f)


def load_distill_checkpoint(path) -> dict:
    """The variables tree of a checkpoint written by either package (nested
    dicts of numpy arrays); `unet_state_from_flax` makes it a state dict."""
    with open(path, "rb") as f:
        return pickle.load(f)


def load_distill_model(path, in_channels, out_channels, arch, device) -> MinkUNet:
    """A checkpoint's UNet on `device`, in eval mode."""
    model = mink_unet(in_channels, out_channels, arch)
    model.load_state_dict(unet_state_from_flax(load_distill_checkpoint(path), model))
    return model.to(device).eval()
