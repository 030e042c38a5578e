"""Plain reference of distillation: the item and the first training steps.

The item, as the reference's dataset/feature_dataset.py makes it: the
scene's 56 raw parameters a Gaussian ([opacity logit, SH DC, SH rest,
log-scales, quaternion]) at its centre; ElasticDistortion (granularity /
magnitude (0.2, 0.4) and (0.8, 1.6), applied with probability 0.95), floor
quantisation at the voxel size keeping each voxel's first point, the fused
feature of that point as the target (where it is visited and non-zero), a
horizontal flip of each of x and y with probability 0.95 x 0.5, the cut to
`voxel_budget` voxels by a random subset, padding to the budget. Each
stage draws from its own numpy stream of the item's seed, as the program
documents. The training loop's own draws (the order, each item's seed,
the random shift of its coordinates) come from one numpy stream of the
loop's seed.

The step: the reference MinkUNet34A (`unet.py`) in training mode, the
cosine loss over supervised voxels, AdamW (beta 0.9 / 0.999, eps 1e-8,
weight decay 0.01) at the cosine-decayed rate. `allow_tf32` makes the
control: the same arithmetic with TF32 matmuls.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import scipy.interpolate
import scipy.ndimage
import torch

from . import unet as U


def _fold(seed: int, stream: int) -> int:
    return int(np.random.SeedSequence([seed, stream]).generate_state(1)[0])


def _elastic(coords: np.ndarray, granularity: float, magnitude: float, rng) -> np.ndarray:
    blur = [np.ones(s).astype("float32") / 3 for s in ((3, 1, 1, 1), (1, 3, 1, 1), (1, 1, 3, 1))]
    cmin = coords.min(0)
    dim = ((coords - cmin).max(0) // granularity).astype(int) + 3
    noise = rng.standard_normal(size=(*dim, 3)).astype(np.float32)
    for _ in range(2):
        for b in blur:
            noise = scipy.ndimage.convolve(noise, b, mode="constant", cval=0)
    ax = [np.linspace(lo, hi, d) for lo, hi, d in
          zip(cmin - granularity, cmin + granularity * (dim - 2), dim)]
    interp = scipy.interpolate.RegularGridInterpolator(ax, noise, bounds_error=False, fill_value=0)
    return coords + interp(coords) * magnitude


def make_item(locs: np.ndarray, feats: np.ndarray, gt: np.ndarray, gt_mask: np.ndarray,
              seed: int, voxel_size: float, budget: int) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(_fold(seed, 1))
    if rng.random() < 0.95:
        for gran, mag in ((0.2, 0.4), (0.8, 1.6)):
            locs = _elastic(locs, gran, mag, rng)
    vox = np.floor(np.asarray(locs, np.float64) / voxel_size).astype(np.int64)
    vox -= vox.min(0)
    dims = vox.max(0) + 1
    lin = (vox[:, 0] * dims[1] + vox[:, 1]) * dims[2] + vox[:, 2]
    _, first = np.unique(lin, return_index=True)
    vc, vf = vox[first], feats[first]
    vgt = gt[first]
    vmask = gt_mask[first] & (np.linalg.norm(vgt, axis=-1) > 0)
    rng = np.random.default_rng(_fold(seed, 2))
    c = vc.astype(np.float64)
    if rng.random() < 0.95:
        for axis in (0, 1):
            if rng.random() < 0.5:
                c = c.copy()
                c[:, axis] = c[:, axis].max() - c[:, axis]
    vc = c.astype(np.int64)
    vc -= vc.min(0)
    v = len(vc)
    before = v
    if v > budget:
        keep = np.sort(np.random.default_rng(_fold(seed, 3)).choice(v, budget, replace=False))
        vc, vf, vgt, vmask = vc[keep], vf[keep], vgt[keep], vmask[keep]
        v = budget

    def pad(x, dtype):
        out = np.zeros((budget,) + x.shape[1:], dtype)
        out[:v] = x
        return out

    return dict(coords=pad(vc, np.int32), feats=pad(vf, np.float32), gt=pad(vgt, np.float32),
                gt_mask=pad(vmask, bool), mask=pad(np.ones(v, bool), bool), num_voxels=v,
                voxels_before_cut=before)


def loop_draws(seed: int, steps: int, items: int = 1):
    """The loop's draws for its first `steps` steps over a dataset of
    `items` scenes: (item seed, the rng to draw its shift) in order."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < steps:
        for _ in rng.permutation(items):
            out.append(int(rng.integers(1 << 31)))
            yield out[-1], rng
            if len(out) == steps:
                return


def cosine_loss(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    pn = pred / torch.sqrt((pred * pred).sum(-1, keepdim=True) + 1e-12)
    tn = target / torch.sqrt((target * target).sum(-1, keepdim=True) + 1e-12)
    per = 1.0 - (pn * tn).sum(-1)
    m = mask.to(per.dtype)
    return (per * m).sum() / torch.clamp(m.sum(), min=1.0)


@torch.no_grad()
def conv_ops(model: U.MinkUNet, feats: torch.Tensor, topo: U.Topology) -> float:
    """float32 operations of one forward over `topo`, counted from the
    neighbour maps as the layers meet them: two per (live neighbour pair,
    input channel, output channel) of each sparse convolution, two per
    (live child, in, out) of each stride-2 one, two per (live voxel, in,
    out) of the head."""
    ops = [0.0]

    def sparse(mod, args, _out):
        level = args[1]
        nbr = level.nbr if mod.rows is None else level.nbr[mod.rows]
        live = int(((nbr < nbr.shape[1]) & level.mask[None, :]).sum())
        ops[0] += 2.0 * live * mod.kernel.shape[1] * mod.kernel.shape[2]

    def down(mod, args, _out):
        link, parent = args[1], args[2]
        live = int((link.parent_of < parent.coords.shape[0]).sum())
        ops[0] += 2.0 * live * mod.kernel.shape[1] * mod.kernel.shape[2]

    def up(mod, args, _out):
        ops[0] += 2.0 * int(args[2].mask.sum()) * mod.kernel.shape[1] * mod.kernel.shape[2]

    def head(mod, args, _out):
        ops[0] += 2.0 * int(topo.levels[0].mask.sum()) * mod.in_features * mod.out_features

    hooks = []
    for mod in model.modules():
        for cls, fn in ((U.SparseConv, sparse), (U.SparseConvDown, down), (U.SparseConvUp, up)):
            if type(mod) is cls:
                hooks.append(mod.register_forward_hook(fn))
    hooks.append(model.head.register_forward_hook(head))
    try:
        model.eval()
        model(feats, topo)
    finally:
        for h in hooks:
            h.remove()
    return ops[0]


def count_ops(model_seed: int, item: Dict[str, np.ndarray], cfg: Dict, device) -> float:
    """conv_ops of the reference model over one item's voxels."""
    model = U.mink_unet(cfg["in_channels"], cfg["feature_dim"], cfg["model_3d"],
                        seed=model_seed, device=device)
    coords = torch.from_numpy(np.ascontiguousarray(item["coords"])).to(device)
    mask = torch.from_numpy(item["mask"]).to(device)
    feats = torch.from_numpy(item["feats"]).to(device)
    return conv_ops(model, feats, U.build_topology(coords, mask))


def follow(model_seed: int, items: List[Dict[str, np.ndarray]], cfg: Dict, scenes: int,
           device, allow_tf32: bool = False) -> Dict:
    """The first len(items) steps from a fresh model drawn from
    `model_seed`, item k's coordinates already shifted. Returns each step's
    loss, the first step's gradient norm by parameter, and the norm of each
    parameter's change over the steps."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    try:
        model = U.mink_unet(cfg["in_channels"], cfg["feature_dim"], cfg["model_3d"],
                            seed=model_seed, device=device)
        p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
        opt = torch.optim.AdamW(model.parameters(), lr=cfg["lr"], betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=cfg["weight_decay"])
        decay = cfg["epochs"] * scenes  # the schedule spans all epochs of all scenes
        losses, g1 = [], None
        for k, it in enumerate(items):
            t = {f: torch.from_numpy(np.ascontiguousarray(it[f])).to(device)
                 for f in ("coords", "feats", "gt", "gt_mask", "mask")}
            topo = U.build_topology(t["coords"], t["mask"])
            model.train()
            out = model(t["feats"], topo)[:, :cfg["feature_dim"]]
            loss = cosine_loss(out, t["gt"], t["gt_mask"])
            opt.zero_grad(set_to_none=True)
            loss.backward()
            step = torch.tensor(min(k, decay), dtype=torch.float32)
            lr = float(cfg["lr"] * 0.5 * (1 + torch.cos(torch.tensor(np.pi, dtype=torch.float32)
                                                          * step / decay)))
            for group in opt.param_groups:
                group["lr"] = lr
            opt.step()
            losses.append(float(loss.detach()))
            if g1 is None:
                g1 = {n: float(torch.linalg.vector_norm(opt.state[p]["exp_avg"].double())) / 0.1
                      for n, p in model.named_parameters()}
        change = {n: float(torch.linalg.vector_norm(p.detach().double() - p0[n].double()))
                  for n, p in model.named_parameters()}
        return dict(losses=losses, grad_norms=g1, change_norms=change)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
