"""Plain-PyTorch reference of Gaussian Grouping's training step.

Gaussian Grouping: Ye, Danelljan, Yu and Ke, "Gaussian Grouping: Segment
and Edit Anything in 3D Scenes", ECCV 2024, arXiv 2312.00732 (code:
github.com/lkeab/gaussian-grouping: train.py, utils/loss_utils.py
`loss_cls_3d`, arguments/__init__.py). Every Gaussian i carries, besides
its 3DGS leaves, an identity encoding e_i in R^D (D = 16), composited with
the colour's alpha weights, with no activation,

    E(p) = sum_i e_i alpha_i prod_{j<i} (1 - alpha_j),

here one composite of the [N, 3 + D] columns (SH colour, then e) through
the reference rasterizer (`render.py`). A 1x1 convolution (W [C, D], b
[C], C = 256) maps E to logits; the loss is

    L = (1 - lambda_dssim) L1 + lambda_dssim (1 - SSIM) + L_2d
        + [it % reg3d_interval == 0] L_3d,
    L_2d = mean over pixels of CE(W E(p) + b, id(p)) / ln C,
    L_3d = lambda_3d / (m k C) sum_s sum_{n in kNN(s)} sum_c
           P_sc (ln(P_sc + 1e-10) - ln(P_nc + 1e-10)),

P = softmax(W e_i + b) over every Gaussian, s over m samples of a subset
of candidates, kNN(s) the k nearest candidates by Euclidean distance on
the means (the sample among them). Iterations count from 1. Adam
(torch.optim.Adam's update) trains the 3DGS leaves at the official rates
with eps 1e-15, e at `semantic_feature_lr`, and, as a second optimizer,
W and b at their train.py's fixed lr 5e-4 with torch's eps 1e-8.

Departures from the Gaussian Grouping code, as the benchmark's
configuration runs it:
- the draws: their `torch.randperm` (the candidates, then the samples of
  them) is replaced by ranks of a counter-based integer hash of (seed,
  iteration, row): the candidates are the rows with the `max_points`
  smallest keys, the samples the candidates with the `sample` smallest
  keys of a second stream. Uniform without replacement, as randperm's,
  but another stream of numbers, which a program can draw on the device
  inside a captured graph and this reference can draw again;
- neighbours by squared distances ((dx^2 + dy^2) + dz^2) in float32, ties
  to the lower candidate position (their `torch.cdist` + `topk`);
- the rasterizer is this benchmark's reference of the program's (16x32
  tiles, the exact tile cull, 3DGS's alpha rules), not their CUDA
  rasterizer; the identity channels get no background;
- their classifier is an nn.Conv2d with torch's default init and its own
  Adam; here W and b are given, and Adam's formula is written out.

Nothing here imports the program. Arithmetic is in `dtype` (float32 the
reference, bfloat16 the control); matmuls never use TF32.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from . import render as R
from . import train_step as RT

FIELDS = RT.FIELDS + ("features",)
CLASSIFIER_LR = 5e-4  # their train.py: torch.optim.Adam(lr=5e-4), betas and eps torch's defaults
CLASSIFIER_EPS = 1e-8
CLASSIFIER = ("classifier.weight", "classifier.bias")
MASK = 0xFFFFFFFF
NO_ROW = (1 << 63) - 1


def mix32(x):
    """Thomas Mueller's 32-bit integer hash of x in [0, 2^32) (an int or an
    int64 tensor)."""
    x = (((x >> 16) ^ x) * 0x45D9F3B) & MASK
    x = (((x >> 16) ^ x) * 0x45D9F3B) & MASK
    return (x >> 16) ^ x


def keys(seed: int, stream: int, iteration: int, x: torch.Tensor, tie: torch.Tensor):
    """31 bits of hash(seed, stream, iteration, x) above the 32 of `tie`."""
    h = mix32(mix32(mix32(seed & MASK) ^ stream) ^ iteration)
    return ((mix32(h ^ x) >> 1) << 32) | tie


def draws(grouping: Dict, iteration: int, alive: torch.Tensor):
    """(candidate rows, their validity, sample positions among the
    candidates, their validity) of `iteration` (stream 1 the candidates,
    stream 2 the samples)."""
    n = alive.shape[0]
    rows = torch.arange(n, dtype=torch.int64, device=alive.device)
    k1 = torch.where(alive, keys(grouping["seed"], 1, iteration, rows, rows), NO_ROW)
    k1 = torch.sort(k1).values[:min(grouping["reg3d_max_points"], n)]
    cand_ok = k1 != NO_ROW
    cand = torch.where(cand_ok, k1 & MASK, 0)
    pos = torch.arange(cand.shape[0], dtype=torch.int64, device=alive.device)
    k2 = torch.where(cand_ok, keys(grouping["seed"], 2, iteration, cand, pos), NO_ROW)
    k2 = torch.sort(k2).values[:min(grouping["reg3d_sample"], cand.shape[0])]
    samp_ok = k2 != NO_ROW
    return cand, cand_ok, torch.where(samp_ok, k2 & MASK, 0), samp_ok


def neighbours(q: torch.Tensor, p: torch.Tensor, k: int) -> torch.Tensor:
    """[m, k] positions of the k points nearest each query, by (squared
    distance, position): each row's stable sort of its distances, cut to
    k."""
    d2 = None
    for c in range(3):
        diff = q[:, None, c] - p[None, :, c]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    return torch.sort(d2, dim=1, stable=True).indices[:, :k]


def loss_3d(feat: torch.Tensor, w: torch.Tensor, b: torch.Tensor, means: torch.Tensor,
            alive: torch.Tensor, iteration: int, grouping: Dict):
    """(L_3d, neighbour rows [m, k], -1 where a sample is invalid)."""
    cand, cand_ok, samp, samp_ok = draws(grouping, iteration, alive)
    with torch.no_grad():
        pts = means.detach()[cand].clone()
        pts[~cand_ok] = float("inf")
        near = neighbours(pts[samp], pts, min(grouping["reg3d_k"], cand.shape[0]))
    m, k = samp.shape[0], near.shape[1]
    prob = torch.softmax(F.linear(feat, w, b), dim=1)
    ps = prob[cand[samp]][:, None]
    pn = prob[cand[near]]
    kl = (ps * (torch.log(ps + 1e-10) - torch.log(pn + 1e-10))).sum(-1)
    use = (samp_ok[:, None] & cand_ok[near]).to(kl.dtype)
    count = max(int(samp_ok.sum()) * k, 1)
    loss = grouping["lambda_3d"] / w.shape[0] * (kl * use).sum() / count
    return loss, torch.where(samp_ok[:, None], cand[near], -1)


def render_joint(params: Dict[str, torch.Tensor], cam: Dict, sh_degree: int,
                 bg: torch.Tensor):
    """(rgb [H, W, 3], identity [H, W, D]), composited together."""
    proj = R.project(params, cam, sh_degree)
    bins = R.Binning(proj, cam["width"], cam["height"])
    colors = torch.cat([proj["colors"], params["features"]], 1)
    bg_all = torch.cat([bg, bg.new_zeros(params["features"].shape[1])]).to(colors.dtype)
    img = R._Composite.apply(proj["means2d"], proj["conic"], proj["opac"], colors, bg_all, bins)
    return img[..., :3], img[..., 3:]


def loss_2d(ident: torch.Tensor, ids: torch.Tensor, w: torch.Tensor,
            b: torch.Tensor) -> torch.Tensor:
    logits = F.linear(ident.reshape(-1, w.shape[1]), w, b)
    return F.cross_entropy(logits, ids.reshape(-1).long()) / math.log(w.shape[0])


def step_loss(leaves: Dict[str, torch.Tensor], cam: Dict, gt: torch.Tensor, ids: torch.Tensor,
              alive: torch.Tensor, iteration: int, hyper: Dict, grouping: Dict, sh_degree: int):
    """(the step's loss, its neighbour rows or None)."""
    bg = torch.zeros(3, dtype=leaves["means"].dtype, device=leaves["means"].device)
    rgb, ident = render_joint(leaves, cam, sh_degree, bg)
    w, b = leaves["classifier.weight"], leaves["classifier.bias"]
    loss = RT.photometric_loss(rgb, gt.to(rgb.dtype), hyper["lambda_dssim"])
    loss = loss + loss_2d(ident, ids, w, b)
    if iteration % grouping["reg3d_interval"]:
        return loss, None
    l3d, near = loss_3d(leaves["features"], w, b, leaves["means"], alive, iteration, grouping)
    return loss + l3d, near


def follow(params0: Dict[str, torch.Tensor], cams: List[Dict], images: Sequence[torch.Tensor],
           ids: Sequence[torch.Tensor], hyper: Dict, grouping: Dict, extent: float,
           first_step: int, sh_degree: int, alive=None, dtype=torch.float32) -> Dict:
    """len(cams) steps of training from `params0` (the 3DGS leaves,
    `features` and the classifier's two) with fresh Adam moments, the k-th
    on cams[k] against images[k] and ids[k]; iteration `first_step` + k.
    Returns each step's loss and neighbour rows (None on steps without the
    3D term), the first step's gradient norm by leaf, and after all the
    steps the norm by leaf of Adam's first moment and of the change of the
    parameters."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _follow(params0, cams, images, ids, hyper, grouping, extent, first_step,
                       sh_degree, alive, dtype)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _follow(params0, cams, images, ids, hyper, grouping, extent, first_step, sh_degree, alive,
            dtype):
    names = FIELDS + CLASSIFIER
    p = {k: params0[k].detach().to(dtype) for k in names}
    if alive is None:
        alive = torch.ones(p["means"].shape[0], dtype=torch.bool, device=p["means"].device)
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2 = 0.9, 0.999
    eps = {k: (CLASSIFIER_EPS if k in CLASSIFIER else 1e-15) for k in names}
    losses, knn, g1 = [], [], None
    for k, (cam, gt, idk) in enumerate(zip(cams, images, ids)):
        leaves = {f: p[f].clone().requires_grad_(True) for f in names}
        loss, near = step_loss(leaves, cam, gt, idk, alive, first_step + k, hyper, grouping,
                               sh_degree)
        grads = dict(zip(names, torch.autograd.grad(loss, [leaves[f] for f in names])))
        del leaves
        losses.append(float(loss.detach()))
        knn.append(near)
        if g1 is None:
            g1 = RT.norms(grads)
        lrs = dict(RT.learning_rates(hyper, extent, first_step + k),
                   features=hyper["semantic_feature_lr"],
                   **{c: CLASSIFIER_LR for c in CLASSIFIER})
        t = k + 1
        with torch.no_grad():
            for f in names:
                g = grads[f]
                m[f] = b1 * m[f] + (1 - b1) * g
                v2[f] = b2 * v2[f] + (1 - b2) * g * g
                mh = m[f] / (1 - b1 ** t)
                vh = v2[f] / (1 - b2 ** t)
                p[f] = p[f] - lrs[f] * mh / (torch.sqrt(vh) + eps[f])
        del grads
    change = RT.norms({f: p[f].double() - params0[f].double() for f in names})
    return dict(losses=losses, knn=knn, grad_norms=g1, moment_norms=RT.norms(m),
                change_norms=change)
