"""Gaussian Grouping's identity field, classifier and losses.

Gaussian Grouping: Ye, Danelljan, Yu and Ke, "Gaussian Grouping: Segment
and Edit Anything in 3D Scenes", ECCV 2024, arXiv 2312.00732 (code:
github.com/lkeab/gaussian-grouping). Every Gaussian i carries an identity
encoding e_i in R^D (their `num_objects`, 16): the state's `features`
leaf, composited with the colour's own alpha weights, with no activation
and no background,

    E(p) = sum_i e_i alpha_i prod_{j<i} (1 - alpha_j).

A 1x1 convolution with bias (W [C, D], b [C]; C their `num_classes`, 256)
maps E to per-pixel logits. Two terms train the field and the classifier
beside the photometric loss:

    L_2d = mean over the view's pixels of CE(W E(p) + b, id(p)) / ln C
           (`identity_loss`; id the view's integer object map);
    L_3d = lambda_3d / (m k C) sum_s sum_{n in kNN(s)} sum_c
           P_sc (ln(P_sc + 1e-10) - ln(P_nc + 1e-10))
           (`reg3d_loss`, every `reg3d_interval`-th iteration),

P = softmax(W e_i + b) over every Gaussian; the m samples s and the
candidates n are drawn from the alive Gaussians, kNN(s) are the k nearest
candidates by Euclidean distance on the detached means (the sample itself
among them), as their `loss_cls_3d` has it. A separate Adam trains W and
b at their train.py's fixed rate and torch's default eps (CLASSIFIER_LR,
CLASSIFIER_EPS), in the same launch as the Gaussians' leaves
(pipelines.train.adam_step).

The draws. Their code takes `torch.randperm` twice: a uniform subset of
`reg3d_max_points` candidates, then `reg3d_sample` samples of those. Here
both are ranks of a counter-based integer hash of (seed, iteration, row),
computed on the device from the state's step: the candidates are the
alive rows with the smallest keys, the samples the candidates with the
smallest keys of a second stream. Uniform without replacement as
randperm's, but another stream of numbers; capturable (no host value,
no generator state) and the same in every replay of a graph at the same
iteration, so a reference can draw the same rows.

The neighbours: squared distances sum_c (q_c - p_c)^2 in float32, one
coordinate at a time (never a matrix product, which could round in TF32
and reorders near-ties); ties go to the lower candidate position
(ops.knn.knn_indices).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ..ops.knn import knn_indices
from ..utils.sh import C0

CLASSIFIER_FIELDS = ("weight", "bias")
CLASSIFIER_LR = 5e-4  # their train.py's torch.optim.Adam(lr=5e-4)
CLASSIFIER_EPS = 1e-8  # torch.optim.Adam's default; the Gaussians' leaves take 1e-15
MASK32 = 0xFFFFFFFF
_MUL = 0x45D9F3B
NO_ROW = torch.iinfo(torch.int64).max  # the key of a row that may not be drawn
CANDIDATES, SAMPLES = 1, 2  # the draws' two streams


@dataclasses.dataclass(frozen=True)
class GroupingConfig:
    """Gaussian Grouping's loss terms (their `arguments` defaults); `seed`
    keys the 3D term's draws."""

    num_classes: int = 256
    lambda_3d: float = 2.0
    reg3d_interval: int = 2
    reg3d_k: int = 5
    reg3d_max_points: int = 300_000
    reg3d_sample: int = 1000
    seed: int = 0

    def reg3d_at(self, iteration: int) -> bool:
        """Whether iteration `iteration` (the first is 1) adds L_3d."""
        return iteration % self.reg3d_interval == 0


@dataclasses.dataclass(frozen=True)
class Classifier:
    """The 1x1 convolution from the identity field to class logits."""

    weight: torch.Tensor  # [C, D]
    bias: torch.Tensor  # [C]


@dataclasses.dataclass(frozen=True)
class ClassifierState:
    """The classifier with its Adam moments (AdamState's layout; the step
    count is the train state's `adam.count`, as both optimizers step
    together)."""

    params: Classifier
    mu: Classifier
    nu: Classifier


def init_classifier(num_classes: int, dim: int, generator: torch.Generator,
                    device) -> Classifier:
    """torch.nn.Conv2d(dim, num_classes, 1)'s default init: weight and bias
    uniform in +-1 / sqrt(dim), drawn from `generator`."""
    bound = 1.0 / math.sqrt(dim)

    def draw(shape):
        u = torch.rand(shape, generator=generator, device=generator.device)
        return ((u * 2.0 - 1.0) * bound).to(device)

    return Classifier(weight=draw((num_classes, dim)), bias=draw((num_classes,)))


def classifier_state(classifier: Classifier) -> ClassifierState:
    """`classifier` with zero moments."""
    zero = Classifier(*(torch.zeros_like(getattr(classifier, f)) for f in CLASSIFIER_FIELDS))
    return ClassifierState(params=classifier, mu=zero, nu=zero)


def identity_init(num: int, dim: int, generator: torch.Generator, device) -> torch.Tensor:
    """[num, dim] float32: their initial identity encoding, RGB2SH of a
    uniform draw."""
    u = torch.rand((num, dim), generator=generator, device=generator.device)
    return ((u - 0.5) / C0).to(device)


def identity_loss(identity: torch.Tensor, ids: torch.Tensor,
                  classifier: Classifier) -> torch.Tensor:
    """L_2d: the mean cross-entropy of the logits W E(p) + b against the
    integer ids [H, W] over the pixels of `identity` [H, W, D], over ln C."""
    weight, bias = classifier.weight, classifier.bias
    logits = F.linear(identity.reshape(-1, weight.shape[1]), weight, bias)
    return F.cross_entropy(logits, ids.reshape(-1).long()) / math.log(weight.shape[0])


def mix32(x):
    """A 32-bit integer hash (Thomas Mueller's) of x in [0, 2^32): a
    Python int or an int64 tensor (no product leaves 64 bits)."""
    x = (((x >> 16) ^ x) * _MUL) & MASK32
    x = (((x >> 16) ^ x) * _MUL) & MASK32
    return (x >> 16) ^ x


def draw_keys(seed: int, stream: int, iteration: torch.Tensor, x: torch.Tensor,
              tie: torch.Tensor) -> torch.Tensor:
    """int64 keys: 31 bits of the hash of (seed, stream, iteration, x) above
    the 32 bits of `tie` (< 2^32), so that keys are unique where `tie` is."""
    h = mix32(mix32(seed & MASK32) ^ stream)
    h = mix32(iteration.to(torch.int64) ^ h)
    return ((mix32(h ^ x) >> 1) << 32) | tie


def reg3d_draws(cfg: GroupingConfig, step: torch.Tensor, alive: torch.Tensor):
    """The draws of iteration step + 1: (candidates [M] rows, candidates'
    validity [M], samples [m] positions among the candidates, samples'
    validity [m]); M = min(max points, capacity), m = min(samples, M). A
    candidate is invalid only where fewer than M rows are alive, a sample
    where fewer than m are."""
    dev = alive.device
    it = step.to(torch.int64) + 1
    rows = torch.arange(alive.shape[0], dtype=torch.int64, device=dev)
    first = torch.where(alive, draw_keys(cfg.seed, CANDIDATES, it, rows, rows), NO_ROW)
    first = torch.sort(first).values[:min(cfg.reg3d_max_points, alive.shape[0])]
    cand_ok = first != NO_ROW
    cand = torch.where(cand_ok, first & MASK32, 0)
    pos = torch.arange(cand.shape[0], dtype=torch.int64, device=dev)
    second = torch.where(cand_ok, draw_keys(cfg.seed, SAMPLES, it, cand, pos), NO_ROW)
    second = torch.sort(second).values[:min(cfg.reg3d_sample, cand.shape[0])]
    samp_ok = second != NO_ROW
    return cand, cand_ok, torch.where(samp_ok, second & MASK32, 0), samp_ok


def reg3d_loss(identity: torch.Tensor, classifier: Classifier, means: torch.Tensor,
               alive: torch.Tensor, step: torch.Tensor,
               cfg: GroupingConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L_3d, the neighbours' rows [m, k], -1 where a sample is invalid)
    at iteration step + 1, over the classifier's softmax of every row of
    `identity` [N, D]."""
    cand, cand_ok, samp, samp_ok = reg3d_draws(cfg, step, alive)
    with torch.no_grad():
        inf = torch.full((), float("inf"), dtype=torch.float32, device=means.device)
        pts = torch.where(cand_ok[:, None], means.detach()[cand], inf)
        near = knn_indices(pts[samp], pts, cfg.reg3d_k)
    k, m = near.shape[1], samp.shape[0]
    weight, bias = classifier.weight, classifier.bias
    prob = torch.softmax(F.linear(identity, weight, bias), dim=1)
    near_rows = cand[near]
    picked = prob[torch.cat([cand[samp], near_rows.reshape(-1)])]
    ps = picked[:m, None]
    pn = picked[m:].reshape(m, k, -1)
    kl = (ps * (torch.log(ps + 1e-10) - torch.log(pn + 1e-10))).sum(-1)
    use = (samp_ok[:, None] & cand_ok[near]).to(kl.dtype)
    count = torch.clamp(samp_ok.sum() * k, min=1).to(kl.dtype)
    loss = cfg.lambda_3d / weight.shape[0] * (kl * use).sum() / count
    return loss, torch.where(samp_ok[:, None], near_rows, -1)
