"""Nearest neighbours among points.

`knn_mean_sq_dist`: the mean squared distance to the k nearest neighbours
(k = 3 by default), port of semantic_gaussians_tpu.ops.knn, which sizes
new Gaussians at init. Exact, blocked: each block of queries gets its
squared distances to every point as |q|^2 + |p|^2 - 2 q.p (one matrix
product, full float32), self excluded, and `topk` picks the k smallest.
O(N^2) work, but a few large products: 100k points take well under a
second on the card.

`knn_indices`: which points are the k nearest, for Gaussian Grouping's 3D
term (core.grouping), where the indices themselves must be reproducible:
squared distances as sum_c (q_c - p_c)^2, one coordinate at a time in
float32 (no matrix product, so no TF32 and no cancellation reordering
near-ties), and ties to the lower index.
"""
from __future__ import annotations

import torch


def knn_mean_sq_dist(points: torch.Tensor, k: int = 3, block_q: int = 2048) -> torch.Tensor:
    """[N] mean of the squared distances from each point to its k nearest
    others. With fewer than k others, the mean of those there are; with none,
    1e-7."""
    pts = points.to(torch.float32)
    n = pts.shape[0]
    kk = min(k, n - 1)
    if kk <= 0:
        return torch.full((n,), 1e-7, dtype=torch.float32, device=pts.device)
    p_sq = torch.sum(pts * pts, dim=-1)
    out = torch.empty(n, dtype=torch.float32, device=pts.device)
    for q0 in range(0, n, block_q):
        q = pts[q0:q0 + block_q]
        d2 = p_sq[q0:q0 + block_q, None] + p_sq[None, :] - 2.0 * (q @ pts.T)
        rows = torch.arange(q.shape[0], device=pts.device)
        d2[rows, rows + q0] = float("inf")
        d2 = torch.clamp(d2, min=0.0)
        out[q0:q0 + block_q] = torch.topk(d2, kk, dim=1, largest=False).values.mean(dim=1)
    return out


def knn_indices(queries: torch.Tensor, points: torch.Tensor, k: int) -> torch.Tensor:
    """[m, k] int64: the indices of the k points [M, 3] nearest to each
    query [m, 3] (a query that is one of the points finds itself), nearest
    first, by squared distances ((dx^2 + dy^2) + dz^2) in float32 and, at
    equal distances, by the lower index. A point at infinity is never
    nearer than a finite one. `topk` takes a few more than k, which the
    (distance, index) order then cuts to k: exact wherever fewer than four
    extra points tie at the k-th distance."""
    d2 = queries[:, 0, None] - points[None, :, 0]
    d2.mul_(d2)
    for c in (1, 2):
        diff = queries[:, c, None] - points[None, :, c]
        d2.add_(diff.mul_(diff))
    dist, idx = torch.topk(d2, min(k + 3, points.shape[0]), dim=1, largest=False)
    idx, order = torch.sort(idx, dim=1)
    dist = torch.gather(dist, 1, order)
    order = torch.sort(dist, dim=1, stable=True).indices[:, :k]
    return torch.gather(idx, 1, order)
