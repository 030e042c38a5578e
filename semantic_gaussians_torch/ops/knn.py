"""Mean squared distance to the k nearest neighbours (k = 3 by default).

Port of semantic_gaussians_tpu.ops.knn, which sizes new Gaussians at
init. Exact, blocked: each block of queries gets its squared distances to
every point as |q|^2 + |p|^2 - 2 q.p (one matrix product, full float32),
self excluded, and `topk` picks the k smallest. O(N^2) work, but a few
large products: 100k points take well under a second on the card.
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
