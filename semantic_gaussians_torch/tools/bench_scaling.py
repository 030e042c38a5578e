"""Multi-device scaling of band rendering: rays/s at 1..N ranks.

Port of the root tools/bench_scaling.py (band mode). One view's tile rows
are split across the ranks (parallel.render_sharded.render_sharded); each
iteration is the gradient of the MSE to a random target through it, with
the pair budget 655,360 / ranks a band. The scene is the root tool's: seed
0, 100,000 Gaussians of bench.py's spread 4 units in front of the camera,
SH degree 0 with uniform DC, identity rotations, 640x480.

One process a rank over torch.distributed (NCCL on the cards, gloo on the
CPU), spawned as tools.launch_multihost spawns them
(parallel.multihost.spawn_ranks, one rank a card). For every count in
(1, 2, 4, 8, 16, 32) up to the world size, the first `count` ranks render
the view as `count` bands: one warm-up iteration, then ITERS = 5 timed.
Prints one JSON line a count: mode, devices, rays_per_s, step_ms and
scaling_efficiency (rays/s over count x the one-rank rays/s).

    python -m semantic_gaussians_torch.tools.bench_scaling [--procs N] [--device cpu]

`--procs` defaults to every visible card (one on the CPU).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from ..core.gaussians import FIELDS, GaussianParams, params_from_numpy
from ..ops import kernels
from ..parallel import multihost
from ..parallel.mesh import Mesh
from ..parallel.render_sharded import render_sharded
from ..utils.camera import make_camera
from ..utils.device import resolve_device, synchronize

N, WIDTH, HEIGHT = 100_000, 640, 480
COUNTS = (1, 2, 4, 8, 16, 32)
ITERS = 5
BAND_BUDGET = 655_360  # pairs over all bands; each band gets its share
TIMEOUT_S = 900.0  # the process group's collectives, and the wait for the ranks


def scaling_scene(n: int, width: int, height: int, device):
    """The root tool's scene, drawn in its order: (params, alive, camera,
    target)."""
    rng = np.random.default_rng(0)
    pts = (rng.normal(size=(n, 3)).astype(np.float32) * np.array([1.6, 1.1, 1.0], np.float32)
           + np.array([0, 0, 4], np.float32))
    sh_dc = rng.uniform(size=(n, 1, 3)).astype(np.float32)
    log_scales = rng.uniform(-4.5, -3.0, size=(n, 3)).astype(np.float32)
    opacity_logits = rng.uniform(-1.0, 1.5, size=(n, 1)).astype(np.float32)
    quats = np.zeros((n, 4), np.float32)
    quats[:, 0] = 1.0
    params = params_from_numpy(dict(
        means=pts, sh_dc=sh_dc, sh_rest=np.zeros((n, 0, 3), np.float32), log_scales=log_scales,
        quats=quats, opacity_logits=opacity_logits), device)
    cam = make_camera(np.eye(3), np.zeros(3), 1.4, 1.1, width, height, device=device)
    target = torch.from_numpy(rng.uniform(size=(height, width, 3)).astype(np.float32))
    return params, torch.ones(n, dtype=torch.bool, device=device), cam, target.to(device)


def band_mesh(count: int):
    """A 1D mesh ("data") of the world's first `count` ranks, or None on a
    rank outside them. Every rank must call it, in the same order (it makes
    a process group). Without a process group: the one-rank mesh."""
    if not dist.is_initialized():
        return Mesh(("data",), (1,), (0,), (None,))
    group = dist.new_group(list(range(count)))
    rank = dist.get_rank()
    return Mesh(("data",), (count,), (rank,), (group,)) if rank < count else None


def band_grads(cam, params: GaussianParams, alive, target, mesh: Mesh, budget: int):
    """d mean((band render - target)^2) / d each leaf (FIELDS order), the
    view split into the mesh's bands; every rank of the mesh holds them."""
    leaves = {f: getattr(params, f).detach().requires_grad_(True) for f in FIELDS}
    out = render_sharded(cam, GaussianParams(**leaves), alive, mesh, pair_budget=budget)
    loss = torch.mean((out["render"] - target) ** 2)
    return torch.autograd.grad(loss, [leaves[f] for f in FIELDS])


def counts_up_to(world: int):
    return [c for c in COUNTS if c <= world]


def scaling_rank(rank: int, world: int, device: str, n: int = N, width: int = WIDTH,
                 height: int = HEIGHT, iters: int = ITERS) -> dict:
    """One rank of the benchmark on `device` ("cuda": the card the launch
    bound; "cpu"), in a process whose group exists (or none: one rank).
    Returns dict(rows: one record a count, from this rank's clock;
    launches: this process's kernel launches by kernel)."""
    dev = multihost.rank_device(device)
    params, alive, cam, target = scaling_scene(n, width, height, dev)
    rows, base = [], None
    for count in counts_up_to(world):
        mesh = band_mesh(count)
        if mesh is None:
            continue
        budget = BAND_BUDGET // count
        band_grads(cam, params, alive, target, mesh, budget)  # warm-up
        synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            g = band_grads(cam, params, alive, target, mesh, budget)
        synchronize(dev)
        dt = (time.perf_counter() - t0) / iters
        if not all(bool(torch.isfinite(x).all()) for x in g):
            raise RuntimeError(f"non-finite band gradients at {count} ranks")
        rays = width * height / dt
        base = base or rays
        rows.append({"mode": "band", "devices": count, "rays_per_s": round(rays, 1),
                     "step_ms": round(dt * 1e3, 2),
                     "scaling_efficiency": round(rays / (base * count), 3)})
    return dict(rows=rows, launches={c.name: c.count for c in kernels.COUNTERS})


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=None,
                    help="ranks (default: every visible card; 1 on the CPU)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    procs = args.procs or (torch.cuda.device_count() if dev.type == "cuda" else 1)
    results = multihost.spawn_ranks(
        scaling_rank, procs, dev.type, timeout=TIMEOUT_S,
        init=dict(device=dev.type, timeout_s=TIMEOUT_S),
        threads=None if dev.type == "cuda" else 1)
    for row in results[0]["rows"]:
        print(json.dumps(row), flush=True)
    launches = {}
    for r in results:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return dict(rows=results[0]["rows"], launches=launches)


if __name__ == "__main__":
    main()
