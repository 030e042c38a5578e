"""Multi-process launch rehearsal on the CPU: the SGTPU_* launch path of
parallel.multihost.init_distributed, over gloo.

Starts `procs x local` CPU processes on this machine, each with the
variables a multi-node launch gives it (SGTPU_COORDINATOR, SGTPU_NUM_PROCS,
SGTPU_PROC_ID, LOCAL_RANK, LOCAL_WORLD_SIZE). Every process builds the
(view = node, band = rank in the node) mesh, gathers each node's camera
into the global batch (multihost.global_batch_from_local), runs hybrid
train steps, replicated and ZeRO, and checks that every rank holds the
same parameters; rank 0 prints the verdict, "multihost rehearsal OK".

Usage:
    python -m semantic_gaussians_torch.tools.launch_multihost \\
        [--procs 2] [--local 2] [--steps 2] [--timeout 300] [--coordinator URL]

The processes are spawned by parallel.multihost.spawn_ranks. The
coordinator defaults to a file:// store in the temporary directory; a
host:port uses TCP. The parent waits at most `--timeout` seconds, stops
every process it started, and exits non-zero if any rank failed.
"""
from __future__ import annotations

import argparse
import sys


def worker(rank: int, world: int, steps: int) -> None:
    """One rank: its process group from the SGTPU_* variables."""
    import numpy as np
    import torch

    from ..core.gaussians import FIELDS, init_from_pcd
    from ..parallel import multihost
    from ..parallel.collectives import all_gather
    from ..parallel.train_parallel import (
        gather_moments, make_hybrid_train_step, make_hybrid_train_step_zero, shard_moments,
        stack_cameras,
    )
    from ..pipelines.train import TrainConfig, init_train_state
    from ..utils.camera import Camera, make_camera

    if not multihost.init_distributed(device="cpu", timeout_s=120.0):
        raise RuntimeError("no SGTPU_* launch variables: run through the launcher")
    mesh = multihost.make_view_band_mesh()
    rng = np.random.default_rng(0)  # the same scene on every rank (replicated params)
    pts = (rng.normal(size=(300, 3)) * 0.5 + [0, 0, 4]).astype(np.float32)
    cols = rng.uniform(size=(300, 3)).astype(np.float32)
    params, alive = init_from_pcd(pts, cols, sh_degree=2, capacity=512)
    h, w = 64, 128
    view = mesh.coord("view")
    image = np.random.default_rng(100 + view).uniform(size=(h, w, 3)).astype(np.float32)
    cam = make_camera(np.eye(3), np.array([0.05 * view, 0, 0]), 1.2, 0.9, w, h, image=image)
    # each node contributes its own view; the batch is gathered over "view"
    local = {k: getattr(cam, k)[None] for k in ("world_view", "full_proj", "camera_center",
                                                "image")}
    batch = multihost.global_batch_from_local(local, mesh, "view")
    cams = stack_cameras([
        Camera(**{k: batch[k][v] for k in batch}, width=w, height=h, fov_x=1.2, fov_y=0.9)
        for v in range(mesh.size("view"))
    ])
    bg = torch.zeros(3)
    sums = []
    for zero in (False, True):
        state = init_train_state(params, alive)
        make = make_hybrid_train_step_zero if zero else make_hybrid_train_step
        step = make(mesh, TrainConfig(), 1, h, w)
        if zero:
            state = shard_moments(state, mesh, "band")
        for _ in range(steps):
            state, metrics = step(state, cams, bg)
        if zero:
            state = gather_moments(state, mesh, "band")
        loss = float(metrics["loss"])
        if not np.isfinite(loss):
            raise RuntimeError(f"loss {loss}")
        sums.append(float(sum(getattr(state.params, f).double().sum() for f in FIELDS)))
        multihost.primary_print(f"[multihost] zero={zero} mesh={mesh.shape} steps={steps} "
                                f"loss={loss:.5f} psnr={float(metrics['psnr']):.2f}")
    every = all_gather(torch.tensor([sums], dtype=torch.float64), multihost.make_data_mesh(),
                       "data")
    if not bool((every == every[0]).all()):
        raise RuntimeError(f"ranks disagree: {every.tolist()}")
    multihost.primary_print("multihost rehearsal OK", flush=True)


def main(argv=None) -> int:
    from ..parallel.multihost import spawn_ranks

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--procs", type=int, default=2, help="nodes (view rows)")
    ap.add_argument("--local", type=int, default=2, help="ranks a node (bands)")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--coordinator", default=None, help="host:port or an init URL")
    args = ap.parse_args(argv)
    try:
        spawn_ranks(worker, args.procs * args.local, args.steps, timeout=args.timeout,
                    coordinator=args.coordinator, local=args.local, threads=1)
    except (RuntimeError, TimeoutError) as e:
        print(e, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
