"""Trace the bench train step on the device and print its time by op.

Port of the root tools/profile_step.py. The scene is bench.py's law (seed
0: `--n` Gaussians 4 units in front of the camera, uniform colours as SH
DC, density-scaled log-scales, identity rotations), seen by
make_camera(eye, 0, 1.4, 1.1, W, H). A probe render sizes the pair budget
(pipelines.train.tuned_pair_budget); the step is the gradient of an MSE to
a random target, applied with a step of 1e-30 (the scene stays put). After
a warm-up, STEPS eager steps are traced with torch.profiler (an eager step
launches the same kernels as a CUDA-graph replay of it) and the top 45 ops
a step are printed by device time, with the device's busy share: the
traced steps' device time over the wall time of as many untraced steps
(the profiler lengthens the wall it traces).

    python -m semantic_gaussians_torch.tools.profile_step [--n 100000]
        [--width 640] [--height 480] [--device cpu]

On the CPU there is no device timeline, so the host's ops are listed.
"""
from __future__ import annotations

import argparse
import shutil
import tempfile
import time
from pathlib import Path

import torch

from ..utils.device import resolve_device, synchronize
from ..utils.logging_utils import device_busy_ms, profile_trace, top_ops
from .bench import bench_scene, fwd_bwd_step, probe_budget

STEPS = 5
TOP_K = 45


def _timed_steps(step, state, device, steps: int):
    """(state after `steps` calls of `state = step(state)`, wall ms a call)."""
    t0 = time.perf_counter()
    for _ in range(steps):
        state = step(state)
    synchronize(device)
    return state, (time.perf_counter() - t0) * 1e3 / steps


def profile_steps(step, state, trace_dir, device, steps: int = STEPS, k: int = TOP_K):
    """One warm-up call of `state = step(state)`, `steps` calls timed
    untraced, then `steps` calls traced into `trace_dir`. Returns dict(rows
    [(ms a step, op)], device_only, wall_ms a step untraced, traced_wall_ms
    a step (the profiler's: longer), device_busy_ms a step and
    device_busy_share, device_busy_ms over the untraced wall_ms)."""
    state = step(state)
    synchronize(device)
    state, wall_ms = _timed_steps(step, state, device, steps)
    shutil.rmtree(trace_dir, ignore_errors=True)
    with profile_trace(trace_dir):
        state, traced_wall_ms = _timed_steps(step, state, device, steps)
    on_device = torch.device(device).type == "cuda"
    busy = device_busy_ms(trace_dir) / steps if on_device else None
    return dict(rows=top_ops(trace_dir, k=k, steps=steps, device_only=on_device),
                device_only=on_device, steps=steps, wall_ms=wall_ms,
                traced_wall_ms=traced_wall_ms, device_busy_ms=busy,
                device_busy_share=None if busy is None else busy / wall_ms)


def print_table(title: str, prof: dict) -> None:
    rows = prof["rows"]
    total = sum(ms for ms, _ in rows)
    where = "device" if prof["device_only"] else "host (no device timeline)"
    print(f"{title}: top {len(rows)} ops by {where} time a step ({prof['steps']} steps "
          f"traced); shown total {total:.3f} ms; wall {prof['wall_ms']:.3f} ms a step "
          f"untraced, {prof['traced_wall_ms']:.3f} traced"
          + ("" if prof["device_busy_ms"] is None else
             f"; device busy {prof['device_busy_ms']:.3f} ms "
             f"({100 * prof['device_busy_share']:.1f}% of the untraced wall)"))
    for ms, name in rows:
        print(f"{ms:8.3f} ms  {name[:110]}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    params, alive, cam, target = bench_scene(args.n, args.width, args.height, dev)
    budget, pairs = probe_budget(cam, params, alive)
    print(f"pairs={pairs} tuned budget={budget}")
    with tempfile.TemporaryDirectory(prefix="profile_step_") as tmp:
        step = fwd_bwd_step(cam, alive, target, budget)
        prof = profile_steps(lambda p: step(p)[0], params, Path(tmp), dev)
    print_table("bench step", prof)
    return dict(prof, pairs=pairs, budget=budget)


if __name__ == "__main__":
    main()
