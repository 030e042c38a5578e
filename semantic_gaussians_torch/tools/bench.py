"""Headline benchmark of the port: rays/s per chip, forward+backward, 640x480.

Port of the root bench.py. The scene is bench.py's law (seed 0: `--n`
Gaussians 4 units in front of the camera, uniform colours as SH DC, SH
degree 3 with the rest zero, log-scales shifted by the density, identity
rotations), seen by make_camera(eye, 0, 1.4, 1.1, W, H); the loss is the
MSE to a random target. A probe render sizes the pair budget
(pipelines.train.tuned_pair_budget of its pair count). The dispatch is
INNER = 10 dependent steps, each `p - 1e-30 * dMSE/dp` (with
`--forward-only`: a render whose first pixel, times 1e-30, is added to the
means), captured once into a CUDA graph by utils.graphs.GraphRunner (its
warm-up and capture, then one replay) and replayed ITERS = 3 times; a step
takes the replays' wall time over 30.

Prints one JSON line with bench.py's keys: metric, value (rays/s), unit,
vs_baseline (over a nominal 1e8 rays/s for the CUDA reference's fwd+bwd),
step_ms, pairs (the probe's), device (the card's name and power limit). The
kernel launches of the run go to stderr.

    python -m semantic_gaussians_torch.tools.bench [--n 100000] [--width 640]
        [--height 480] [--forward-only] [--probe-timeout 150] [--device cpu]

`--n 1000000` is BASELINE config #2 (ScanNet-full scale); `--n 5000000
--width 1920 --height 1080` is config #4 (MipNeRF-360 class). Before the
card is used, a child process runs one 128x128 matmul on it under
`--probe-timeout` seconds; a card that does not answer gives one JSON error
line and exit code 3 instead of a hang.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..core.gaussians import FIELDS, GaussianParams, params_from_numpy
from ..ops import kernels
from ..ops.binning import default_pair_budget
from ..pipelines.train import tuned_pair_budget
from ..renderer import render
from ..utils.camera import make_camera
from ..utils.device import card_stamp, resolve_device, synchronize
from ..utils.graphs import GraphRunner

INNER = 10  # dependent steps a dispatch (one graph replay)
ITERS = 3  # timed replays
BASELINE_RAYS_PER_S = 1e8
_PROBE_FLAG = "SGTPU_BENCH_PROBE"
_REPO = Path(__file__).resolve().parents[2]


def bench_scene(n: int, width: int, height: int, device):
    """bench.py's scene law at seed 0: (params, alive, camera, target)."""
    rng = np.random.default_rng(0)
    pts = (rng.normal(size=(n, 3)).astype(np.float32) * np.array([1.6, 1.1, 1.0], np.float32)
           + np.array([0, 0, 4], np.float32))
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    quats = np.zeros((n, 4), np.float32)
    quats[:, 0] = 1.0
    # Splat sizes scale with point density (3-NN spacing ~ n^-1/3), as a
    # real SfM-initialised scene's do; no shift up to 100k.
    density_shift = -np.log(max(n / 1e5, 1.0)) / 3.0
    arrays = dict(
        means=pts,
        sh_dc=((cols - 0.5) / 0.28209479177387814)[:, None, :],
        sh_rest=np.zeros((n, 15, 3), np.float32),
        log_scales=(rng.uniform(-4.5, -3.0, size=(n, 3)) + density_shift).astype(np.float32),
        quats=quats,
        opacity_logits=rng.uniform(-1.0, 1.5, size=(n, 1)).astype(np.float32),
    )
    params = params_from_numpy(arrays, device)
    alive = torch.ones(n, dtype=torch.bool, device=device)
    cam = make_camera(np.eye(3), np.zeros(3), 1.4, 1.1, width, height, device=device)
    target = torch.from_numpy(rng.uniform(size=(height, width, 3)).astype(np.float32)).to(device)
    return params, alive, cam, target


def probe_budget(cam, params, alive):
    """bench.py's budget: (tuned_pair_budget of a probe render's pair
    count, that count). The probe's own budget is capped just under
    binning's 2^24 ceiling. Raises if the probe or the tuned budget
    overflows."""
    n = params.capacity
    with torch.no_grad():
        probe = render(cam, params, alive=alive,
                       pair_budget=max(1 << 20, min(default_pair_budget(n), (1 << 24) - 8192)))
        if int(probe["overflow"]):
            raise RuntimeError(f"probe budget overflow: {int(probe['overflow'])} pairs")
        pairs = int(probe["num_pairs"])
        budget = tuned_pair_budget(pairs)
        over = int(render(cam, params, alive=alive, pair_budget=budget)["overflow"])
    if over:
        raise RuntimeError(f"pair budget overflow: {over} pairs past {budget}")
    return budget, pairs


def mse_grads(cam, alive, target, budget):
    """grads(params) -> (dMSE/d each leaf, in FIELDS order; overflow)."""

    def grads(params: GaussianParams):
        leaves = {f: getattr(params, f).detach().requires_grad_(True) for f in FIELDS}
        out = render(cam, GaussianParams(**leaves), alive=alive, pair_budget=budget)
        loss = torch.mean((out["render"] - target) ** 2)
        return torch.autograd.grad(loss, [leaves[f] for f in FIELDS]), out["overflow"]

    return grads


def fwd_bwd_step(cam, alive, target, budget):
    """step(params) -> (params - 1e-30 * dMSE/dparams, overflow)."""
    grads = mse_grads(cam, alive, target, budget)

    def step(params: GaussianParams):
        g, overflow = grads(params)
        with torch.no_grad():
            return GaussianParams(**{f: getattr(params, f).detach() - 1e-30 * d
                                     for f, d in zip(FIELDS, g)}), overflow

    return step


def forward_step(cam, alive, budget):
    """step(params) -> (params with the first pixel's colour times 1e-30
    added to the means, overflow): a render that the next one depends on."""

    def step(params: GaussianParams):
        with torch.no_grad():
            out = render(cam, params, alive=alive, pair_budget=budget)
            means = params.means + out["render"][0, 0, :3] * 1e-30
        return dataclasses.replace(params, means=means), out["overflow"]

    return step


def chain(step, inner: int):
    """A GraphRunner body: `inner` dependent calls of `step` on the carry
    (the parameters by field); the output is the last call's overflow."""

    def body(carry, _inputs):
        p = GaussianParams(**carry)
        for _ in range(inner):
            p, overflow = step(p)
        return {f: getattr(p, f) for f in FIELDS}, {"overflow": overflow}

    return body


def time_replays(runner: GraphRunner, key, body, carry: dict, iters: int = ITERS):
    """`body` run once by `runner` (on CUDA: its capture and a replay), then
    `iters` times, timed. Returns (the last carry, the last outputs,
    seconds a run)."""
    carry, out = runner.run(key, body, carry, {})
    synchronize(runner.device)
    t0 = time.perf_counter()
    for _ in range(iters):
        carry, out = runner.run(key, body, carry, {})
    synchronize(runner.device)
    return carry, out, (time.perf_counter() - t0) / iters


def _probe_child() -> None:
    """The probe's child process: one matmul on the device it is given."""
    dev = torch.device(os.environ[_PROBE_FLAG])
    x = torch.ones((128, 128), device=dev)
    y = (x @ x).sum().item()
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)
    print("PROBE_OK", name, y)


def probe_backend(device, timeout_s: float = 150.0) -> None:
    """Check that `device` answers before the benchmark commits to it: a
    child process runs one 128x128 matmul there under `timeout_s` seconds.
    A child that does not finish in time is killed with its process group
    and the run exits 3 with one JSON error line ("gpu_wedged"); one that
    fails gives "gpu_probe_failed" and exit code 3 too."""
    t0 = time.perf_counter()
    env = dict(os.environ, **{_PROBE_FLAG: str(device)})
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(_REPO), env.get("PYTHONPATH")]))
    # The child's output goes to a file, not a pipe: a helper that inherits
    # a pipe would keep communicate() waiting after the child is killed.
    with tempfile.TemporaryFile(mode="w+") as log:
        proc = subprocess.Popen([sys.executable, "-m", "semantic_gaussians_torch.tools.bench"],
                                env=env, stdout=log, stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except OSError:
                pass
            proc.wait()
            print(json.dumps({
                "error": "gpu_wedged", "probe_s": round(time.perf_counter() - t0, 1),
                "detail": f"backend probe subprocess exceeded {timeout_s}s on a 128x128 "
                          "matmul; the device is not answering"}))
            sys.exit(3)
        log.seek(0)
        out = log.read()
    if rc != 0 or "PROBE_OK" not in out:
        print(json.dumps({
            "error": "gpu_probe_failed", "probe_s": round(time.perf_counter() - t0, 1),
            "returncode": rc, "detail": out.strip()[-500:]}))
        sys.exit(3)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=100_000,
                    help="Gaussian count; 100k is the headline config, 1M matches BASELINE "
                         "config #2, 5M with --width 1920 --height 1080 config #4")
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--forward-only", action="store_true",
                    help="serving-path throughput: render forward only (the viewer / eval / "
                         "fusion read path), no backward")
    ap.add_argument("--probe-timeout", type=float, default=150.0,
                    help="seconds before the device is declared wedged; 0 disables the probe")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def run(args) -> dict:
    """The benchmark at `args` (parse_args); returns the output record."""
    dev = resolve_device(args.device)
    if dev.type == "cuda" and args.probe_timeout > 0:
        probe_backend(dev, args.probe_timeout)
    w, h, n = args.width, args.height, args.n
    params, alive, cam, target = bench_scene(n, w, h, dev)
    budget, pairs = probe_budget(cam, params, alive)
    step = (forward_step(cam, alive, budget) if args.forward_only
            else fwd_bwd_step(cam, alive, target, budget))
    _, out, dt = time_replays(GraphRunner(dev), ("bench", args.forward_only, budget),
                              chain(step, INNER), {f: getattr(params, f) for f in FIELDS})
    dt /= INNER
    if int(out["overflow"]):
        raise RuntimeError(f"pair budget overflow in the timed chain: {int(out['overflow'])}")
    rays_per_s = w * h / dt
    label = f"{n // 1000}k" if n < 1_000_000 else f"{n / 1e6:g}M"
    mode = "forward/serving" if args.forward_only else "fwd+bwd"
    return {
        "metric": f"rays/s per chip ({mode}), {w}x{h}, {label} Gaussians",
        "value": round(rays_per_s, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays_per_s / BASELINE_RAYS_PER_S, 4),
        "step_ms": round(dt * 1e3, 2),
        "pairs": pairs,
        "device": card_stamp(dev),
    }


def main(argv=None) -> dict:
    record = run(parse_args(argv))
    print("kernel launches", json.dumps({c.name: c.count for c in kernels.COUNTERS}),
          file=sys.stderr)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    if os.environ.get(_PROBE_FLAG):
        _probe_child()
    else:
        main()
