"""The full 30,000-iteration 3DGS protocol on a textured synthetic scene.

Port of the root tools/parity_harness.py. A textured multi-object scene
(checker floor, striped ball, per-face textured box, dust) at `--density`
is the "true" model; ground truth is rendered from it at `--gt-ss` times
the training size and area-averaged down, from a ring of 40 training and 8
held-out views (half a step between training views, as the reference holds
out frames of the same trajectory). Training starts from an SfM-like
init: a random `--init-frac` of the true points, position jitter, colour
noise. The protocol is the train loop's defaults (official_train.yaml:
densify every 100 in (500, 15000), opacity reset every 3000, SH degree +1
every 1000, the exponential xyz schedule), run in calls of `--chunk-iters`
iterations through pipelines.train.train_loop at steps_per_dispatch 10
(CUDA-graph replays) with the fixed pair budget `--pair-budget`, one
GraphRunner kept over the whole run. Held-out PSNR is read 50 iterations
after each multiple of 500 (550, 1050, ...: after the densify and reset
transients have settled) and at the end.

Checks (the JAX tool's): held-out PSNR rises by 3 dB and ends >= 27 dB;
the alive count at 15,000 is 1.3x the init's; no growth after the densify
window; max opacity <= 0.011 right after each opacity reset; no step ran
on a clipped pair list.

    python -m semantic_gaussians_torch.tools.parity_harness [--iters 30000]
        [--out harness_out/parity_harness.json] [--state FILE]
        [--max-seconds S] [--device cpu]

With --state, the train state and the curve are saved after every call of
train_loop and a rerun resumes; past --max-seconds the run saves and exits
with code 3.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pickle
import sys
import time
from pathlib import Path

import numpy as np


def build_true_scene(rng, density: int = 1, return_classes: bool = False):
    """Textured surfaces as true Gaussians: (points [N, 3], colours [N, 3])
    float32, and with `return_classes` the class of each point (0 floor,
    1 ball, 2 box, 3 dust). ~21k points at density 1, ~206k at 3, ~366k at
    4. The texture's wavelengths shrink with the density, so that a sparse
    init cannot represent it and only a densified model resolves it. The
    draws from `rng` and their order are the JAX tool's: the same seed
    gives the same arrays."""
    pts, cols = [], []
    d = density

    # Checker ground plane y = -0.55 over [-1.6, 1.6]^2.
    g = np.linspace(-1.6, 1.6, 110 * d)
    gx, gz = np.meshgrid(g, g)
    gy = np.full_like(gx, -0.55) + rng.normal(0, 0.004, gx.shape)
    cw = 0.12 / d
    cell = ((np.floor(gx / cw) + np.floor(gz / cw)) % 2).astype(bool)
    c = np.where(
        cell[..., None], np.array([0.88, 0.86, 0.80]), np.array([0.16, 0.22, 0.34])
    )
    pts.append(np.stack([gx, gy, gz], -1).reshape(-1, 3))
    cols.append(c.reshape(-1, 3))

    # Striped sphere r = 0.5 (a Fibonacci spiral): longitude stripes times
    # latitude bands.
    n = 6000 * d * d
    i = np.arange(n)
    phi = math.pi * (3.0 - math.sqrt(5.0)) * i
    y = 1 - 2 * (i + 0.5) / n
    r = np.sqrt(1 - y * y)
    sp = 0.5 * np.stack([r * np.cos(phi), y, r * np.sin(phi)], -1)
    lon = np.arctan2(sp[:, 2], sp[:, 0])
    stripes = (np.sin(8 * d * lon) > 0).astype(np.float32)
    bands = (np.sin(7 * d * np.arcsin(np.clip(sp[:, 1] / 0.5, -1, 1))) > 0)
    c = np.stack(
        [
            0.15 + 0.75 * stripes,
            0.2 + 0.6 * bands.astype(np.float32),
            0.8 - 0.6 * stripes,
        ],
        -1,
    )
    pts.append(sp + np.array([0.55, 0.0, 0.1]))
    cols.append(c)

    # Cube shell (side 0.6) at (-0.6, -0.25, -0.2), a hue and a checker a face.
    m = 28 * d
    u = np.linspace(-0.3, 0.3, m)
    uu, vv = np.meshgrid(u, u)
    face_pts, face_cols = [], []
    hues = np.array(
        [[0.9, 0.3, 0.2], [0.2, 0.8, 0.3], [0.25, 0.35, 0.9],
         [0.9, 0.8, 0.2], [0.8, 0.25, 0.8], [0.2, 0.8, 0.8]]
    )
    checker = ((np.floor(uu / (0.1 / d)) + np.floor(vv / (0.1 / d))) % 2)[..., None]
    for f in range(6):
        ax = f // 2
        sign = 1.0 if f % 2 == 0 else -1.0
        p = np.zeros((m, m, 3))
        other = [a for a in range(3) if a != ax]
        p[..., other[0]] = uu
        p[..., other[1]] = vv
        p[..., ax] = 0.3 * sign
        face_pts.append(p.reshape(-1, 3))
        fc = hues[f] * (0.45 + 0.55 * checker)
        face_cols.append(np.broadcast_to(fc, (m, m, 3)).reshape(-1, 3))
    cube = np.concatenate(face_pts) + np.array([-0.6, -0.25, -0.2])
    pts.append(cube)
    cols.append(np.concatenate(face_cols))

    # Sparse dust.
    pts.append(rng.normal(0, 0.8, (800, 3)) * np.array([1.2, 0.5, 1.2]))
    cols.append(rng.uniform(0.2, 0.9, (800, 3)))

    pts = np.concatenate(pts).astype(np.float32)
    cols = np.clip(np.concatenate(cols), 0, 1).astype(np.float32)
    if return_classes:
        n_plane = (110 * d) ** 2
        n_sphere = 6000 * d * d
        n_cube = 6 * (28 * d) ** 2
        cls = np.concatenate([
            np.full(n_plane, 0), np.full(n_sphere, 1),
            np.full(n_cube, 2), np.full(len(pts) - n_plane - n_sphere - n_cube, 3),
        ]).astype(np.int32)
        assert len(cls) == len(pts)
        return pts, cols, cls
    return pts, cols


def ring_camera(i, n, w, h, radius=2.6, height=0.55, fov_x=1.1, make=None):
    """make(c2w, fov_x, fov_y, w, h) for view i of n on a ring around the
    scene, looking at the origin."""
    ang = 2 * math.pi * i / n
    pos = np.array([radius * math.sin(ang), height, -radius * math.cos(ang)])
    fwd = -pos / np.linalg.norm(pos)
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    upv = np.cross(fwd, right)
    c2w = np.eye(4)
    c2w[:3, :3] = np.stack([right, upv, fwd], axis=1)
    c2w[:3, 3] = pos
    return make(c2w, fov_x, fov_x * h / w, w, h)


N_TRAIN, N_TEST = 40, 8
SCENE_EXTENT = 3.2  # the camera ring's normalization radius
GT_PAIR_BUDGET = 4_194_304  # a ground-truth render's pairs, times --gt-ss


def ring_cameras(w, h, dev):
    """(the N_TRAIN training cameras, the N_TEST held-out ones) at w x h:
    the held-out views sit between training views of the same ring."""
    from ..utils.camera import make_camera_from_c2w

    def make(c2w, fov_x, fov_y, cw, ch):
        return make_camera_from_c2w(c2w, fov_x, fov_y, cw, ch, device=dev)

    train = [ring_camera(i + 0.5 / N_TRAIN, N_TRAIN, w, h, make=make) for i in range(N_TRAIN)]
    test = [ring_camera((i + 0.25) * N_TRAIN / N_TEST + 0.5 / N_TRAIN, N_TRAIN, w, h,
                        make=make) for i in range(N_TEST)]
    return train, test


def sfm_init(rng, tpts, tcols, args, dev):
    """The SfM-like sparse noisy init: a random `args.init_frac` of the true
    points with position jitter and colour noise, drawn from `rng` after
    build_true_scene's draws. Returns (params at `args.capacity`, alive,
    the number of points)."""
    from ..core.gaussians import init_from_pcd

    sel = rng.choice(len(tpts), size=max(64, int(len(tpts) * args.init_frac)), replace=False)
    init_pts = tpts[sel] + rng.normal(0, args.init_jitter, (len(sel), 3))
    init_cols = np.clip(
        tcols[sel] + rng.normal(0, args.color_noise, (len(sel), 3)), 0, 1
    ).astype(np.float32)
    params, alive = init_from_pcd(init_pts.astype(np.float32), init_cols, sh_degree=3,
                                  capacity=args.capacity, device=dev)
    return params, alive, len(sel)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=30000)
    ap.add_argument("--width", type=int, default=480)
    ap.add_argument("--height", type=int, default=352)
    ap.add_argument("--out", default="harness_out/parity_harness.json")
    ap.add_argument("--state", default=None, help="resume file (chunked runs)")
    ap.add_argument("--max-seconds", type=float, default=1e9,
                    help="save the state and exit 3 after this budget (resume later)")
    ap.add_argument("--chunk-iters", type=int, default=50,
                    help="iterations a train_loop call: 50 puts the calls' ends at "
                         "boundary + 50, where the PSNR readings are taken")
    ap.add_argument("--pair-budget", type=int, default=1_572_864,
                    help="fixed pair budget (an adaptive one would capture anew at "
                         "every change)")
    ap.add_argument("--init-frac", type=float, default=0.015,
                    help="SfM-like init: this random fraction of the true points")
    ap.add_argument("--density", type=int, default=4,
                    help="true-scene density (~206k Gaussians at 3, ~366k at 4)")
    ap.add_argument("--init-jitter", type=float, default=0.05,
                    help="SfM-like position noise (world units; the scene spans ~3.2)")
    ap.add_argument("--color-noise", type=float, default=0.2, help="SfM-like colour noise")
    ap.add_argument("--gt-ss", type=int, default=2,
                    help="ground truth rendered at this multiple of the training size "
                         "and area-averaged down (sub-pixel detail, as photos have)")
    ap.add_argument("--capacity", type=int, default=131072, help="initial padded capacity")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def atomic_write(path, data: bytes) -> None:
    """Write to a temporary file and rename: a kill mid-write leaves the
    previous state whole."""
    p = Path(path)
    tmp = p.with_name(p.name + ".tmp")
    tmp.write_bytes(data)
    tmp.replace(p)


def run(args):
    """The protocol; returns (report, extra): the report has the JAX tool's
    keys, `extra` this run's timings and graph counts. Raises SystemExit(3)
    when --max-seconds cuts a run that has --state."""
    import torch

    from ..core.gaussians import init_from_pcd
    from ..pipelines.train import TrainConfig, init_train_state, train_loop
    from ..renderer import render
    from ..utils.checkpoint import load_state, save_state
    from ..utils.device import resolve_device
    from ..utils.graphs import GraphRunner
    from ..utils.losses import psnr as psnr_fn

    dev = resolve_device(args.device)
    rng = np.random.default_rng(11)
    w, h = args.width, args.height
    tpts, tcols = build_true_scene(rng, density=args.density)
    print(f"true scene: {len(tpts)} gaussians; {w}x{h}", flush=True)
    true_params, true_alive = init_from_pcd(tpts, tcols, sh_degree=3, device=dev)
    train_cams, test_cams = ring_cameras(w, h, dev)

    ss = args.gt_ss
    gt_cache = (Path(f"{args.state}.gt_ss{ss}_{w}x{h}_{len(tpts)}.npz")
                if args.state else None)
    t_gt = time.perf_counter()
    if gt_cache is not None and gt_cache.exists():
        gt = list(np.load(gt_cache)["gt"])
    else:
        gt = []
        with torch.no_grad():
            for cam in train_cams + test_cams:
                out = render(cam.resized(w * ss, h * ss), true_params, true_alive,
                             pair_budget=GT_PAIR_BUDGET * ss)
                if int(out["overflow"]):
                    raise RuntimeError("a ground-truth render clipped its pairs")
                img = torch.clamp(out["render"], 0.0, 1.0).cpu().numpy()
                if ss > 1:  # area downsample (the pixel footprint's integral)
                    img = img.reshape(h, ss, w, ss, 3).mean((1, 3))
                gt.append(img.astype(np.float32))
        if gt_cache is not None:
            with open(gt_cache.with_name(gt_cache.name + ".tmp"), "wb") as f:
                np.savez_compressed(f, gt=np.stack(gt))
            gt_cache.with_name(gt_cache.name + ".tmp").replace(gt_cache)
    gt_s = time.perf_counter() - t_gt
    del true_params, true_alive
    train_cams = [dataclasses.replace(c, image=torch.from_numpy(gt[i]).to(dev))
                  for i, c in enumerate(train_cams)]
    test_gt = [torch.from_numpy(g).to(dev) for g in gt[N_TRAIN:]]
    print(f"GT renders done ({gt_s:.1f} s)", flush=True)

    params, alive, n_init = sfm_init(rng, tpts, tcols, args, dev)
    state = init_train_state(params, alive)
    cfg = TrainConfig()

    def test_psnr(state, it_done):
        vals = []
        with torch.no_grad():
            for cam, g in zip(test_cams, test_gt):
                img = render(cam, state.params, alive=state.alive,
                             active_sh_degree=min(3, it_done // 1000))["render"]
                vals.append(float(psnr_fn(img, g)))
        return float(np.mean(vals))

    curve, reset_checks = [], []
    it_done, wall_used = 0, 0.0
    state_path = Path(args.state) if args.state else None
    if state_path is not None and state_path.exists():
        blob = pickle.loads(state_path.read_bytes())
        curve, reset_checks, it_done = blob["curve"], blob["reset_checks"], blob["it_done"]
        wall_used = blob.get("wall_used", 0.0)
        state = load_state(blob["state_path"], state, device=dev)
        print(f"resumed at iter {it_done} (alive {int(state.alive.sum())})", flush=True)
    runner = GraphRunner(dev)
    train_s = psnr_s = 0.0
    t0 = time.time()
    while it_done < args.iters:
        n = min(args.chunk_iters, args.iters - it_done)
        # a stream a call, from the call's first iteration: a fixed seed would
        # replay the same densify noise in every resumed call
        gen = torch.Generator(device=dev).manual_seed(it_done)
        t_train = time.perf_counter()
        state, log = train_loop(
            state, train_cams, cfg, gen, scene_extent=SCENE_EXTENT, num_iters=n,
            iter_offset=it_done, steps_per_dispatch=10, pair_budget=args.pair_budget,
            shuffle_seed=it_done, runner=runner,
        )
        ov = int(log["overflow"].max())
        n_alive = int(state.alive.sum())
        train_s += time.perf_counter() - t_train
        if ov:
            print(f"WARNING: pair budget overflow {ov} pairs dropped", flush=True)
        it_done += n
        t_psnr = time.perf_counter()
        if it_done % 500 == 50 or it_done == args.iters:
            tp = test_psnr(state, it_done)
        else:
            tp = curve[-1]["test_psnr"] if curve else float("nan")
        psnr_s += time.perf_counter() - t_psnr
        curve.append(dict(iter=it_done, alive=n_alive, test_psnr=tp,
                          capacity=int(state.params.capacity), overflow=ov))
        # right after an opacity reset the largest opacity sits near the 0.01
        # clamp; the trainer makes no reset at densify_until itself
        if it_done % cfg.opacity_reset_interval == 0 and it_done < cfg.densify_until_iter:
            mx = float(state.params.opacity[state.alive].max())
            reset_checks.append(dict(iter=it_done, max_opacity=mx))
        print(f"[{wall_used + time.time() - t0:7.1f}s] iter {it_done}: alive {n_alive} "
              f"test-PSNR {tp:.2f}", flush=True)
        if state_path is not None:
            sp = Path(f"{args.state}.ckpt")
            save_state(sp.with_name(sp.name + ".tmp"), state)
            sp.with_name(sp.name + ".tmp").replace(sp)
            atomic_write(state_path, pickle.dumps(dict(
                curve=curve, reset_checks=reset_checks, it_done=it_done, state_path=str(sp),
                wall_used=wall_used + time.time() - t0)))
            if time.time() - t0 > args.max_seconds and it_done < args.iters:
                print(f"CHUNK DONE at iter {it_done}; resume me", flush=True)
                raise SystemExit(3)

    alive0 = curve[0]["alive"]
    alive_15k = next(c["alive"] for c in curve if c["iter"] >= min(15000, args.iters))
    alive_end = curve[-1]["alive"]
    alive_peak = max(c["alive"] for c in curve)
    valid_psnrs = [c["test_psnr"] for c in curve if np.isfinite(c["test_psnr"])]
    psnr_first = valid_psnrs[0] if valid_psnrs else float("nan")
    psnr_end = valid_psnrs[-1] if valid_psnrs else float("nan")
    total_overflow = sum(c.get("overflow", 0) for c in curve)
    checks = dict(
        psnr_rises=psnr_end > psnr_first + 3.0,
        psnr_floor=psnr_end >= 27.0,
        densify_grew=alive_15k > alive0 * 1.3,
        no_growth_after_window=args.iters <= 15000 or alive_end <= alive_15k * 1.02,
        opacity_resets_clamped=all(rc["max_opacity"] <= 0.011 for rc in reset_checks),
        zero_overflow=total_overflow == 0,
    )
    report = dict(
        config=dict(iters=args.iters, width=w, height=h, n_true=len(tpts), n_init=n_init),
        curve=curve,
        opacity_reset_checks=reset_checks,
        final=dict(test_psnr=psnr_end, alive=alive_end, alive_peak=alive_peak,
                   total_overflow=total_overflow,
                   wall_s=round(wall_used + time.time() - t0, 1)),
        checks=checks,
    )
    extra = dict(gt_render_s=gt_s, train_s=train_s, test_psnr_s=psnr_s,
                 graphs=dict(captures=runner.captures, replays=runner.replays),
                 device=str(dev))
    return report, extra


def main(argv=None):
    args = parse_args(argv)
    report, extra = run(args)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    checks = report["checks"]
    print(json.dumps(dict(final=report["final"], checks=checks, run=extra)))
    if not all(checks.values()):
        print("PARITY HARNESS: CHECK FAILURES", flush=True)
        sys.exit(1)
    print("PARITY HARNESS: OK")
    return report


if __name__ == "__main__":
    main()
