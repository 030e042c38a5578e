"""Traffic driver `view`: one user dragging the camera in the viewer.

Set-up makes the configuration's scene and its fused features from the
seed, writes them where the viewer's configuration points (the scene's
PLY under <model_dir>/point_cloud/iteration_30000, the fused `.pt` under
the fusion directory; both under TMPDIR), builds the program's
`ViewerState` from its own yaml with those directories, and serves it
with the program's handler on a local port, in a thread of this process.

One client works in a closed loop over HTTP: it sends the next
`GET /render` as soon as the last PNG has arrived. Poses take small steps
along an orbit inside the room; modes come in runs of `run_length`
frames, by the mix's shares (RGB, Semantic with the ScanNet labels,
Relevancy with one label, Depth), in an order drawn from the seed. The
warm-up sends each mode twice. Latency is timed at the client, from
sending to the last byte. The check decodes a sample of the window's
PNGs, drawn from the seed with each mode in it, and compares each with
the reference's image of the same request.
"""
from __future__ import annotations

import http.client
import importlib
import math
import os
import tempfile
import threading
import time
import urllib.parse
from http.server import ThreadingHTTPServer
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from benchmark.common.trace import profiled
from benchmark.reference import view as RV
from benchmark.scenes.common import look_pose
from benchmark.traffic.distill import fused_features

MODES = ("RGB", "Semantic", "Relevancy", "Depth")


def request(cfg: Dict, wl: Dict, k: int, mode: str, yaw0: float) -> Dict:
    """Frame k of the orbit: the camera at head height on a small circle
    round the room's middle, looking out and down, `yaw_step` a frame."""
    lx, ly, _ = cfg["room"]["size_m"]
    v = cfg["view"]
    a = yaw0 + wl["yaw_step"] * k
    eye = np.array([lx / 2 + 0.1 * lx * math.cos(0.2 * a), ly / 2 + 0.1 * ly * math.sin(0.2 * a),
                    1.5])
    fwd = np.array([math.cos(0.35) * math.cos(a), math.cos(0.35) * math.sin(a), -math.sin(0.35)])
    labels = wl["labels"]
    prompts = labels if mode == "Semantic" else [labels[k % len(labels)]] if mode == "Relevancy" \
        else []
    return dict(mode=mode, c2w=look_pose(eye, fwd), prompts=list(prompts), w=v["width"],
                h=v["height"], fov=v["fov"])


def requests(cfg: Dict, wl: Dict, seed: int, count: int) -> List[Dict]:
    """The client's requests: the same mix for every seed, in another
    order. Runs of `run_length` frames; of each cycle of runs,
    `runs_per_cycle` by mode (RGB, Semantic, Relevancy, Depth): one of
    each mode first, so that every window of four runs holds all modes,
    then the rest in an order drawn from the seed."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 21])
    rest = [m for m, k in zip(MODES, wl["runs_per_cycle"]) for _ in range(k - 1)]
    yaw0 = rng.uniform(0, 2 * math.pi)
    out: List[Dict] = []
    while len(out) < count:
        for mode in list(rng.permutation(MODES)) + list(rng.permutation(rest)):
            out += [request(cfg, wl, len(out) + j, str(mode), yaw0)
                    for j in range(wl["run_length"])]
    return out[:count]


def query(r: Dict) -> str:
    q = dict(mode=r["mode"], pose=",".join(f"{x:.9g}" for x in r["c2w"].reshape(-1)),
             w=r["w"], h=r["h"], fov=r["fov"])
    if r["prompts"]:
        q["prompts"] = ",".join(r["prompts"])
    return "/render?" + urllib.parse.urlencode(q)


class Timed:
    """A module attribute wrapped to time its calls (host seconds), while
    the `with` block runs."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.seconds: List[float] = []

    def __enter__(self):
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            out = self.orig(*a, **kw)
            self.seconds.append(time.perf_counter() - t0)
            return out
        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)
        return False


def _get(conn: http.client.HTTPConnection, path: str):
    t0 = time.perf_counter()
    conn.request("GET", path)
    resp = conn.getresponse()
    body = resp.read()
    return resp.status, body, time.perf_counter() - t0


def run(ctx) -> Dict:
    from semantic_gaussians_torch.cli import view_server as VS
    from semantic_gaussians_torch.config.config import load_config
    from semantic_gaussians_torch.core.gaussians import FIELDS, GaussianParams
    from semantic_gaussians_torch.io.ply import save_gaussian_ply
    from semantic_gaussians_torch.pipelines.fusion import save_fused_features

    cfg, wl, dev = ctx.config, ctx.workload, ctx.device
    ctx.mark("imports")
    law = importlib.import_module(f"benchmark.scenes.{cfg['law']}")
    arrays = law.scene(cfg, 2 * ctx.seed, dev)
    n = arrays["means"].shape[0]
    feats16, visited = fused_features(cfg, n, 2 * ctx.seed + 1, dev)
    ctx.mark("scene")
    tmp = Path(tempfile.mkdtemp(prefix="bench_view_", dir=os.environ.get("TMPDIR")))
    model_dir, fusion_dir = tmp / "model", tmp / "fusion"
    ply = model_dir / "point_cloud" / "iteration_30000" / "point_cloud.ply"
    save_gaussian_ply(ply, GaussianParams(**{f: arrays[f].cpu() for f in FIELDS}), np.ones(n, bool))
    save_fused_features(fusion_dir / "scene" / "0.pt", feats16.astype(np.float32), visited)
    del arrays, feats16
    ctx.mark("files")
    yaml = Path(VS.__file__).resolve().parents[1] / "config" / "yamls" / cfg["view"]["yaml"]
    vcfg = load_config(yaml, [f"model.model_dir={model_dir}", f"fusion.out_dir={fusion_dir}",
                              f"render.device={dev}"])
    state = VS.ViewerState(vcfg)
    server = ThreadingHTTPServer(("127.0.0.1", 0), VS.make_handler(state))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=120)
    try:
        for k, mode in enumerate(MODES * 2):
            status, _, _ = _get(conn, query(request(cfg, wl, k, mode, 0.0)))
            if status != 200:
                raise RuntimeError(f"warm-up request {mode} failed: {status}")
        ctx.mark("warm_up")
        window = float(wl["trace_seconds"]) if ctx.trace else ctx.seconds
        reqs = requests(cfg, wl, ctx.seed, int(window * wl["max_rate"]) + 50)
        done: List = []
        traced: Dict = {}
        with Timed(VS, "encode_png") as png, Timed(VS, "render_view") as rend:
            ctx.window_start()

            def loop():
                t0 = time.perf_counter()
                for r in reqs:
                    if time.perf_counter() - t0 >= window:
                        break
                    done.append((r,) + _get(conn, query(r)))
                return time.perf_counter() - t0

            if ctx.trace:
                with profiled(traced):
                    wall = loop()
            else:
                wall = loop()
            ctx.window_end()
    finally:
        conn.close()
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    lat = np.array([d[3] for d in done])
    ok = [d for d in done if d[1] == 200]
    failed = len(done) - len(ok)
    p95 = float(np.percentile(lat, 95)) * 1e3 if len(lat) else math.inf
    rec = dict(e2e={"view_p95_ms": p95, "view_frames_per_s": len(ok) / wall},
               attempted=len(done), failed=failed, memory_peak_bytes=ctx.memory_peak())
    by_mode = {m: [1e3 * d[3] for d in done if d[0]["mode"] == m] for m in MODES}
    ctx.note("window", requests=len(done), wall_s=wall, failed=failed,
             latency_ms={m: dict(count=len(v), median=float(np.median(v)) if v else None,
                                 max=float(np.max(v)) if v else None) for m, v in by_mode.items()},
             png_ms=float(np.mean(png.seconds)) * 1e3 if png.seconds else None,
             render_ms=float(np.mean(rend.seconds)) * 1e3 if rend.seconds else None,
             png_bytes=float(np.mean([len(d[2]) for d in ok])) if ok else None)
    if ctx.trace:
        rec["layer"] = dict(trace=traced.get("trace"), png_ms=1e3 * float(np.mean(png.seconds)),
                            render_ms=1e3 * float(np.mean(rend.seconds)))
    del state, server
    ctx.free()
    for f in (ply, fusion_dir / "scene" / "0.pt"):
        f.unlink()
    rec["checks"] = check_view(cfg, wl, ctx.seed, ok, dev)
    import shutil

    shutil.rmtree(tmp, ignore_errors=True)
    return rec


def sample(ok: List, wl: Dict, seed: int) -> List:
    """`sample_per_mode` finished requests of each mode, drawn from the
    seed (a mode the window never reached is missing, and fails)."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 22])
    out = []
    for m in MODES:
        idx = [i for i, d in enumerate(ok) if d[0]["mode"] == m]
        k = min(len(idx), int(wl["sample_per_mode"]))
        out += [ok[i] for i in sorted(rng.choice(idx, k, replace=False))] if k else []
    return out


def check_view(cfg: Dict, wl: Dict, seed: int, ok: List, dev, dtype=torch.float32) -> List:
    """The worst share of a sampled image's pixels that differ from the
    reference's by more than `level_slack` levels in any channel, by mode;
    a mode with no finished request reads 1."""
    law = importlib.import_module(f"benchmark.scenes.{cfg['law']}")
    arrays = law.scene(cfg, 2 * seed, dev)
    feats16, visited = fused_features(cfg, arrays["means"].shape[0], 2 * seed + 1, dev)
    feats = torch.from_numpy(feats16.astype(np.float32) * visited[:, None]).to(dev)
    worst = {m: 1.0 for m in MODES}
    seen = set()
    for r, _status, body, _lat in sample(ok, wl, seed):
        cam = RV.request_camera(r["c2w"], r["w"], r["h"], r["fov"], dev)
        ref = RV.render_mode(arrays, feats, cam, r["mode"], r["prompts"], int(cfg["sh_degree"]),
                             dtype=dtype)
        got = RV.decode_png(body)
        off = float(np.mean(np.abs(got.astype(np.int32) - ref.astype(np.int32)).max(-1)
                            > wl["level_slack"])) if got.shape == ref.shape else 1.0
        m = r["mode"]
        worst[m] = off if m not in seen else max(worst[m], off)
        seen.add(m)
    return [(f"pixels_off.{m}", worst[m], wl["limits"][f"pixels_off.{m}"]) for m in MODES]
