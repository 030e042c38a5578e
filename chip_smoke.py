#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (semantic_gaussians_torch).

Drives the port's viewer service once at full width on one CUDA card and
holds each hand-written kernel against its plain PyTorch version:

  1. device: the card's name and power limit, torch and CUDA versions; the
     kernels are built from csrc/ (one nvcc per source, all at once).
  2. kernels vs plain versions on the card, at the main path's shapes:
     pair expand (cull on and off, bit for bit) and the forward composite
     at C = 1, 3, 5 and 768 (n_contrib exact; color, depth and final_T at
     rtol 1e-5, atol 1e-6).
  3. main path: a 100k-Gaussian scene (bench.py's scene law) with 768-dim
     fused features, served over HTTP at 640x480: RGB, Depth, Semantic and
     Relevancy renders, an edit, a reset, then render_chn at C = 768. Every
     kernel's launch count must grow in this phase.
  4. the tiled renderer against the dense oracle on a small scene.
  5. times (CUDA events / host clock after warm-up), each stamped with the
     card's name and power limit.

Prints one JSON line of per-kernel numbers, the card's name and power limit,
and, last, {"ok": true, "device": {...}}. Any failure exits non-zero before
that line. Run from the root of a checkout: python3 chip_smoke.py
"""
import json
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
N_GAUSSIANS = 100_000
WIDTH, HEIGHT = 640, 480
FEAT_DIM = 768
PROMPTS = "wall,floor,chair,table"
MODES = ("RGB", "Depth", "Semantic", "Relevancy")
# One identity pose, vertical fov 1.1 rad: the bench camera (bench.py).
POSE = ",".join(str(float(v)) for v in (1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1))
QUERY = f"w={WIDTH}&h={HEIGHT}&fov=1.1&pose={POSE}"
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and f32 CUDA-core flop/s.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else "unknown"


def decode_png(data):
    """8-bit RGB PNG with filter 0 rows (what the port's server writes)."""
    import struct

    import numpy as np

    if data[:8] != b"\x89PNG\r\n\x1a\n":
        fail("response is not a PNG")
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif kind == b"IDAT":
            idat += body
        pos += 12 + length
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        fail("unexpected PNG row filter")
    return rows[:, 1:].reshape(h, w, 3)


def cuda_ms(fn, reps):
    """Mean ms of fn() over `reps` launches, timed by CUDA events after one
    warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps):
    """Median host-clock ms of fn() (which ends in a synchronize)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile(fn):
    """Device time by kernel over one call of fn, and the device's busy
    share of the call's wall time (torch.profiler; "not measured" when it
    records no device time)."""
    import torch
    from torch.profiler import ProfilerActivity

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages() if e.device_time_total > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in events)
    if not total_us:
        return "not measured"
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    return {
        "wall_ms": wall_us / 1e3, "device_ms": total_us / 1e3,
        "device_busy_share": total_us / wall_us,
        "top_kernels_ms": {e.key[:60]: e.self_device_time_total / 1e3 for e in top},
    }


def make_scene(np, n):
    """bench.py's synthetic scene law (seed 0): a Gaussian cloud 4 units in
    front of the camera, uniform colours as SH DC (degree 3, higher bands
    zero), density-scaled log-scales, identity rotations."""
    rng = np.random.default_rng(SEED)
    pts = (rng.normal(size=(n, 3)) * np.array([1.6, 1.1, 1.0]) + np.array([0, 0, 4])).astype(np.float32)
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    density_shift = -np.log(max(n / 1e5, 1.0)) / 3.0
    log_scales = (rng.uniform(-4.5, -3.0, size=(n, 3)) + density_shift).astype(np.float32)
    opacity_logits = rng.uniform(-1.0, 1.5, size=(n, 1)).astype(np.float32)
    quats = np.zeros((n, 4), np.float32)
    quats[:, 0] = 1.0
    arrays = dict(
        means=pts,
        sh_dc=((cols - 0.5) / 0.28209479177387814)[:, None, :].astype(np.float32),
        sh_rest=np.zeros((n, 15, 3), np.float32),
        log_scales=log_scales,
        quats=quats,
        opacity_logits=opacity_logits,
    )
    feats = rng.normal(size=(n, FEAT_DIM)).astype(np.float32)
    return arrays, feats


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    if not (ROOT / "semantic_gaussians_torch" / "csrc").is_dir():
        fail(f"no semantic_gaussians_torch/ package beside {Path(__file__).name}: run from a checkout")
    sys.path.insert(0, str(ROOT))

    from semantic_gaussians_torch.cli.view_server import (
        ViewerState, camera_from_query, make_handler,
    )
    from semantic_gaussians_torch.config.config import default_config_dir, load_config
    from semantic_gaussians_torch.core.gaussians import params_from_numpy
    from semantic_gaussians_torch.io.ply import save_gaussian_ply
    from semantic_gaussians_torch.ops import composite, expand, kernels
    from semantic_gaussians_torch.ops.binning import (
        bin_gaussians, default_pair_budget, depth_sorted_rects,
    )
    from semantic_gaussians_torch.ops.projection import project_gaussians
    from semantic_gaussians_torch.pipelines.fusion import save_fused_features
    from semantic_gaussians_torch.renderer import render, render_chn

    # ---------------------------------------------------------------- 1
    card = card_line()
    dev = torch.device("cuda:0")
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    build_secs = kernels.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s: {build_secs}")
    for name, log in kernels.BUILD_LOG.items():
        regs = [l.strip() for l in log.splitlines() if "registers" in l]
        print(f"  {name}: {regs}")

    # ---------------------------------------------------------------- scene
    arrays, feats_np = make_scene(np, N_GAUSSIANS)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    tmpdir = Path(tmp.name)
    model_dir = tmpdir / "model"
    save_gaussian_ply(
        model_dir / "point_cloud" / "iteration_1" / "point_cloud.ply",
        params_from_numpy(arrays, "cpu"),
    )
    save_fused_features(tmpdir / "fusion" / "scene" / "0.pt", feats_np, np.ones(N_GAUSSIANS, bool))
    cfg = load_config(
        default_config_dir() / "view_scannet.yaml",
        [f"model.model_dir={model_dir}", f"fusion.out_dir={tmpdir / 'fusion'}"],
    )
    state = ViewerState(cfg)  # the server's own load path: PLY + .pt onto cuda
    params, alive = state.params, state.alive
    cam = camera_from_query({k: [v] for k, v in (p.split("=") for p in QUERY.split("&"))}).to(dev)

    # The main path's kernel inputs, built as the renderer builds them.
    proj = project_gaussians(
        params.means, params.scales, params.quats, params.opacity[:, 0],
        cam.world_view, cam.full_proj, cam.camera_center, cam.width, cam.height,
        cam.tan_half_fov_x, cam.tan_half_fov_y, sh_coeffs=params.sh_coeffs,
        sh_degree=params.max_sh_degree, alive=alive,
    )
    th, tw = 16, 32
    grid = (-(-HEIGHT // th), -(-WIDTH // tw))
    num_tiles = grid[0] * grid[1]
    n = params.capacity
    budget = default_pair_budget(n)

    # ---------------------------------------------------------------- 2
    def expand_args(cull):
        ex = depth_sorted_rects(
            proj.means2d, proj.depths, proj.radii_xy, (th, tw), grid, budget,
            proj.cull_ellipse if cull else None,
        )
        return ex, (ex.offsets, ex.rect_packed_d, ex.idx_d, ex.cull_d, ex.num_pairs,
                    ex.num_dense, budget, grid[1], num_tiles, n, tw, th)

    for cull in (True, False):
        ex, args = expand_args(cull)
        got = expand.expand_pairs(*args)
        want = expand.expand_pairs_plain(*args)
        torch.cuda.synchronize()
        for a, b, name in zip(got, want, ("tile", "g_key", "gen_owner")):
            if not torch.equal(a, b):
                fail(f"expand (cull={cull}) {name}: {int((a != b).sum())} slots differ from the plain version")
        live = int((got[0] < num_tiles).sum())
        print(f"expand cull={cull}: bit-identical on {budget} slots; "
              f"num_pairs={int(ex.num_pairs)} live={live} overflow={int(ex.overflow)}")
    _, expand_in = expand_args(True)

    binning = bin_gaussians(
        proj.means2d, proj.depths, proj.radii_xy, (th, tw), grid, budget, proj.cull_ellipse
    )
    geom = composite.pack_geometry(proj.means2d, proj.conics, proj.opacities, proj.depths)
    feats = state.gauss_feats
    labels = torch.argmax(feats[:, :5], dim=-1)  # a 5-channel one-hot, as Semantic renders
    channel_cases = {
        1: torch.rand((n, 1), generator=torch.Generator(dev).manual_seed(SEED), device=dev),
        3: proj.colors.contiguous(),
        5: torch.nn.functional.one_hot(labels, 5).to(torch.float32) * alive[:, None],
        FEAT_DIM: (feats * alive[:, None]).contiguous(),
    }
    comp_cases = {}
    for c, colors in channel_cases.items():
        bg = torch.linspace(0.1, 0.3, c, device=dev)
        args = (geom, colors, binning.pair_gaussian, binning.tile_start, binning.tile_count,
                bg, grid[1], th, tw)
        got = composite.composite_forward(*args)
        work = {}
        want = composite.composite_forward_plain(*args, work=work)
        torch.cuda.synchronize()
        if not torch.equal(got[3], want[3]):
            fail(f"composite C={c}: n_contrib differs at {int((got[3] != want[3]).sum())} px")
        err = 0.0
        for a, b, name in zip(got[:3], want[:3], ("color", "depth", "final_T")):
            if not torch.isfinite(a).all():
                fail(f"composite C={c}: non-finite {name}")
            try:
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
            except AssertionError as e:
                fail(f"composite C={c} {name} vs plain: {e}")
            err = max(err, float((a - b).abs().max()))
        comp_cases[c] = dict(args=args, max_abs_err=err, work=work)
        print(f"composite C={c}: n_contrib exact, max |kernel - plain| = {err:.3g}; "
              f"(pixel, pair) events evaluated {work['evaluated']}, "
              f"contributed {work['contributed']}")

    # ---------------------------------------------------------------- 3
    from http.server import ThreadingHTTPServer

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    try:
        line = serve_and_time(
            f"http://127.0.0.1:{httpd.server_address[1]}", card, state, cam, arrays,
            budget, binning, expand_in, comp_cases,
        )
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=60)
        tmp.cleanup()
    print(json.dumps(line))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def serve_and_time(base, card, state, cam, arrays, budget, binning, expand_in, comp_cases):
    """Phases 3-5 against the viewer server running at `base`; returns the
    kernels line. `expand_in` and `comp_cases` are the kernels' main-path
    inputs from phase 2."""
    import numpy as np
    import torch

    from semantic_gaussians_torch.cli.view_server import encode_png
    from semantic_gaussians_torch.ops import composite, expand
    from semantic_gaussians_torch.renderer import render, render_chn

    alive, dev, n = state.alive, cam.world_view.device, state.params.capacity
    num_tiles = binning.tile_start.numel()

    def get(mode):
        q = f"{base}/render?mode={mode}&{QUERY}&prompts={PROMPTS}"
        with urllib.request.urlopen(q, timeout=300) as r:
            if r.status != 200:
                fail(f"GET /render {mode}: HTTP {r.status}")
            img = decode_png(r.read())
        if img.shape != (HEIGHT, WIDTH, 3):
            fail(f"{mode} render has shape {img.shape}")
        return img

    def post(path, body):
        req = urllib.request.Request(f"{base}{path}", data=body.encode(), method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            return json.loads(r.read())

    expand.LAUNCHES.reset()
    composite.LAUNCHES.reset()
    images = {m: get(m) for m in MODES}
    edit = post("/edit", "mode=Remove&edit=chair")
    edited = get("RGB")
    reset = post("/reset", "")
    after_reset = get("RGB")
    out_rgb = render(cam, state.params, alive=alive)
    out_feat = render_chn(cam, state.params, state.gauss_feats, alive=alive)
    torch.cuda.synchronize()
    launches = {"expand": expand.LAUNCHES.count, "composite_fwd": composite.LAUNCHES.count}
    print(f"main path launches: {launches}; edit {edit}; reset {reset}")
    for name, cnt in launches.items():
        if cnt <= 0:
            fail(f"kernel {name} was not launched on the main path")
    if not edit.get("edited"):
        fail(f"the edit selected nothing: {edit}")
    if np.array_equal(edited, images["RGB"]):
        fail("the Remove edit did not change the RGB render")
    if not np.array_equal(after_reset, images["RGB"]):
        fail("the render after reset differs from the original")
    for m, img in images.items():
        if img.max() == img.min():
            fail(f"{m} render is a constant image")
    for name, out, c in (("RGB", out_rgb, 3), ("features", out_feat, FEAT_DIM)):
        if int(out["overflow"]) != 0:
            fail(f"{name} render overflowed its pair budget by {int(out['overflow'])}")
        if out["render"].shape != (HEIGHT, WIDTH, c) or not torch.isfinite(out["render"]).all():
            fail(f"{name} render: bad shape or non-finite values")
        d, ft = out["depth"], out["final_T"]
        if not ((d > 0.2) & (d <= 15.0)).all() or not ((ft >= 0) & (ft <= 1)).all():
            fail(f"{name} render: depth or final_T out of range")
    print(f"main path: {', '.join(MODES)} + edit/reset served at {WIDTH}x{HEIGHT}; "
          f"num_pairs={int(out_rgb['num_pairs'])} of budget {budget}")

    # ---------------------------------------------------------------- 4
    small_params = type(state.params)(
        **{k: torch.as_tensor(v[:2000]).to(dev) for k, v in arrays.items()}
    )
    small_cam = cam.resized(128, 64)
    tiled = render(small_cam, small_params)
    dense = render(small_cam, small_params, backend="dense")
    for key, rtol, atol in (("render", 1e-4, 1e-5), ("final_T", 1e-4, 1e-5), ("depth", 1e-4, 1e-4)):
        try:
            torch.testing.assert_close(tiled[key], dense[key], rtol=rtol, atol=atol)
        except AssertionError as e:
            fail(f"tiled vs dense oracle, {key}: {e}")
    if not torch.equal(tiled["n_contrib"], dense["n_contrib"]):
        fail("tiled vs dense oracle: n_contrib differs")
    print("tiled renderer matches the dense oracle on 2000 Gaussians at 128x64")

    # ---------------------------------------------------------------- 5
    num_pairs = int(expand_in[4])
    # bytes: offsets, rects, ids (4 B each) and the cull table (20 B) per
    # Gaussian in, 12 B out per slot. f32 ops: ~65 per valid slot
    # (tile_min_qn; the integer search and decode are not counted).
    kern = {"expand": dict(
        max_abs_err=0.0,
        ms=cuda_ms(lambda: expand.expand_pairs(*expand_in), 50),
        plain_ms=cuda_ms(lambda: expand.expand_pairs_plain(*expand_in), 10),
        bound=((32 * n + 12 * budget) / PEAK_BYTES, 65 * num_pairs / PEAK_F32),
    )}
    in_pairs = int(binning.tile_count.sum())
    used = int(torch.unique(binning.pair_gaussian[:in_pairs]).numel())
    by_c = {}
    for c, case in comp_cases.items():
        args = case["args"]
        # bytes: geometry and colour rows of the Gaussians in tile ranges,
        # their pair ids, tile ranges, the outputs. f32 ops, counted by the
        # plain version on these inputs: ~18 for each (pixel, pair) whose
        # alpha a pixel evaluates before it stops, 2C more for each one
        # that contributes colour.
        work = case["work"]
        cops = 18 * work["evaluated"] + 2 * c * work["contributed"]
        cbytes = (used * (32 + 4 * c) + 4 * in_pairs + 8 * num_tiles
                  + num_tiles * 512 * 4 * (c + 3))
        by_c[c] = dict(
            max_abs_err=case["max_abs_err"],
            ms=cuda_ms(lambda: composite.composite_forward(*args), 20),
            plain_ms=cuda_ms(lambda: composite.composite_forward_plain(*args), 1),
            bound=(cbytes / PEAK_BYTES, cops / PEAK_F32), work=work,
        )
    # Where a request's time goes: the whole HTTP request, the view render
    # alone (state.render: camera, render, host post-processing) and the
    # PNG encode of its image.
    request_ms = {m: host_ms(lambda m=m: get(m), 5) for m in MODES}
    queries = {m: {k: [v] for k, v in (p.split("=") for p in
                                       f"mode={m}&{QUERY}&prompts={PROMPTS}".split("&"))}
               for m in MODES}
    view_ms = {m: host_ms(lambda m=m: state.render(queries[m]), 5) for m in MODES}
    png_ms = host_ms(lambda: encode_png(images["RGB"]), 5)

    def rgb_render():
        render(cam, state.params, alive=alive)
        torch.cuda.synchronize()

    def feat_render():
        render_chn(cam, state.params, state.gauss_feats, alive=alive)
        torch.cuda.synchronize()

    render_ms = host_ms(rgb_render, 10)
    render_chn_ms = host_ms(feat_render, 5)
    print(json.dumps({
        "card": card, "request_ms": request_ms, "view_render_ms": view_ms,
        "png_encode_ms": png_ms, "render_rgb_ms": render_ms,
        "render_chn_768_ms": render_chn_ms, "rgb_request_profile": profile(
            lambda: state.render(queries["RGB"])),
        "num_pairs": num_pairs, "pairs_in_tiles": in_pairs, "gaussians_in_tiles": used,
        "expand": {k: v for k, v in kern["expand"].items()},
        "composite_by_channels": {str(c): d for c, d in by_c.items()},
    }))

    def entry(name, source, replaces, r, max_abs_err, **extra):
        bytes_ms, ops_ms = (b * 1e3 for b in r["bound"])
        # `replaces` / `max_abs_err` and `tpu_source` / `max_err_vs_plain`
        # are two names each for one value: readers of this line know
        # either set.
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "tpu_source": replaces, "launches": launches[name],
            "max_abs_err": max_abs_err, "max_err_vs_plain": max_abs_err,
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "card": card, **extra,
        }

    return {"kernels": [
        entry("expand", "semantic_gaussians_torch/csrc/expand.cu",
              "semantic_gaussians_tpu/ops/expand.py:121", kern["expand"],
              kern["expand"]["max_abs_err"]),
        entry("composite_fwd", "semantic_gaussians_torch/csrc/composite_fwd.cu",
              "semantic_gaussians_tpu/ops/composite_pallas.py:264", by_c[3],
              max(d["max_abs_err"] for d in by_c.values()),
              shape="C=3 (RGB/Depth requests); by_channels has every C of the main path",
              by_channels={str(c): dict(ms=d["ms"], plain_ms=d["plain_ms"],
                                        max_abs_err=d["max_abs_err"],
                                        bound_ms=max(d["bound"]) * 1e3, work=d["work"])
                           for c, d in by_c.items()}),
    ]}


if __name__ == "__main__":
    main()
