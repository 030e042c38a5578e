#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (semantic_gaussians_torch).

Drives the port's main paths once at full width on one CUDA card (the
viewer service, RGB training through the train CLI, 2D -> 3D fusion, 3D
distillation and open-vocabulary evaluation through their CLIs, the 2D
models behind the fusion and eval CLIs, the segment-sum probe tools, the
multi-device schedules, the harnesses and bench tools, a ScanNet scene from
its download) and holds each hand-written kernel against its plain PyTorch
version:

  1. device: the card's name and power limit, torch and CUDA versions; the
     five kernel sources are built from csrc/ (one nvcc per source, all at
     once).
  2. kernels vs plain versions on the card, at the main paths' shapes:
     pair expand at the viewer's shape (cull on and off, bit for bit) and
     on the adversarial cases of tools/expand_cases.py; the forward
     composite at C = 1, 3, 5, 21 and 768 (n_contrib exact; color, depth
     and final_T at rtol 1e-5, atol 1e-6); the composite backward at C = 3
     and 768 with a random upstream gradient (rows at rtol 1e-4, atol 1e-5
     x column max)
     and the segment sum on its rows at D = 9 and 774 (rtol 1e-5, atol
     1e-6 x column max), each of the two bit-identical over two runs; the
     segment sum at the probe tools' four shapes (V0, V4, both resident
     shapes) against the plain version summed in float64 (same tolerance:
     see check_tool_segsums); the segment-sum probe in both modes at the
     probe tools' full shapes, with sorted owners and with owners out of
     order inside every 64th chunk (rtol 1e-5, atol 1e-5 x column max: see
     check_probe_kernels), bit-identical over two runs; both summing
     kernels on the small adversarial cases of tools/summing_cases.py; both
     composite kernels on the adversarial cases of tools/composite_cases.py
     (and their channel scene at C = 768), at the tolerances above; the
     segment sum captured in a CUDA graph at D = 9 and 774 (P of the
     viewer's binning, the training view's live pairs) and replayed three
     times on fresh inputs (random runs, a tools/summing_cases.py case of
     the width, runs past the look-back's reach), each replay bit for bit
     an eager call's and within the float64 tolerance
     (check_segsum_replay; `python3 chip_smoke.py --segsum-replay` runs
     this check alone).
  3. viewer path: a 100k-Gaussian scene (bench.py's scene law) with 768-dim
     fused features, served over HTTP at 640x480: RGB, Depth, Semantic and
     Relevancy renders, an edit, a reset, then render_chn at C = 768. All
     four launch counts are set to 0 before and read after; the forward
     kernels' must grow.
  4. the tiled renderer against the dense oracle on a small scene.
  5. viewer times (CUDA events / host clock after warm-up); every kernel
     time also as `device_us`, the event time of CUDA-graph replays.
  6. gradients through the tiled path (the kernels) against autograd
     through the dense oracle, 2000 Gaussians at 128x64.
  7. training path: a Blender-layout scene (8 views of the 100k target at
     640x480, points3d.ply of its means with jittered colours) trained for
     100 steps by `python -m semantic_gaussians_torch.cli.train` (called in
     process) with densification, at the CLI's default
     train.steps_per_dispatch = 10 (a CUDA-graph replay a chunk); every
     loss finite, train-view PSNR up by at least 1 dB, the alive count
     changed by densify, no overflow on the last step, all four kernels
     launched, the saved PLY rendered through the viewer's ViewerState, and
     one opacity reset checked. The same 100 steps eagerly
     (steps_per_dispatch = 1), twice: camera order, budgets, densify events
     and the alive set exact; losses bit for bit where the two eager runs
     agree bit for bit, else within their spread.
  8. training times: one train step and its parts, the device-busy share,
     the graphed step (a chunk of 10 a replay, / 10), its busy share and
     peak memory,
     both composite kernels on the timed training view's binning (checked
     against the plain versions, timed, and the share of the step's device
     time each takes), and the backward kernels' times against their plain
     versions, bounds and (for the segment sum) index_add_.
  9. fusion path: the 100k scene with near-opaque splats as the trained
     model, the training scene's 8 ring views, one 648x484x768 float16
     feature map per view rendered from a per-Gaussian class palette (20
     classes, each carrying its label's text feature) and written as .npy;
     `python -m semantic_gaussians_torch.cli.fusion` (in process) fuses
     them with depth=render in chunks (chunk_views 4, capped at 2 by the
     maps' bytes; the CLI view by view is phase 18's). One expand and one
     forward-composite launch a depth render
     (fusion_depth_renders), visited share above VISITED_FLOOR, mean cosine
     of fused against palette features >= 0.9, the .pt reloads.
 9b. distill path: `python -m semantic_gaussians_torch.cli.distill` (in
     process) trains MinkUNet34A (56 -> 768) on the fusion phase's model
     and fused .pt: 2 cm voxels, a 200,000-voxel budget, augmentation on,
     DISTILL_EPOCHS epochs of one step, the ring scene as the eval scene
     (its render hook runs twice). Every loss finite, the last below the
     first by DISTILL_LOSS_DROP, the checkpoint reloads, the hook's PNGs
     exist, expand and forward-composite launches equal to the hook's
     renders. The plain-torch UNet (no kernel of its own) is held against
     itself on the CPU: MinkUNet34A on 4,096 of the scene's voxels, the
     float32 eval-mode output and the float64 gradients of a cosine loss
     within 1e-4 x each leaf's largest magnitude, and each side's float32
     gradients against float64 run through that side's float32 ReLU masks
     (see check_unet_card_vs_cpu). Times: one distill step at the full
     voxel count (median after warm-up) and its parts (topology, forward,
     backward, AdamW, each ended by a synchronize), its device-busy
     share, peak device memory, voxels a second, and one UNet inference
     as eval 3d runs it.
 10. eval path: ground-truth label images rendered from the palette's
     classes; `python -m semantic_gaussians_torch.cli.eval_segmentation`
     (in process) in mode 2d with pred_on_3d true (C = 21) and false
     (C = 768): mIoU >= 0.9 each; the same two on EVAL_VIEWS frames whose
     every 10th (evaluated) takes a fused ring view's pose in turn (9
     views: a chunk of 8, one replay, and a view alone), each confusion
     equal to the per-view run's; mode labelmap on its own ground truth:
     mIoU = 1; modes 3d, 2d_and_3d concat and 2d_and_3d argmax on the
     distilled checkpoint (C = 21): a finite mIoU, every labeled pixel
     counted.
 11. probe tools: `tools.exp_panel` and `tools.exp_panel2` at full size.
 12. fusion, eval and probe times (a fused and an evaluated view chunked
     against view by view).
 13. expand at three shapes, cull on and off: the viewer (phase 2's), the
     timed training view and bench.py's scene law at 1M Gaussians (capacity
     1,003,520, pair budget 12,042,240; binning only, nothing rendered):
     bit for bit against the plain version, then CUDA events over
     back-to-back calls, `device_us`, the host's enqueue time of one call,
     the plain version and bin_gaussians.
 14. (run after phase 10) 2D models at their published widths, random
     weights from SEED, written as checkpoints in their public layouts (SAM ViT-H, CLIP ViT-L/14@336,
     LSeg ViT-L/16 + DPT with a CLIP ViT-B/32 text tower, a BPE merges file
     of the label words): each tower at a cut depth (SAM one windowed and
     one global block at 1024^2, CLIP two blocks, LSeg four blocks with all
     four taps) on the card and on the CPU, max |card - CPU| over the CPU's
     largest output <= GAP_FP32 with cuDNN's TF32 off and <= GAP_DEFAULT
     with torch's defaults; the AMG's logits likewise, and its discrete
     stage (TIMED_TOP_IOU candidates a view) run on the card's logits on
     the card and on the CPU: identical annotations. The random SAM's mask
     decoder is scaled so that its masks pass the AMG's default filters
     (tools/random_checkpoints.py). Then the fusion CLI with model_2d =
     samclip, lseg, vlpart (precomputed detections) and vlpart (native
     detector) on 2 of the ring views each (depth=render, the YAML's AMG
     thresholds; expand and composite_fwd launched once a view; each run
     covers some points, LSeg every visited one), the eval CLI in mode
     pretrained with model_2d = lseg; the masks each AMG stage keeps on the
     SAMCLIP CLI's views at its thresholds; times: the SAM encoder, an AMG view
     (device batches, host NMS and region removal) and a SAMCLIP view at
     lowered thresholds (>= CROPS_FLOOR crops), CLIP crops a second, the
     per-pixel sum, LSeg single pass and sliding, the text towers, each
     fusion CLI and eval pretrained a view, peak memory, busy shares.
 15. (run after phase 14) the multi-device schedules (parallel/) on the
     card: (a) one rank over NCCL in this process at full width -
     render_sharded at 640x480 RGB and C = 768 against render /
     render_chn, the view-DP, band, band-ZeRO, hybrid and hybrid-ZeRO
     steps on the timed training view (random rotations, anisotropic
     scales) against train_step, make_parallel_fuse_step on one ring
     view against fuse_view, make_parallel_distill_step on the distill
     phase's item against make_distill_step; each reported bit for bit or
     held at its tolerance (see image_gap, state_gap); (b) two processes
     sharing the card over gloo (both bind cuda:0): render_sharded, the
     five steps (view-DP on two ring views against a single-device
     two-view step), the hybrid loop at 1 x 2 for DIST_LOOP_ITERS
     iterations with one densify (both ranks bitwise equal), parallel
     fusion on two ring views (counts exact, features rtol 1e-6), the
     parallel distill step at DIST_DISTILL_BUDGET voxels a rank; (b') the
     train CLI with pipeline.distributed=true (ZeRO) on two processes:
     rank 0 alone writes the PLY, which renders. Per-rank times beside
     train_step's and render's, bytes handed to collectives a step; the
     launches of (a), (b) and (b') make the kernels line's "distributed"
     path. A child that fails, exits non-zero or hangs past DIST_TIMEOUT_S
     fails the run.
 16. (run after phase 1) the end-to-end harnesses at full width and cut
     depth, each a main path of its own (its launches counted from 0):
     (a) `tools.profile_step` on bench.py's scene (100k, 640x480): the top
     ops a step by device time, then the same table for the port's
     train_step (SSIM and Adam in it) on the timed training view (a
     training scene written as phase 7's, not trained); (b)
     `tools.parity_harness` on its full scene (365,664 true Gaussians, GT
     at 960x704, 40 + 8 views at 480x352, pair budget 1,572,864), cut to
     PARITY_ITERS iterations: the reading at 550 at least 3 dB over the one
     at 50 and >= 27 dB, alive above the init after the densify at 600, no
     overflow; (c) `tools.semantic_harness` on its full scene (205,236
     Gaussians, D = 512, 640x480, MinkUNet34A, budget 65,536), cut to
     SEMANTIC_CUT: fused cosine > 0.95, visited > 0.7, mIoU 2d > 0.9, 3d
     and 2d_and_3d finite with every labelled pixel counted. Before each
     path's counted run, the kernels are held against their plain versions
     on that path's own inputs (phase 2's tolerances): (a) bench.py's view,
     expand, composite forward and backward, segment sum; (b) the first GT
     view at 960x704 on the true scene (budget 8,388,608: expand, forward)
     and a training view at 480x352 from the init (all four); (c) the
     first eval view at C = 512 (the walk and contraction pair) and C = 4.
 17. (run after phase 16) the bench tools of semantic_gaussians_torch/tools
     as one main path (its launches counted from 0, with those the bench
     and bench_scaling children report): `python -m ...tools.bench` as a
     child process at bench.py's four configurations (100k fwd+bwd and
     forward-only at 640x480, 1M, 5M at 1920x1080), each line checked for
     bench.py's seven keys and the card's stamp; bench_components,
     bench_eval, bench_amg and bench_scaling (one NCCL rank) at their
     defaults; bench_distill's timing body at full width (131,072 room
     voxels, MinkUNet34A, 56 -> 768) cut to DISTILL_CUT, with its peak
     memory. Before the counted run, kernels 1-5 are held against their
     plain versions on the tools' own views (phase 2's tolerances): bench's
     1M view and its 5M 1920x1080 view (10.9M pairs, 120x68 tiles) at the
     probe's budget, bench_components' view at 393,216, bench_scaling's
     SH-0 view at 655,360; kernels 1-2 on bench_eval's first view at
     C = 768 (the 100k view is held in phase 16).
 18. (run after phase 10, whose classes and label rendering it reuses) the
     ScanNet path at ScanNet's widths, its launches counted from 0 over each
     CLI run: write_sens writes a download of one scene (a .sens v4 capture
     of SENS_FRAMES frames of a handheld sweep facing the 100k target,
     colour 1296x968 JPEG, depth 640x480 zlib in millimetres from the
     near-opaque target's median depth, frame SENS_LOST's pose -inf; a
     label-filt zip of 16-bit raw ids above 255 for all frames; the
     scannetv2-labels TSV); (a) `python -m ...tools.scannet_sens_reader` at
     its defaults: 24 frames at 648x484, each depth PNG the capture's
     resized; (b) `...tools.unzip_label_filt`: 24 labels of 120; (c) the
     train CLI on the export, 100 steps from the loader's own random init,
     phase 7's checks, kernels 1-5 held against their plain versions on its
     first training view; (d) the fusion CLI with fusion.depth=image on the
     fusion phase's model from 648x484x768 float16 maps of the ScanNet-20
     palette (5 views), chunked and view by view (.pt bit for bit), visited
     share above SCANNET_VISITED_FLOOR, cosine >= 0.9, and with
     depth=render: Jaccard of the visited sets >= 0.9; (e) the eval CLI in
     mode 2d at scene.dataset_name=scannet20 against label-filt through the
     TSV at C = K + 1 and 768: mIoU >= 0.9, confusion row sums equal to the
     ground truth's class counts mapped here with numpy.
 19. (run after phase 17) the projection kernels (csrc/projection.cu)
     against the plain version at PROJECTION_CASES: both train cells' main
     path (1M at 648x484, 5M at 1920x1080, SH degree 3), a C = 768 override
     colour and world_rotate's cov3d_precomp at 1M, and the other SH layouts
     at 100k. Forward floats at rtol 1e-5 (atol 1e-6 x the column's largest
     |value|) widened by twice the plain version's own distance to float64
     (and the conic's condition), every entry of a drawn Gaussian and all
     but 1e-5 of the entries of culled ones, radii within 1 on at most
     1e-4 of the Gaussians; per leaf, over all rows and the drawn ones, the
     backward's norm-relative gap to float64 autograd of the plain forward
     at most twice float32 autograd's, its distance to the hand backward at
     most twice that one's gap, exact zeros where the cotangents are;
     times of both kernels (device_us) beside their byte bounds and the
     plain forward and its autograd backward; one forward and one backward
     launch a step over a 10-step graph replay at 1M.
     `python3 chip_smoke.py --projection` runs this phase alone.
Every phase prints its wall time, and a summary line of them precedes the
kernels line. Every number is stamped with the card's name and power limit.

Prints one JSON line of per-kernel numbers, the card's name and power limit,
and, last, {"ok": true, "device": {...}}. Any failure exits non-zero before
that line. Run from the root of a checkout: python3 chip_smoke.py
"""
import contextlib
import dataclasses
import json
import shutil
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
JOINT_DIM = 515  # Feature 3DGS's joint composite: RGB and LSeg's 512 channels
TRAIN_VIEWS, TRAIN_RADIUS, TRAIN_ITERS = 8, 6.0, 100
FUSE_W, FUSE_H = 648, 484  # the fusion configs' feature-map and eval size
# The fusion / eval scene: the 100k target with opacity logits raised by this
# much (near-opaque, as a trained scene's surface splats are, so that the
# median depth reads a surface), and the occlusion tolerance of its fusion.
OPACITY_BOOST, VISIBILITY = 4.0, 0.1
VISITED_FLOOR = 0.25  # measured 0.288 on this scene (28,756 of 100,000)
PROMPTS = "wall,floor,chair,table"
MODES = ("RGB", "Depth", "Semantic", "Relevancy")
# One identity pose, vertical fov 1.1 rad: the bench camera (bench.py).
POSE = ",".join(str(float(v)) for v in (1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1))
QUERY = f"w={WIDTH}&h={HEIGHT}&fov=1.1&pose={POSE}"
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and f32 CUDA-core flop/s.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
SLEEP_CYCLES = 4_000_000  # ~2 ms at the H100's 1.98 GHz boost clock (device_us)
TRAIN_VIEW_PAIRS = 644_234  # live pairs of the timed training view (phase 8)
EVAL_VIEWS, EVAL_CHUNK = 90, 8  # the eval scene's frames (every 10th evaluated); eval.chunk_views


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


def device_us(fn, reps=20, calls=1):
    """Device time of one call of fn in microseconds: `calls` calls of fn
    are captured once into a CUDA graph, and `reps` replays of the graph
    are timed by CUDA events (divided by `calls`). Unlike an event time over
    back-to-back calls of fn itself, this leaves out the time the host
    takes to launch each kernel (a replay is one launch), which decides the
    time of kernels of a few tens of microseconds; more calls a graph also
    spread the replay's own launch over them. The replays queue behind
    ~2 ms of device sleep, so that the host has enqueued them all before
    the first runs: a replay of a graph of one ~10 us call is launched no
    faster than it runs, and would otherwise time the host."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # a capture wants a warm-up off the default stream
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / (reps * calls)


def enqueue_us(fn, calls=200):
    """Median host-clock time of one call of fn in microseconds, over
    `calls` calls with no synchronize between them: the host's cost of
    enqueueing the call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
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


@contextlib.contextmanager
def phase_wall(walls, name):
    """Time one phase of main(): prints its wall time as it ends and keeps
    it in `walls` for the summary line."""
    t0 = time.perf_counter()
    yield
    walls[name] = time.perf_counter() - t0
    print(f"phase {name}: {walls[name]:.1f} s")


def make_scene(np, n, feats=True):
    """bench.py's synthetic scene law (seed 0): a Gaussian cloud 4 units in
    front of the camera, uniform colours as SH DC (degree 3, higher bands
    zero), density-scaled log-scales, identity rotations; and, drawn last
    (so that `feats=False` leaves the rest as it is), FEAT_DIM-dim random
    features (None without them)."""
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
    if not feats:
        return arrays, None
    return arrays, rng.normal(size=(n, FEAT_DIM)).astype(np.float32)


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    if not (ROOT / "semantic_gaussians_torch" / "csrc").is_dir():
        fail(f"no semantic_gaussians_torch/ package beside {Path(__file__).name}: run from a checkout")
    sys.path.insert(0, str(ROOT))

    from semantic_gaussians_torch.cli.view_server import ViewerState, make_handler
    from semantic_gaussians_torch.config.config import default_config_dir, load_config
    from semantic_gaussians_torch.core.gaussians import params_from_numpy
    from semantic_gaussians_torch.io.ply import save_gaussian_ply
    from semantic_gaussians_torch.ops import composite, expand, kernels
    from semantic_gaussians_torch.ops.binning import bin_gaussians, default_pair_budget
    from semantic_gaussians_torch.ops.projection import project_gaussians
    from semantic_gaussians_torch.pipelines.fusion import save_fused_features

    # ---------------------------------------------------------------- 1
    t_run = time.perf_counter()
    walls = {}
    card = card_line()
    dev = torch.device("cuda:0")
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    with phase_wall(walls, "1 build"):
        build_secs = kernels.build_all()
        print(f"kernels built: {build_secs}")
        for name, log in kernels.BUILD_LOG.items():
            regs = [l.strip() for l in log.splitlines() if "registers" in l or "spill" in l]
            print(f"  {name}: {regs}")

    # ---------------------------------------------------------------- 16
    with phase_wall(walls, "16 harnesses"), tempfile.TemporaryDirectory(
            prefix="chip_smoke_scene_") as scene_tmp:
        write_blender_scene(Path(scene_tmp) / "scene", make_scene(np, N_GAUSSIANS, False)[0],
                            dev)
        harnesses = harness_phase(Path(scene_tmp) / "scene", dev, card)

    # ---------------------------------------------------------------- 17
    with phase_wall(walls, "17 bench tools"):
        bench_tools = bench_tools_phase(dev, card)

    # ---------------------------------------------------------------- 19
    with phase_wall(walls, "19 projection"):
        projection_phase(dev, card)

    # ---------------------------------------------------------------- scene
    t_scene = time.perf_counter()
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
    cam = viewer_camera(dev)

    # The main path's kernel inputs, built as the renderer builds them.
    proj = project_gaussians(
        params.means, params.scales, params.quats, params.opacity[:, 0],
        cam.world_view, cam.full_proj, cam.camera_center, cam.width, cam.height,
        cam.tan_half_fov_x, cam.tan_half_fov_y, sh_coeffs=params.sh_coeffs,
        sh_degree=params.max_sh_degree, alive=alive,
    )
    th, tw = 16, 32
    grid = (-(-HEIGHT // th), -(-WIDTH // tw))
    n = params.capacity
    budget = default_pair_budget(n)

    walls["viewer scene"] = time.perf_counter() - t_scene
    print(f"phase viewer scene: {walls['viewer scene']:.1f} s")

    # ---------------------------------------------------------------- 2
    t_check = time.perf_counter()
    expand_shapes = {"viewer": expand_shape(params, alive, cam)}
    for cull, sh in expand_shapes["viewer"].items():
        check_expand(f"viewer cull={cull}", expand, sh["args"])
    check_expand_cases(dev)

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
        # K + 1 = 21 one-hot classes, as evaluation's pred_on_3d renders them
        21: torch.nn.functional.one_hot(torch.argmax(feats[:, :21], dim=-1), 21).to(
            torch.float32) * alive[:, None],
        JOINT_DIM: (feats[:, :JOINT_DIM] * alive[:, None]).contiguous(),
        FEAT_DIM: (feats * alive[:, None]).contiguous(),
    }
    comp_cases = {}
    for c, colors in channel_cases.items():
        bg = torch.linspace(0.1, 0.3, c, device=dev)
        args = (geom, colors, binning.pair_gaussian, binning.tile_start, binning.tile_count,
                bg, grid[1], th, tw)
        work = {}
        _, err = check_forward(f"composite C={c}", args, work)
        comp_cases[c] = dict(args=args, max_abs_err=err, work=work)
        print(f"composite C={c}: n_contrib exact, max |kernel - plain| = {err:.3g}; "
              f"(pixel, pair) events evaluated {work['evaluated']}, "
              f"contributed {work['contributed']}")

    # ---------------------------------------------------------------- 2b
    bwd, seg = check_backward_kernels(comp_cases, binning, grid, th, tw)
    segsum_replay = check_segsum_replay(dev, {
        d: (c["args"][0].shape[0], c["args"][2], TRAIN_VIEW_PAIRS) for d, c in seg.items()})
    tool_seg = check_tool_segsums(dev)
    probe = check_probe_kernels(dev)
    check_adversarial_cases(dev)
    check_composite_cases(dev)
    walls["2 kernel checks"] = time.perf_counter() - t_check
    print(f"phase 2 kernel checks: {walls['2 kernel checks']:.1f} s")

    # ---------------------------------------------------------------- 3
    from http.server import ThreadingHTTPServer

    t_viewer = time.perf_counter()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    try:
        viewer_launches, kernel_lines = serve_and_time(
            f"http://127.0.0.1:{httpd.server_address[1]}", card, state, cam, arrays,
            budget, binning, comp_cases,
        )
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=60)
        tmp.cleanup()
    del state, params, alive, proj, geom, feats, channel_cases, comp_cases
    walls["3-5 viewer"] = time.perf_counter() - t_viewer
    print(f"phase 3-5 viewer: {walls['3-5 viewer']:.1f} s")

    # ---------------------------------------------------------------- 6
    with phase_wall(walls, "6 gradients"):
        check_gradients_vs_dense(arrays, cam)

    # ---------------------------------------------------------------- 7
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as train_tmp:
        with phase_wall(walls, "7 training"):
            trained = train_through_cli(Path(train_tmp), arrays, dev)

        # ------------------------------------------------------------ 8
        with phase_wall(walls, "8 training times"):
            step_times = time_training(trained["scene"], dev, card)
            _, tcam, tparams, talive = training_view(trained["scene"], dev)
            expand_shapes["training view"] = expand_shape(tparams, talive, tcam)
            del tparams, talive

        # ------------------------------------------------------------ 9, 9b, 10
        with phase_wall(walls, "9 fusion"):
            fused = fuse_through_cli(Path(train_tmp), trained["scene"], arrays, dev, card)
        with phase_wall(walls, "9b distill"):
            distilled = distill_through_cli(Path(train_tmp), trained["scene"], fused, dev, card)
        with phase_wall(walls, "10 eval"):
            evaluated = eval_through_cli(Path(train_tmp), trained["scene"], fused, distilled,
                                         dev, card)

        # ------------------------------------------------------------ 18
        with phase_wall(walls, "18 scannet"):
            scannet = scannet_phase(Path(train_tmp), arrays, fused, dev, card)
        del fused["state"]

        # ------------------------------------------------------------ 14
        with phase_wall(walls, "14 2D models"):
            models_2d = models_2d_phase(Path(train_tmp), trained["scene"], fused, evaluated,
                                        dev, card)

        # ------------------------------------------------------------ 15
        with phase_wall(walls, "15 distributed"):
            distributed = distributed_phase(Path(train_tmp), trained["scene"], fused, dev,
                                            card)

    # ---------------------------------------------------------------- 11
    with phase_wall(walls, "11 probe tools"):
        tools = run_probe_tools()

    # ---------------------------------------------------------------- 13
    with phase_wall(walls, "13 expand"):
        expand_shapes["1M"] = million_shape(dev)
        ex_by_shape = check_and_time_expand(card, expand_shapes)
        del expand_shapes

    t_times = time.perf_counter()
    kt = time_backward_kernels(bwd, seg)
    kt["segsum_tools"] = time_segsums(tool_seg)
    del tool_seg
    pt = time_probe_kernels(probe)
    walls["12 kernel times"] = time.perf_counter() - t_times
    print(json.dumps({"card": card, "training": {
        k: v for k, v in trained.items() if k != "scene"}, "train_step": step_times,
        "composite_bwd_by_channels": {str(c): {k: v for k, v in d.items()}
                                      for c, d in kt["composite_bwd"].items()},
        "segsum_by_width": {str(d): v for d, v in kt["segsum"].items()},
        "segsum_by_shape": kt["segsum_tools"], "segsum_probe": pt}, default=str))
    cb, sg = kt["composite_bwd"], kt["segsum"]
    # The multi-step dispatch's numbers, together (CUDA-graph replays against
    # eager calls, all from this run).
    g = step_times["graphed"]
    print(json.dumps({"card": card, "dispatch": dict(
        train_step_ms=dict(eager=step_times["step_ms"], graphed=g["step_ms"]),
        train_busy_share=dict(
            eager=step_times["profile"].get("device_busy_share")
            if isinstance(step_times["profile"], dict) else step_times["profile"],
            graphed=g["profile"].get("device_busy_share")
            if isinstance(g["profile"], dict) else g["profile"]),
        train_capture_s=g["capture_s"], train_graphs_100_steps=trained["graphs"],
        train_eager_cli_s=trained["eager"]["cli_wall_s"], train_cli_s=trained["cli_wall_s"],
        peak_gib_graphed_train=g["peak_gib"], eval_view_ms=evaluated["view_ms"],
        fuse_view_ms=fused["times"]["fuse_scene_view_ms"])}))

    def segsum_numbers(v):
        return dict(ms=v["ms"], plain_ms=v["plain_ms"], library_ms=v["library_ms"],
                    device_us=v["device_us"], library_device_us=v["library_device_us"],
                    max_abs_err=v["max_abs_err"], bound_ms=max(v["bound"]) * 1e3)
    kernel_lines += [
        kernel_entry("composite_bwd", "semantic_gaussians_torch/csrc/composite_bwd.cu",
                     "semantic_gaussians_tpu/ops/composite_pallas.py:450", cb[3],
                     max(d["max_abs_err"] for d in cb.values()), card,
                     shape="C=3 on the viewer's binning; by_channels has C=515 and 768; "
                           "training_view is the timed train view at C=3",
                     device_us=cb[3]["device_us"],
                     by_channels={str(c): composite_numbers(d) for c, d in cb.items()},
                     training_view=step_times["composite"]["composite_bwd"]),
        kernel_entry("segsum", "semantic_gaussians_torch/csrc/segsum.cu",
                     "semantic_gaussians_tpu/ops/segsum.py:81", sg[9],
                     max(d["max_abs_err"] for d in sg.values()), card,
                     also_replaces="semantic_gaussians_tpu/ops/segsum.py:106",
                     shape="D=9 (RGB training); by_width has D=774, by_shape the probe "
                           "tools' D=16 shapes; library is index_add_",
                     by_width={str(d): segsum_numbers(v) for d, v in sg.items()},
                     by_shape={name: dict(segsum_numbers(v), p=v["p"], rows=v["rows"])
                               for name, v in kt["segsum_tools"].items()},
                     replay_check={str(d): [r["bit_identical"] and r["within_tolerance"]
                                            for r in rows]
                                   for d, rows in segsum_replay.items()}),
        # The two probe kernels of the JAX tools are one function with one
        # switch, and so is the port's: one entry per mode, each naming the
        # tool that times that mode first.
        kernel_entry("segsum_probe_fold", "semantic_gaussians_torch/csrc/segsum_probe.cu",
                     "tools/exp_panel2.py:66", pt["fold"], pt["fold"]["max_abs_err"], card,
                     also_replaces="tools/exp_panel.py:57",
                     shape="d=16, p=3,670,016, rows=1,000,000; library is index_add_ on "
                           "the probe's target rows"),
        kernel_entry("segsum_probe_window", "semantic_gaussians_torch/csrc/segsum_probe.cu",
                     "tools/exp_panel.py:57", pt["window"], pt["window"]["max_abs_err"], card,
                     also_replaces="tools/exp_panel2.py:66",
                     shape="d=16, p=3,670,016, rows=1,000,000; library is index_add_ on "
                           "the probe's target rows"),
    ]
    viewer_ex = ex_by_shape["viewer cull=on"]
    kernel_lines.insert(0, kernel_entry(
        "expand", "semantic_gaussians_torch/csrc/expand.cu",
        "semantic_gaussians_tpu/ops/expand.py:121", viewer_ex, 0.0,
        card, shape="viewer, cull on (every render's binning); by_shape has the viewer, the "
                    "timed training view and a 1M-Gaussian scene, cull on and off",
        device_us=viewer_ex["device_us"],
        by_shape={k: expand_numbers(v) for k, v in ex_by_shape.items()}))
    # Launches, counted from 0 over each main path's run: the viewer's
    # requests (phase 3), the train CLI (7), the fusion CLI (9), the distill
    # CLI (9b), the eval CLI's six runs (10), the two probe tools (11) and
    # the distributed schedules' calls in this process and in the two-rank
    # children (15), and the three harness paths (16). `launches` is their sum.
    for e in kernel_lines:
        if e["name"] == "composite_fwd":
            e["training_view"] = step_times["composite"]["composite_fwd"]
    paths = {"viewer": viewer_launches, "train": trained["launches"],
             "fusion": fused["launches"], "distill": distilled["launches"],
             "eval": evaluated["launches"], **models_2d["launches"],
             "tools": tools["launches"], "distributed": distributed["launches"],
             **harnesses["launches"], "bench_tools": bench_tools["launches"],
             "scannet": scannet["launches"]}
    for e in kernel_lines:
        by_path_err = dict(harnesses["errors"].get(e["name"], {}))
        if e["name"] in bench_tools["errors"]:
            by_path_err["bench_tools"] = bench_tools["errors"][e["name"]]
        if e["name"] in scannet["errors"]:
            by_path_err["scannet"] = scannet["errors"][e["name"]]
        if by_path_err:
            e["max_abs_err_by_path"] = by_path_err
        by_path = {name: counts[e["name"]] for name, counts in paths.items()}
        e["launches"] = sum(by_path.values())
        e["launches_by_path"] = by_path
        if e["launches"] <= 0:
            fail(f"kernel {e['name']} was launched on no main path")
    walls["total"] = time.perf_counter() - t_run
    print(json.dumps({"card": card, "phase_walls_s": walls}))
    print(json.dumps({"kernels": kernel_lines}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


# ------------------------------------------------------------------ expand
EXPAND_MILLION = 1_000_000  # Gaussians: a Mip-NeRF 360 scene holds 1-6M


def viewer_camera(dev):
    """The viewer requests' camera (QUERY: the bench camera at 640x480)."""
    from semantic_gaussians_torch.cli.view_server import camera_from_query

    return camera_from_query({k: [v] for k, v in (p.split("=") for p in QUERY.split("&"))}).to(dev)


def padded_params(arrays, dev):
    """(params, alive) of `arrays` padded to the port's capacity granule as
    the viewer's PLY load pads them: dead slots zero, opacity logit -20."""
    import numpy as np
    import torch

    from semantic_gaussians_torch.core.gaussians import params_from_numpy, round_capacity

    n = len(arrays["means"])
    cap = round_capacity(n)
    padded = {}
    for k, v in arrays.items():
        padded[k] = np.full((cap,) + v.shape[1:], -20.0 if k == "opacity_logits" else 0.0,
                            np.float32)
        padded[k][:n] = v
    return params_from_numpy(padded, dev), torch.arange(cap, device=dev) < n


def expand_args(ex, budget, grid, n, th, tw):
    """expand_pairs' arguments from depth_sorted_rects' ExpandInputs `ex`
    (binning's own call)."""
    return (ex.offsets, ex.rect_packed_d, ex.idx_d, ex.cull_d, ex.num_pairs, ex.num_dense,
            budget, grid[1], grid[0] * grid[1], n, tw, th)


def expand_shape(params, alive, cam):
    """One view's expand inputs, as bin_gaussians builds them, at the
    default pair budget of the params' capacity: {cull: {"ex":
    ExpandInputs, "args": expand_pairs' arguments, "binning": a call of
    bin_gaussians on the same projection}} for the cull on and off."""
    import torch

    from semantic_gaussians_torch.ops.binning import (
        bin_gaussians, default_pair_budget, depth_sorted_rects,
    )
    from semantic_gaussians_torch.ops.projection import project_gaussians

    th, tw = 16, 32
    grid = (-(-cam.height // th), -(-cam.width // tw))
    n = params.capacity
    budget = default_pair_budget(n)
    if budget >= 1 << 24:
        fail(f"pair budget {budget} of capacity {n} is not below 2^24")
    with torch.no_grad():
        proj = project_gaussians(
            params.means, params.scales, params.quats, params.opacity[:, 0], cam.world_view,
            cam.full_proj, cam.camera_center, cam.width, cam.height, cam.tan_half_fov_x,
            cam.tan_half_fov_y, sh_coeffs=params.sh_coeffs, sh_degree=params.max_sh_degree,
            alive=alive)
    out = {}
    for cull in (True, False):
        ellipse = proj.cull_ellipse if cull else None
        ex = depth_sorted_rects(proj.means2d, proj.depths, proj.radii_xy, (th, tw), grid,
                                budget, ellipse)
        out[cull] = dict(
            ex=ex, args=expand_args(ex, budget, grid, n, th, tw),
            binning=lambda e=ellipse: bin_gaussians(
                proj.means2d, proj.depths, proj.radii_xy, (th, tw), grid, budget, e))
    return out


def million_shape(dev):
    """Expand inputs of bench.py's scene law at EXPAND_MILLION Gaussians
    (capacity 1,003,520, pair budget 12,042,240) through the viewer camera."""
    import numpy as np

    arrays, _ = make_scene(np, EXPAND_MILLION, feats=False)
    params, alive = padded_params(arrays, dev)
    return expand_shape(params, alive, viewer_camera(dev))


def check_expand(label, module, args, want=None):
    """`module`'s expand_pairs on `args` against the plain version (`want`,
    its outputs when given), bit for bit; returns the plain outputs."""
    import torch

    from semantic_gaussians_torch.ops import expand

    if want is None:
        want = expand.expand_pairs_plain(*args)
    got = module.expand_pairs(*args)
    torch.cuda.synchronize()
    for a, b, name in zip(got, want, ("tile", "g_key", "gen_owner")):
        if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
            bad = int((a != b).sum()) if a.shape == b.shape else "all"
            fail(f"expand ({label}) {name}: {bad} slots differ from the plain version")
    return want


def check_and_time_expand(card, shapes):
    """Expand at each shape of `shapes` ({name: expand_shape(...)}), cull on
    and off: the kernel bit for bit against the plain version, then its
    time by CUDA events over 50 back-to-back wrapper calls (`ms`), by graph
    replays (`device_us`: one call a graph; `device_us_10`: ten calls a
    graph, per call), the host's time to enqueue one wrapper call
    (`host_enqueue_us`), the plain version's and bin_gaussians' times
    (expand's share of binning's device time), the plain version's peak
    memory and the bound."""
    import torch

    from semantic_gaussians_torch.ops import expand

    out = {}
    for name, by_cull in shapes.items():
        for cull, sh in by_cull.items():
            label = f"{name} cull={'on' if cull else 'off'}"
            args, ex = sh["args"], sh["ex"]
            budget, num_tiles, n = args[6], args[8], args[9]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            want = expand.expand_pairs_plain(*args)
            torch.cuda.synchronize()
            plain_peak = torch.cuda.max_memory_allocated() - base
            check_expand(label, expand, args, want)
            valid, dense = int(ex.num_pairs), int(ex.num_dense)
            live = int((want[0] < num_tiles).sum())
            del want
            # bytes: offsets, rects and ids (12 B) and, with the cull, its
            # table (20 B) per pair-emitting Gaussian in (the rows past
            # num_dense, padding and Gaussians with no tile, are not read);
            # 12 B per slot out. f32 ops: ~65 per valid slot with the cull
            # (tile_min_qn; the integer search and decode are not counted),
            # none without.
            fn = lambda: expand.expand_pairs(*args)
            r = dict(n=n, num_dense=dense, budget=budget, valid=valid, live=live,
                     overflow=int(ex.overflow),
                     bound=(((32 if cull else 12) * dense + 12 * budget) / PEAK_BYTES,
                            (65 * valid if cull else 0) / PEAK_F32),
                     plain_peak_mb=plain_peak / 2**20,
                     ms=cuda_ms(fn, 50), device_us=device_us(fn),
                     device_us_10=device_us(fn, calls=10), host_enqueue_us=enqueue_us(fn),
                     plain_ms=cuda_ms(lambda: expand.expand_pairs_plain(*args), 3),
                     binning_ms=cuda_ms(sh["binning"], 10),
                     binning_device_us=device_us(sh["binning"]))
            r["bound_ms"] = max(r["bound"]) * 1e3
            r["expand_share_of_binning"] = r["device_us"] / r["binning_device_us"]
            out[label] = r
            print(f"expand {label}: bit-identical on {budget} slots ({valid} valid, {live} "
                  f"live, n={n}, num_dense={dense}); {r['ms']:.4f} ms, dev "
                  f"{r['device_us']:.2f} us (x10 {r['device_us_10']:.2f}), enqueue "
                  f"{r['host_enqueue_us']:.1f} us; bound {r['bound_ms'] * 1e3:.2f} us; binning "
                  f"{r['binning_ms']:.4f} ms, dev {r['binning_device_us']:.2f} us; plain peak "
                  f"{r['plain_peak_mb']:.0f} MiB")
    print(json.dumps({"card": card, "expand_by_shape": out}))
    return out


def expand_numbers(r):
    """One shape's expand numbers for the kernels line."""
    keep = ("n", "num_dense", "budget", "valid", "live", "bound_ms", "ms", "device_us",
            "device_us_10", "host_enqueue_us", "plain_ms", "binning_ms",
            "binning_device_us", "expand_share_of_binning")
    return {k: r[k] for k in keep}


def check_expand_cases(dev):
    """The expand kernel on every case of tools/expand_cases.py (the ones
    the CPU tests hold the plain version against the JAX kernel on, and the
    out-of-contract one that takes the kernel's per-slot search), cull on
    and off, bit for bit against the plain version."""
    from semantic_gaussians_torch.ops import expand
    from semantic_gaussians_torch.tools.expand_cases import beyond_contract_case, expand_cases

    k = 0
    for c in [*expand_cases(), beyond_contract_case()]:
        for cull in (True, False):
            check_expand(f"case {c.name}, cull={cull}", expand, c.torch_args(cull, dev))
            k += 1
    print(f"expand cases: {k} kernel-vs-plain checks passed, bit for bit")


def all_counters():
    """Every kernel's launch counter, in the order of the kernels line."""
    from semantic_gaussians_torch.ops import composite, expand, segsum, segsum_probe

    return (expand.LAUNCHES, composite.LAUNCHES, composite.BWD_LAUNCHES, segsum.LAUNCHES,
            segsum_probe.LAUNCHES["fold"], segsum_probe.LAUNCHES["window"])


def count_launches(path, run, must_launch):
    """Run one main path with every launch count set to 0 just before and
    read just after; fail if a kernel of the path was launched no time.
    Returns (what run() returned, {kernel: launches})."""
    import torch

    counters = all_counters()
    for c in counters:
        c.reset()
    out = run()
    torch.cuda.synchronize()
    launches = {c.name: c.count for c in counters}
    for name in must_launch:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the {path} path")
    return out, launches


def serve_and_time(base, card, state, cam, arrays, budget, binning, comp_cases):
    """Phases 3-5 against the viewer server running at `base`; returns the
    kernels' launch counts over the viewer path's run and the forward
    composite's entry of the kernels line. `comp_cases` are its main-path
    inputs from phase 2 (expand is timed in phase 13)."""
    import numpy as np
    import torch

    from semantic_gaussians_torch.cli.view_server import encode_png
    from semantic_gaussians_torch.ops import composite
    from semantic_gaussians_torch.renderer import render, render_chn

    alive, dev = state.alive, cam.world_view.device
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

    counters = all_counters()
    for c in counters:
        c.reset()
    images = {m: get(m) for m in MODES}
    edit = post("/edit", "mode=Remove&edit=chair")
    edited = get("RGB")
    reset = post("/reset", "")
    after_reset = get("RGB")
    out_rgb = render(cam, state.params, alive=alive)
    out_feat = render_chn(cam, state.params, state.gauss_feats, alive=alive)
    torch.cuda.synchronize()
    launches = {c.name: c.count for c in counters}
    print(f"viewer path launches: {launches}; edit {edit}; reset {reset}")
    for name in ("expand", "composite_fwd"):  # the viewer renders without gradients
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the viewer path")
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
    num_pairs = int(binning.num_pairs)
    in_pairs = int(binning.tile_count.sum())
    used = int(torch.unique(binning.pair_gaussian[:in_pairs]).numel())
    by_c = {}
    for c, case in comp_cases.items():
        args, work = case["args"], case["work"]
        by_c[c] = dict(
            max_abs_err=case["max_abs_err"],
            ms=cuda_ms(lambda: composite.composite_forward(*args), 20),
            plain_ms=cuda_ms(lambda: composite.composite_forward_plain(*args), 1),
            device_us=device_us(lambda: composite.composite_forward(*args)),
            bound=forward_bound(args, work), work=work,
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
        "composite_by_channels": {str(c): d for c, d in by_c.items()},
    }))

    return launches, [
        kernel_entry("composite_fwd", "semantic_gaussians_torch/csrc/composite_fwd.cu",
                     "semantic_gaussians_tpu/ops/composite_pallas.py:264", by_c[3],
                     max(d["max_abs_err"] for d in by_c.values()), card,
                     shape="C=3 (RGB/Depth requests); by_channels has every C of the "
                           "viewer path; training_view is the timed train view at C=3",
                     device_us=by_c[3]["device_us"],
                     by_channels={str(c): composite_numbers(d) for c, d in by_c.items()}),
    ]


def kernel_entry(name, source, replaces, r, max_abs_err, card, **extra):
    """One kernel's entry of the kernels line, without its launch counts
    (main() adds those once both main paths have run). `replaces` /
    `max_abs_err` and `tpu_source` / `max_err_vs_plain` are two names each
    for one value: readers of this line know either set."""
    bytes_ms, ops_ms = (b * 1e3 for b in r["bound"])
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "tpu_source": replaces,
        "max_abs_err": max_abs_err, "max_err_vs_plain": max_abs_err,
        "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": r.get("library_ms"), "card": card, **extra,
    }


def composite_numbers(d):
    """One width's numbers of a composite kernel for the kernels line."""
    return dict(ms=d["ms"], plain_ms=d["plain_ms"], device_us=d["device_us"],
                max_abs_err=d["max_abs_err"], bound_ms=max(d["bound"]) * 1e3, work=d["work"])


def forward_bound(args, work):
    """(bytes s, ops s) of the forward composite on `args`. Bytes: geometry
    and colour rows of the Gaussians in tile ranges, their pair ids, tile
    ranges, the outputs. f32 ops, counted by the plain version on these
    inputs: ~18 for each (pixel, pair) whose alpha a pixel evaluates before
    it stops, 2C more for each one that contributes colour."""
    import torch

    colors, pair_gaussian, tile_count = args[1], args[2], args[4]
    c, nt = colors.shape[1], tile_count.numel()
    in_pairs = int(tile_count.sum())
    used = int(torch.unique(pair_gaussian[:in_pairs]).numel())
    cops = 18 * work["evaluated"] + 2 * c * work["contributed"]
    cbytes = used * (32 + 4 * c) + 4 * in_pairs + 8 * nt + nt * 512 * 4 * (c + 3)
    return cbytes / PEAK_BYTES, cops / PEAK_F32


def backward_bound(args, work):
    """(bytes s, ops s) of the composite backward on `args`. Bytes:
    geometry and colour rows of the Gaussians in tile ranges, their pair
    ids, tile ranges, the upstream gradient, final_T and n_contrib in; one
    (6 + C)-float row per pair in a tile range out. f32 ops, counted by the
    plain version on these inputs: ~18 per alpha up to each pixel's
    n_contrib, 20 + 4C per contributing event."""
    import torch

    colors, pair_gaussian, tile_count = args[1], args[2], args[4]
    c, nt = colors.shape[1], tile_count.numel()
    in_pairs = int(tile_count.sum())
    used = int(torch.unique(pair_gaussian[:in_pairs]).numel())
    cbytes = (used * (32 + 4 * c) + 4 * in_pairs + 8 * nt + nt * 512 * 4 * (c + 2)
              + in_pairs * (6 + c) * 4)
    cops = 18 * work["evaluated"] + (20 + 4 * c) * work["contributed"]
    return cbytes / PEAK_BYTES, cops / PEAK_F32


def close_enough(got, want, rtol, atol_scale, slack=None):
    """None if |got - want| <= rtol |want| + atol_scale * (max |want| of the
    column) [+ slack, elementwise] everywhere (columns: the last axis), else
    a description of the worst element."""
    import torch

    col_max = want.abs().amax(dim=0, keepdim=True)
    bound = rtol * want.abs() + atol_scale * col_max
    if slack is not None:
        bound = bound + slack
    bad = (got - want).abs() > bound
    bad |= ~torch.isfinite(got)
    if not bool(bad.any()):
        return None
    i = int(torch.nonzero(bad.flatten())[0])
    return (f"{int(bad.sum())} elements out of tolerance; first at flat index {i}: "
            f"got {float(got.flatten()[i])}, want {float(want.flatten()[i])}")


def check_backward_kernels(comp_cases, binning, grid, th, tw):
    """Kernel 3 (composite backward) and kernels 4/5 (segment sum) against
    their plain versions on the main path's 100k binning at 640x480, with a
    random upstream gradient, at C = 3 (the one-pass kernel), 515 and 768
    (the wide one); each kernel run twice must give the same bits. Prints
    the backward's launches by width. Returns the timing inputs of both
    kernels."""
    import torch

    from semantic_gaussians_torch.ops import composite
    from semantic_gaussians_torch.ops.rasterize import generation_rows

    dev = binning.tile_start.device
    nt = binning.tile_start.numel()
    in_pairs = int(binning.tile_count.sum())
    n = binning.orig_to_dense.numel()
    bwd, seg = {}, {}
    launches = composite.BWD_LAUNCHES.snapshot()
    for c in (3, JOINT_DIM, FEAT_DIM):
        args = comp_cases[c]["args"]
        _, _, final_t, n_contrib = composite.composite_forward(*args)
        gen = torch.Generator(dev).manual_seed(SEED + c)
        g_color = torch.randn((nt, c, th * tw), generator=gen, device=dev)
        bargs = args[:6] + (g_color, final_t, n_contrib, grid[1], th, tw)
        got = composite.composite_backward(*bargs)
        again = composite.composite_backward(*bargs)
        work = {}
        want = composite.composite_backward_plain(*bargs, work=work)
        torch.cuda.synchronize()
        if not torch.equal(got[:in_pairs], again[:in_pairs]):
            fail(f"composite_bwd C={c}: two runs differ")
        why = close_enough(got[:in_pairs], want[:in_pairs], 1e-4, 1e-5)
        if why:
            fail(f"composite_bwd C={c} vs plain: {why}")
        err = float((got[:in_pairs] - want[:in_pairs]).abs().max())
        bwd[c] = dict(args=bargs, max_abs_err=err, work=work)
        print(f"composite_bwd C={c}: {in_pairs} rows within rtol 1e-4 / atol 1e-5 x column "
              f"max, bit-identical over two runs, max |kernel - plain| = {err:.3g}; events "
              f"evaluated {work['evaluated']}, contributed {work['contributed']}")
        del again, want

        rows = generation_rows(got, binning)
        del got
        d = rows.shape[1]
        sargs = (rows, binning.gen_owner, n + 1, binning.num_pairs)
        seg[d] = dict(args=sargs, max_abs_err=check_segsum(f"D={d}", sargs, exact=False))
    by_width = {w: k for w, k in composite.BWD_LAUNCHES.since(launches)[1].items() if k}
    if by_width != {3: 2, JOINT_DIM: 2, FEAT_DIM: 2}:
        fail(f"composite_bwd launches by width {by_width}: one kernel a call expected")
    print(f"composite_bwd launches by channel width: {by_width}")
    return bwd, seg


def check_gradients_vs_dense(arrays, cam):
    """Gradients through the tiled path (the kernels) vs autograd through
    the dense oracle, 2000 Gaussians at 128x64: finite, and within atol
    2e-3 x the dense gradient's largest |value| (tests/test_rasterize.py's
    bar)."""
    import torch

    from semantic_gaussians_torch.core.gaussians import params_from_numpy
    from semantic_gaussians_torch.renderer import render

    dev = cam.world_view.device
    small = params_from_numpy({k: v[:2000] for k, v in arrays.items()}, dev)
    small_cam = cam.resized(128, 64)
    wimg = torch.rand((64, 128, 3), generator=torch.Generator(dev).manual_seed(SEED),
                      device=dev)
    leaves = ("means", "log_scales", "quats", "opacity_logits", "sh_dc")
    grads = {}
    for backend in ("tiled", "dense"):
        p = {k: getattr(small, k).clone().requires_grad_(k in leaves) for k in arrays}
        out = render(small_cam, type(small)(**p), backend=backend)
        g = torch.autograd.grad((out["render"] * wimg).sum(), [p[k] for k in leaves])
        grads[backend] = dict(zip(leaves, g))
    worst = {}
    for k in leaves:
        gt, gd = grads["tiled"][k], grads["dense"][k]
        if not torch.isfinite(gt).all():
            fail(f"tiled gradient of {k} is not finite")
        scale = float(gd.abs().max()) + 1e-8
        worst[k] = float((gt - gd).abs().max()) / scale
        if worst[k] > 2e-3:
            fail(f"tiled vs dense gradient of {k}: scaled error {worst[k]:.3g} > 2e-3")
    print(f"gradients: tiled (kernels) vs dense oracle on 2000 Gaussians at 128x64, "
          f"scaled max errors {json.dumps(worst)}")
    return worst


def ring_cameras(centre, radius, views):
    """OpenGL (Blender) camera-to-world poses on a ring around `centre`,
    looking at it, with a small alternating elevation."""
    import numpy as np

    poses = []
    for i in range(views):
        ang = 2 * np.pi * i / views
        pos = centre + radius * np.array([np.sin(ang), 0.15 * (-1) ** i, -np.cos(ang)])
        fwd = (centre - pos) / np.linalg.norm(centre - pos)
        right = np.cross(np.array([0.0, 1.0, 0.0]), fwd)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        c2w = np.eye(4)
        c2w[:3, :3] = np.stack([right, -down, -fwd], axis=1)
        c2w[:3, 3] = pos
        poses.append(c2w)
    return poses


def write_blender_scene(root, arrays, dev):
    """The training scene: 8 views on a ring around the bench cloud, their
    640x480 PNGs rendered by the port from the 100k target, and
    points3d.ply with the target's means and jittered colours. Returns the
    camera fov_x and the number of points."""
    import math

    import numpy as np
    import torch

    from semantic_gaussians_torch.cli.view_server import encode_png
    from semantic_gaussians_torch.core.gaussians import params_from_numpy
    from semantic_gaussians_torch.io.ply import save_point_cloud
    from semantic_gaussians_torch.renderer import render
    from semantic_gaussians_torch.utils.camera import make_camera

    target = params_from_numpy(arrays, dev)
    fov_x = 2 * math.atan(math.tan(0.55) * WIDTH / HEIGHT)
    fov_y = 2 * math.atan(math.tan(fov_x / 2) * HEIGHT / WIDTH)
    (root / "train").mkdir(parents=True)
    frames = []
    for i, c2w in enumerate(ring_cameras(np.array([0.0, 0.0, 4.0]), TRAIN_RADIUS, TRAIN_VIEWS)):
        flip = c2w.copy()
        flip[:3, 1:3] *= -1
        w2c = np.linalg.inv(flip)
        cam = make_camera(w2c[:3, :3].T, w2c[:3, 3], fov_x, fov_y, WIDTH, HEIGHT, device=dev)
        with torch.no_grad():
            img = render(cam, target, bg=torch.zeros(3, device=dev))["render"]
        png = (torch.clamp(img, 0, 1) * 255 + 0.5).to(torch.uint8).cpu().numpy()
        (root / "train" / f"r_{i}.png").write_bytes(encode_png(png))
        frames.append({"file_path": f"./train/r_{i}", "transform_matrix": c2w.tolist()})
    meta = json.dumps({"camera_angle_x": fov_x, "frames": frames})
    (root / "transforms_train.json").write_text(meta)
    (root / "transforms_test.json").write_text(meta)  # evaluate on the training views
    rng = np.random.default_rng(SEED + 1)
    cols = arrays["sh_dc"][:, 0, :] * 0.28209479177387814 + 0.5
    jitter = np.clip(cols + rng.normal(size=cols.shape) * 0.15, 0, 1)
    save_point_cloud(root / "points3d.ply", arrays["means"], jitter)
    return fov_x, len(cols)


def train_through_cli(tmpdir, arrays, dev):
    """The training main path: the train CLI, in process, on the Blender
    scene, with every kernel's launch count set to 0 just before and read
    just after. Checks the run and returns what the timing phase needs."""
    import numpy as np
    import torch

    from semantic_gaussians_torch.cli import train as train_cli
    from semantic_gaussians_torch.cli.view_server import ViewerState
    from semantic_gaussians_torch.config.config import default_config_dir, load_config
    from semantic_gaussians_torch.ops import composite, expand, segsum
    from semantic_gaussians_torch.pipelines.train import opacity_reset_step

    scene = tmpdir / "scene"
    t0 = time.perf_counter()
    write_blender_scene(scene, arrays, dev)
    print(f"training scene written in {time.perf_counter() - t0:.1f} s: {TRAIN_VIEWS} views "
          f"at {WIDTH}x{HEIGHT}, {len(arrays['means'])} points")
    out_dir = tmpdir / "train_out"

    def cli(out, *extra):
        return train_cli.main([
            str(ROOT / "semantic_gaussians_torch" / "config" / "yamls" / "official_train.yaml"),
            f"scene.scene_path={scene}", f"train.out_dir={out}",
            f"train.iterations={TRAIN_ITERS}", f"train.test_iterations=[0,{TRAIN_ITERS}]",
            "train.save_iterations=[]", "train.densify_from_iter=20",
            "train.densification_interval=20", f"train.densify_until_iter={TRAIN_ITERS}",
            "train.random_background=false", *extra])

    counters = all_counters()
    for c in counters:
        c.reset()
    t0 = time.perf_counter()
    summary = cli(out_dir)  # the default: train.steps_per_dispatch = 10, graphed chunks
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.name: c.count for c in counters}
    log = summary["logs"][0]
    print(f"train CLI: {TRAIN_ITERS} steps in {wall:.1f} s (scene load, init, tests and PLY "
          f"save included), chunks of {log['chunks'][0][1]}, CUDA graphs {log['graphs']}; "
          f"launches {launches} (a replay counts what its graph launches)")
    if log["graphs"]["replays"] != len(log["chunks"]) or max(n for _, n in log["chunks"]) != 10:
        fail(f"the train CLI's chunks were not one replay each: {log['chunks']} {log['graphs']}")
    eager = compare_eager_training(cli, tmpdir, summary)
    for name in ("expand", "composite_fwd", "composite_bwd", "segsum"):
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the training path")
    if not torch.isfinite(log["loss"]).all():
        fail(f"non-finite loss at steps {torch.nonzero(~torch.isfinite(log['loss'])).tolist()}")
    (_, psnr0), (_, psnr1) = summary["tests"][0], summary["tests"][TRAIN_ITERS]
    print(f"train-view PSNR: initial {psnr0:.3f} dB, after {TRAIN_ITERS} steps {psnr1:.3f} dB")
    if not psnr1 >= psnr0 + 1.0:
        fail(f"PSNR rose {psnr1 - psnr0:.3f} dB, less than 1 dB")
    n_points = len(arrays["means"])
    if not log["densify"] or all(a == n_points for _, a, _ in log["densify"]):
        fail(f"densify did not change the alive count: {log['densify']}")
    print(f"densify events (iteration, alive after, dropped): {log['densify']}")
    if int(log["overflow"][-1]) != 0:
        fail(f"the last step overflowed its pair budget {log['budget'][-1]}")
    ply = summary["plys"][-1]
    cfg = load_config(default_config_dir() / "view_scannet.yaml", [f"model.model_dir={out_dir}"])
    viewer = ViewerState(cfg)
    img = viewer.render({"mode": ["RGB"], "w": [str(WIDTH)], "h": [str(HEIGHT)],
                         "fov": ["1.1"], "pose": [POSE]})
    if img.shape != (HEIGHT, WIDTH, 3) or img.max() == img.min():
        fail(f"the trained PLY does not render through ViewerState: {img.shape}")
    print(f"trained PLY {ply.name} ({int(viewer.alive.sum())} Gaussians) renders through "
          f"ViewerState")
    state = opacity_reset_step(summary["state"])
    if float(state.params.opacity.max()) > 0.01 + 1e-6:
        fail("opacity_reset_step left an opacity above 0.01")
    if state.adam.mu.opacity_logits.any() or state.adam.nu.opacity_logits.any():
        fail("opacity_reset_step left non-zero opacity moments")
    print("opacity reset: every opacity <= 0.01, opacity moments zero")
    return dict(
        scene=scene, launches=launches, psnr=(psnr0, psnr1), densify=log["densify"],
        cli_wall_s=wall, budgets=sorted(set(log["budget"])), graphs=log["graphs"],
        loss_first_last=(float(log["loss"][0]), float(log["loss"][-1])), eager=eager,
    )


def compare_eager_training(cli, tmpdir, graphed):
    """The train CLI's 100 steps again, eagerly (steps_per_dispatch = 1),
    twice, from the same seed: camera order, the budget of every step, the
    densify events and the alive set must equal the graphed run's. Losses:
    where the two eager runs agree bit for bit, the graphed run must too;
    otherwise it must lie within the eager runs' own spread (the largest
    |difference| between them at each step). Returns what was compared."""
    import torch

    glog, gstate = graphed["logs"][0], graphed["state"]
    runs = []
    for i in range(2):
        t0 = time.perf_counter()
        out = cli(tmpdir / f"train_eager_{i}", "train.steps_per_dispatch=1")
        torch.cuda.synchronize()
        runs.append((out, time.perf_counter() - t0))
    (a, wall_a), (b, wall_b) = runs
    la, lb = a["logs"][0], b["logs"][0]
    for name, out in (("eager", a), ("eager again", b)):
        log = out["logs"][0]
        for key in ("cameras", "budget", "densify"):
            if log[key] != glog[key]:
                fail(f"training: the {name} run's {key} differ from the graphed run's")
        if not torch.equal(out["state"].alive, gstate.alive):
            fail(f"training: the {name} run's alive set differs from the graphed run's")
        if log["graphs"]["captures"]:
            fail(f"training: the {name} run captured a graph at steps_per_dispatch = 1")
    eager_bitwise = torch.equal(la["loss"], lb["loss"])
    gap = (glog["loss"] - la["loss"]).abs()
    spread = (la["loss"] - lb["loss"]).abs()
    if eager_bitwise:
        if not torch.equal(glog["loss"], la["loss"]):
            fail(f"training: graphed losses differ from two bit-identical eager runs' by up to "
                 f"{float(gap.max()):.3g}")
        held = "bit for bit (the two eager runs agree bit for bit)"
    else:
        if bool((gap > spread).any()):
            fail(f"training: graphed losses leave the eager runs' spread (largest gap "
                 f"{float(gap.max()):.3g}, spread {float(spread.max()):.3g})")
        held = f"within the eager runs' own spread (up to {float(spread.max()):.3g})"
    print(f"train CLI eager x2 ({wall_a:.1f} s, {wall_b:.1f} s) against the graphed run: "
          f"camera order, budgets, densify events and the alive set exact; losses {held}")
    return dict(eager_bitwise=eager_bitwise, loss_held=held, cli_wall_s=(wall_a, wall_b),
                max_loss_gap=float(gap.max()), eager_spread=float(spread.max()))


def time_training(scene, dev, card):
    """One train step at 100k / 640x480 from the CLI's initial state: the
    whole step (median of 25 after warm-up, host clock ending in a
    synchronize), its parts (render, loss, backward, Adam + statistics,
    each ended by a synchronize), and the device-busy share of one step."""
    import torch

    from semantic_gaussians_torch.core.densify import add_stats
    from semantic_gaussians_torch.core.gaussians import FIELDS
    from semantic_gaussians_torch.core.optimizer import adam_update, lr_tree
    from semantic_gaussians_torch.ops.binning import default_pair_budget
    from semantic_gaussians_torch.pipelines.train import (
        TrainConfig, init_train_state, train_step,
    )
    from semantic_gaussians_torch.renderer import render
    from semantic_gaussians_torch.utils.losses import photometric_loss

    info, cam, params, alive = training_view(scene, dev)
    state = init_train_state(params, alive)
    cfg = TrainConfig(spatial_lr_scale=float(info.nerf_normalization["radius"]))
    if cfg.cut_edge:
        fail("the timed step assumes no edge crop")
    bg = torch.zeros(3, device=dev)
    budget = default_pair_budget(params.capacity)

    def step():
        out = train_step(state, cam, bg, cfg, 3, pair_budget=budget)
        torch.cuda.synchronize()
        return out

    def step_in_parts():
        """train_step's work, part by part, each part ended by a synchronize."""
        marks = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        leaves = {f: getattr(params, f).detach().requires_grad_(True) for f in FIELDS}
        offset = torch.zeros((params.capacity, 2), device=dev, requires_grad=True)
        out = render(cam, type(params)(**leaves), alive=alive, bg=bg, active_sh_degree=3,
                     mean2d_offset=offset, pair_budget=budget)
        mark()
        loss = photometric_loss(out["render"], cam.image, cfg.lambda_dssim)
        mark()
        grads = torch.autograd.grad(loss, [leaves[f] for f in FIELDS] + [offset])
        mark()
        add_stats(state.dstate, grads[-1], out["radii"], cam.width, cam.height)
        adam_update(type(params)(**dict(zip(FIELDS, grads[:-1]))), state.adam, params,
                    lr_tree(cfg.hyper, cfg.spatial_lr_scale, state.step), cfg.hyper)
        mark()
        return [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]

    step_ms = host_ms(step, 25)
    torch.cuda.synchronize()
    runs = [step_in_parts() for _ in range(26)][1:]
    parts = {k: statistics.median(r[i] for r in runs)
             for i, k in enumerate(("render", "loss", "backward", "adam"))}
    prof = profile(step)
    _, metrics = step()
    comp = time_composite_view(params, alive, cam, bg, budget)
    # The backward kernel's share of one step's device time (its graph-replay
    # time over the profiler's device total for a step).
    if isinstance(prof, dict):
        prof["composite_bwd_share"] = comp["composite_bwd"]["device_us"] / 1e3 / prof["device_ms"]
        prof["composite_fwd_share"] = comp["composite_fwd"]["device_us"] / 1e3 / prof["device_ms"]
    graphed = time_graphed_training(scene, cfg, budget, dev)
    print(json.dumps({"card": card, "train_step_ms": step_ms, "train_step_parts_ms": parts,
                      "train_step_profile": prof, "pair_budget": budget,
                      "num_pairs": int(metrics["num_pairs"]), "composite_on_train_view": comp,
                      "graphed_train_step": graphed}))
    def busy(p):
        return f"{p['device_busy_share']:.3f}" if isinstance(p, dict) else p

    print(f"train step: eager {step_ms:.3f} ms, busy {busy(prof)}; graphed "
          f"{graphed['step_ms']:.3f} ms (a chunk of {graphed['k']} steps / {graphed['k']}), busy "
          f"{busy(graphed['profile'])}; {card}")
    return dict(step_ms=step_ms, parts=parts, profile=prof, composite=comp, graphed=graphed)


def time_graphed_training(scene, cfg, budget, dev, k=10):
    """train_scan_step at K = 10 (the train CLI's default chunk) from the
    timed view's start state, on the training scene's views in turn, at SH
    degree 3 and the timed step's budget: the capture (its warm-up and the
    first replay, host clock), then the median host time of a chunk (one
    replay, ended by a synchronize) over 10 chunks, divided by K; one
    chunk's device-busy share; peak device memory over the capture and the
    replays, with the graph cached."""
    import torch

    from semantic_gaussians_torch.io.scene import load_scene, realize_camera
    from semantic_gaussians_torch.pipelines.train import (
        init_train_state, stack_camera_chunk, train_scan_step,
    )
    from semantic_gaussians_torch.utils.graphs import GraphRunner

    cams = [realize_camera(c, device=dev) for c in load_scene(scene).train_cameras]
    stack = stack_camera_chunk([cams[i % len(cams)] for i in range(k)])
    bgs = torch.zeros((k, 3), device=dev)
    _, _, params, alive = training_view(scene, dev)
    box = [init_train_state(params, alive)]
    runner = GraphRunner(dev)

    def chunk():
        box[0], _ = train_scan_step(box[0], stack, bgs, cfg, 3, pair_budget=budget,
                                    runner=runner)
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    chunk()
    capture_s = time.perf_counter() - t0
    chunk_ms = host_ms(chunk, 10)
    prof = profile(chunk)
    out = dict(k=k, step_ms=chunk_ms / k, chunk_ms=chunk_ms, capture_s=capture_s,
               profile=prof, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               captures=runner.captures, replays=runner.replays)
    del runner, box
    return out


def training_view(scene, dev):
    """The timed training view: the train CLI's initial state (from the
    scene's point cloud) and the first training camera. Returns (scene
    info, camera, params, alive)."""
    from semantic_gaussians_torch.core.gaussians import init_from_pcd
    from semantic_gaussians_torch.io.scene import load_scene, realize_camera

    info = load_scene(scene)
    cam = realize_camera(info.train_cameras[0], device=dev)
    params, alive = init_from_pcd(info.points, info.colors, device=dev)
    return info, cam, params, alive


def time_composite_view(params, alive, cam, bg, budget):
    """Both composite kernels at C = 3 on the binning of one training view
    (the inputs of the train step's kernels, with a random upstream
    gradient): checked against the plain versions (check_composite), then
    timed by CUDA events and `device_us`, with their bounds."""
    import torch

    from semantic_gaussians_torch.ops import composite
    from semantic_gaussians_torch.ops.binning import bin_gaussians
    from semantic_gaussians_torch.ops.projection import project_gaussians

    th, tw = 16, 32
    grid = (-(-cam.height // th), -(-cam.width // tw))
    with torch.no_grad():
        proj = project_gaussians(
            params.means, params.scales, params.quats, params.opacity[:, 0], cam.world_view,
            cam.full_proj, cam.camera_center, cam.width, cam.height, cam.tan_half_fov_x,
            cam.tan_half_fov_y, sh_coeffs=params.sh_coeffs, sh_degree=3, alive=alive)
        binning = bin_gaussians(proj.means2d, proj.depths, proj.radii_xy, (th, tw), grid,
                                budget, proj.cull_ellipse)
        geom = composite.pack_geometry(proj.means2d, proj.conics, proj.opacities, proj.depths)
        args = (geom, proj.colors.to(torch.float32).contiguous(), binning.pair_gaussian,
                binning.tile_start, binning.tile_count, bg, grid[1], th, tw)
        nt = binning.tile_start.numel()
        g_color = torch.randn((nt, 3, th * tw), generator=torch.Generator(bg.device).manual_seed(
            SEED + 7), device=bg.device)
        bargs, fwd_err, bwd_err, fwd_work, bwd_work = check_composite(
            "composite on the training view", args, g_color)
    in_pairs = int(binning.tile_count.sum())
    out = {"pairs": in_pairs, "max_tile_pairs": int(binning.tile_count.max())}
    for name, fn, plain, a, work, bound, err in (
            ("composite_fwd", composite.composite_forward, composite.composite_forward_plain,
             args, fwd_work, forward_bound, fwd_err),
            ("composite_bwd", composite.composite_backward, composite.composite_backward_plain,
             bargs, bwd_work, backward_bound, bwd_err)):
        out[name] = dict(
            ms=cuda_ms(lambda: fn(*a), 20), plain_ms=cuda_ms(lambda: plain(*a), 1),
            device_us=device_us(lambda: fn(*a)), bound_ms=max(bound(a, work)) * 1e3,
            work=work, max_abs_err=err)
    print(f"composite on the training view ({in_pairs} pairs): kernels within tolerance of "
          f"the plain versions; forward {out['composite_fwd']['ms']:.4f} ms, backward "
          f"{out['composite_bwd']['ms']:.4f} ms")
    return out


def time_backward_kernels(bwd, seg):
    """CUDA-event times and `device_us` of kernel 3 and kernels 4/5 at the
    main path's shapes, their plain versions, their bounds from this run's
    data, and index_add_ (the one PyTorch call computing the segment sum)."""
    from semantic_gaussians_torch.ops import composite

    out = {"composite_bwd": {}}
    for c, case in bwd.items():
        args, work = case["args"], case["work"]
        out["composite_bwd"][c] = dict(
            max_abs_err=case["max_abs_err"], work=work,
            ms=cuda_ms(lambda: composite.composite_backward(*args), 10),
            plain_ms=cuda_ms(lambda: composite.composite_backward_plain(*args), 1),
            device_us=device_us(lambda: composite.composite_backward(*args), 5),
            bound=backward_bound(args, work),
        )
    out["segsum"] = time_segsums(seg)
    return out


def time_segsums(cases):
    """CUDA-event times of the segment sum on each case's arguments, its
    plain version, its byte bound from the case's live rows, and
    `index_add_`, the one PyTorch call that computes the same function."""
    import torch

    from semantic_gaussians_torch.ops import segsum

    out = {}
    for name, case in cases.items():
        rows, owners, num_rows, limit = case["args"]
        d = rows.shape[1]
        live = rows.shape[0] if limit is None else int(limit)
        # bytes: the live rows and their owners in, the sums out; one add
        # per element read.
        sbytes = live * d * 4 + live * 4 + num_rows * d * 4
        owners_l = owners[:live].long()
        rows_l = rows[:live]

        def library():
            torch.zeros((num_rows, d), device=rows.device).index_add_(0, owners_l, rows_l)

        out[name] = dict(
            max_abs_err=case["max_abs_err"], p=rows.shape[0], rows=num_rows,
            ms=cuda_ms(lambda: segsum.segsum_contiguous(*case["args"]), 20),
            plain_ms=cuda_ms(lambda: segsum.segsum_contiguous_plain(*case["args"]), 3),
            library_ms=cuda_ms(library, 20),
            device_us=device_us(lambda: segsum.segsum_contiguous(*case["args"])),
            library_device_us=device_us(library),
            bound=(sbytes / PEAK_BYTES, live * d / PEAK_F32),
        )
    return out


def check_segsum(name, args, exact):
    """The segment sum on `args`, twice for the same bits, against its plain
    version at rtol 1e-5 / atol 1e-6 x the column's largest |value|. With
    `exact` the plain version sums in float64: where one segment has
    thousands to millions of rows, the float32 `index_add_` (atomics in any
    order) is itself further from the exact sum than that tolerance, and
    its own error is printed beside the kernel's. A float32 sum's rounding
    grows with the magnitudes it adds, not with their total, so against
    float64 the tolerance also has 2e-8 x the sum of the |values| added into
    the element (a long segment may sum to nearly nothing). Returns the
    largest |kernel - plain|."""
    import torch

    from semantic_gaussians_torch.ops import segsum

    out = segsum.segsum_contiguous(*args)
    again = segsum.segsum_contiguous(*args)
    plain = segsum.segsum_contiguous_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        fail(f"segsum {name}: two runs differ")
    ref, slack = plain, None
    if exact:
        ref = segsum.segsum_contiguous_plain(*args, acc_dtype=torch.float64)
        slack = 2e-8 * segsum.segsum_contiguous_plain(
            args[0].abs(), *args[1:], acc_dtype=torch.float64)
    why = close_enough(out, ref, 1e-5, 1e-6, slack)
    if why:
        fail(f"segsum {name} vs plain: {why}")
    err = float((out - ref).abs().max()) if out.numel() else 0.0
    note = ""
    if exact and out.numel():
        note = f" (float32 index_add_ against the same: {float((plain - ref).abs().max()):.3g})"
    print(f"segsum {name}: within rtol 1e-5 / atol 1e-6 x column max of the plain version"
          f"{' summed in float64' if exact else ''}, bit-identical over two runs, "
          f"max |kernel - plain| = {err:.3g}{note}")
    return err


def segsum_replay_feeds(d, p, num_rows, live, seed=SEED):
    """Three fresh inputs of one shape for the replay check: (owners [p]
    int32 numpy, limit, a numpy head of cot or None, a seed for the rest of
    cot, drawn on the card): (1) random runs over `live` rows (the
    main path's count), (2) a tools/summing_cases.py case of width d placed
    at the front where there is one, else short random runs, (3) runs longer
    than the look-back reaches (they defer to the carry levels) between
    short ones. Streams (2) and (3) are short for the grid, so the kernel
    looks back over tiles there: two replays in a row publish and read tags.
    Owners past the limit repeat the last one."""
    import numpy as np

    from semantic_gaussians_torch.ops.segsum import MAX_HOPS, tile_shape
    from semantic_gaussians_torch.tools import summing_cases

    rng = np.random.default_rng(seed + d)
    rows = tile_shape(d, p)[1]

    def feed(owners, limit, head=None):
        owners = np.minimum(np.asarray(owners, np.int64), num_rows - 1).astype(np.int32)
        full = np.full(p, owners[-1], np.int32)
        full[:owners.size] = owners
        return full, int(limit), head, int(rng.integers(2**31))

    def steps(n, rate, first=0):
        s = (rng.uniform(size=n) < rate).astype(np.int64)
        s[0] = 0
        return first + np.cumsum(s)

    feeds = [feed(steps(live, min(0.9, num_rows / live * 0.9)), live)]
    cases = [c for c in summing_cases.segsum_cases() if c.cot.shape[1] == d and c.limit is None
             and c.owners.size > rows]
    if cases:
        c = max(cases, key=lambda c: c.owners.size)
        feeds.append(feed(c.owners, c.owners.size, c.cot))
    else:
        feeds.append(feed(steps(40 * rows, 0.3), 40 * rows))
    long = (MAX_HOPS + 2) * rows
    head = steps(rows + rows // 3, 0.3)
    body = np.full(long, head[-1] + 1)
    tail = steps(2 * long, 0.2, head[-1] + 2)
    owners = np.r_[head, body, tail]
    feeds.append(feed(owners, owners.size))
    return feeds


def check_segsum_replay(dev, shapes):
    """Kernels 4/5 replayed from a CUDA graph on fresh inputs. For each
    width d, shapes[d] = (p, num_rows, live): one call is captured on static
    inputs [p, d], then replayed three times, each time after copying a
    fresh input (segsum_replay_feeds) into the static buffers, with no other
    call between the replays. Then each input is copied in again and the
    kernel called eagerly: every replay must give the eager call's bits, and
    hold the float64 plain sum at check_segsum's tolerance. Reports every
    replay, and fails at the end if one differed. Returns the report."""
    import torch

    from semantic_gaussians_torch.ops import segsum

    report, bad = {}, []
    for d, (p, num_rows, live) in shapes.items():
        feeds = segsum_replay_feeds(d, p, num_rows, live)
        cot = torch.empty((p, d), dtype=torch.float32, device=dev)
        owners = torch.empty(p, dtype=torch.int32, device=dev)
        limit = torch.empty((), dtype=torch.int32, device=dev)

        def fill(f):
            owners.copy_(torch.from_numpy(f[0]))
            limit.fill_(f[1])
            torch.randn((p, d), generator=torch.Generator(dev).manual_seed(f[3]), device=dev,
                        out=cot)
            if f[2] is not None:
                cot[:len(f[2])] = torch.from_numpy(f[2]).to(dev)

        fill(feeds[0])
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # claims the scratch at this shape
            segsum.segsum_contiguous(cot, owners, num_rows, limit)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = segsum.segsum_contiguous(cot, owners, num_rows, limit)
        replays = []
        for f in feeds:
            fill(f)
            graph.replay()
            replays.append(out.clone())
        torch.cuda.synchronize()
        rows = []
        for r, (f, got) in enumerate(zip(feeds, replays)):
            fill(f)
            want = segsum.segsum_contiguous(cot, owners, num_rows, limit)
            args = (cot, owners, num_rows, limit)
            ref = segsum.segsum_contiguous_plain(*args, acc_dtype=torch.float64)
            slack = 2e-8 * segsum.segsum_contiguous_plain(cot.abs(), *args[1:],
                                                          acc_dtype=torch.float64)
            why = close_enough(got, ref, 1e-5, 1e-6, slack)
            row = dict(limit=f[1], bit_identical=bool(torch.equal(got, want)),
                       elements_differing=int((got != want).sum()),
                       max_abs_vs_eager=float((got - want).abs().max()),
                       max_abs_vs_float64=float((got.double() - ref).abs().max()),
                       within_tolerance=why is None)
            rows.append(row)
            print(f"segsum replay D={d} (P={p}, rows={num_rows}) replay {r + 1}: {row}"
                  f"{'' if why is None else '; ' + why}")
            if not row["bit_identical"] or why is not None:
                bad.append(f"D={d} replay {r + 1}")
        report[d] = rows
        del graph, out, replays
    if bad:
        fail(f"segsum under CUDA-graph replay differs from eager calls: {bad}")
    return report


def check_tool_segsums(dev):
    """Kernels 4/5 at the probe tools' shapes, on the tools' own data
    (d = 16, `limit=None`): V0 (p = 3,670,016 over 1,000,000 rows), V4 (the
    same owners capped at 49,999: the last segment has ~3.49M rows) and the
    two resident shapes of exp_panel2. Returns the timing inputs."""
    import numpy as np
    import torch

    from semantic_gaussians_torch.tools import exp_panel2
    from semantic_gaussians_torch.tools import probe_common as pc

    rng = np.random.default_rng(0)  # exp_panel's draws, in its order
    cot = pc.make_cot(rng, pc.P_FULL, dev)
    owners_np = pc.make_owners(rng, pc.ROWS_FULL, pc.P_FULL)
    cases = {
        "V0": (cot, torch.from_numpy(owners_np).to(dev), pc.ROWS_FULL, None),
        "V4": (cot, torch.from_numpy(np.minimum(owners_np, 49_999)).to(dev), 50_000, None),
    }
    rng = np.random.default_rng(0)  # exp_panel2's
    cot2 = pc.make_cot(rng, pc.P_FULL, dev)
    for pp, rr in exp_panel2.RESIDENT_SHAPES:
        owners = torch.from_numpy(pc.make_owners(rng, rr, pp)).to(dev)
        cases[f"resident_{pp}"] = (cot2[:pp], owners, rr, None)
    return {name: dict(args=args, max_abs_err=check_segsum(name, args, exact=True))
            for name, args in cases.items()}


def check_adversarial_cases(dev):
    """Both summing kernels on the small cases of tools/summing_cases.py (the
    ones the CPU tests run through the plain versions): tile, limit, width
    and level edges for the segment sum; ragged chunk groups, fast owners
    and owners out of order for the probe."""
    import torch

    from semantic_gaussians_torch.ops import kernels
    from semantic_gaussians_torch.ops import segsum_probe as sp
    from semantic_gaussians_torch.tools import summing_cases

    n = 0
    for c in summing_cases.segsum_cases():
        limit = None if c.limit is None else torch.tensor(c.limit, dtype=torch.int32, device=dev)
        args = (torch.from_numpy(c.cot).to(dev), torch.from_numpy(c.owners).to(dev),
                c.num_rows, limit)
        check_segsum(f"case {c.name} (P={c.owners.size}, D={c.cot.shape[1]}, "
                     f"limit={c.limit})", args, exact=True)
        n += 1
    for c in summing_cases.probe_cases(kernels.multiprocessors(dev)):
        cot, owners = torch.from_numpy(c.cot).to(dev), torch.from_numpy(c.owners).to(dev)
        for mode in sp.MODES:
            check_probe(f"case {c.name} ({owners.numel() // sp.CHUNK} chunks, "
                        f"{'sorted' if c.sorted else 'unsorted'}) {mode}", cot, owners, mode)
            n += 1
    print(f"adversarial cases: {n} kernel-vs-plain checks passed")


def check_forward(name, args, work=None):
    """composite_forward on `args` against its plain version (which fills
    `work` when given): n_contrib exact; colour, depth and final_T finite
    and within rtol 1e-5 / atol 1e-6. Returns (the kernel's outputs, the
    largest |kernel - plain|)."""
    import torch

    from semantic_gaussians_torch.ops import composite

    got = composite.composite_forward(*args)
    want = composite.composite_forward_plain(*args, work=work)
    torch.cuda.synchronize()
    if not torch.equal(got[3], want[3]):
        fail(f"{name}: n_contrib differs at {int((got[3] != want[3]).sum())} px")
    err = 0.0
    for a, b, what in zip(got[:3], want[:3], ("color", "depth", "final_T")):
        if not torch.isfinite(a).all():
            fail(f"{name}: non-finite {what}")
        try:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        except AssertionError as e:
            fail(f"{name} {what} vs plain: {e}")
        if a.numel():
            err = max(err, float((a - b).abs().max()))
    return got, err


def check_composite(name, args, g_color):
    """Both composite kernels on `args` and the upstream gradient `g_color`
    against their plain versions: forward n_contrib exact, colour, depth and
    final_T at rtol 1e-5 / atol 1e-6; backward rows at rtol 1e-4 / atol 1e-5
    x column max, bit-identical over two runs. Returns the backward's
    arguments, both largest |kernel - plain| and both plain versions' work
    counts."""
    import torch

    from semantic_gaussians_torch.ops import composite

    fwd_work, bwd_work = {}, {}
    got, fwd_err = check_forward(name, args, fwd_work)
    bargs = args[:6] + (g_color, got[2], got[3]) + args[6:]
    rows, again = composite.composite_backward(*bargs), composite.composite_backward(*bargs)
    rows_plain = composite.composite_backward_plain(*bargs, work=bwd_work)
    torch.cuda.synchronize()
    in_pairs = int(args[4].sum())
    if not torch.equal(rows[:in_pairs], again[:in_pairs]):
        fail(f"{name}: two backward runs differ")
    why = in_pairs and close_enough(rows[:in_pairs], rows_plain[:in_pairs], 1e-4, 1e-5)
    if why:
        fail(f"{name} backward vs plain: {why}")
    bwd_err = float((rows[:in_pairs] - rows_plain[:in_pairs]).abs().max()) if in_pairs else 0.0
    return bargs, fwd_err, bwd_err, fwd_work, bwd_work


def check_composite_cases(dev):
    """Both composite kernels on the small cases of tools/composite_cases.py
    (the CPU tests hold the plain versions against the JAX kernel on the
    same cases), with the channel scene also at C = 768 (check_composite)."""
    import torch

    from semantic_gaussians_torch.tools.composite_cases import composite_cases

    n = 0
    for case in composite_cases(extra_channels=(FEAT_DIM,)):
        args = tuple(torch.from_numpy(x).to(dev) for x in (
            case.geom, case.colors, case.pair_gaussian, case.tile_start, case.tile_count,
            case.bg)) + (case.grid_w, case.tile_h, case.tile_w)
        check_composite(f"composite case {case.name} (C={case.num_channels})", args,
                        torch.from_numpy(case.g_color).to(dev))
        n += 1
    print(f"composite cases: both kernels agree with the plain versions on {n} cases")


def check_probe_kernels(dev):
    """Kernels 6 and 7 (the segment-sum probe, fold and window) against
    their plain version at the probe tools' full shapes (d = 16,
    p = 3,670,016, owners over 1,000,000 rows; exp_panel's data law), each
    run twice for the same bits; then the same with owners out of order
    inside every 64th chunk, which takes the kernel's other branch.

    Tolerance: rtol 1e-5, atol 1e-5 x the panel's largest |value|. A fold
    entry sums ~12,600 N(0, 1) values in float32; the plain version adds
    them with float atomics in an order that changes run to run, and
    differs from a float64 sum by ~5e-6 of the largest entry, the kernel
    (fixed order) by ~4e-7. Both errors are printed against the float64
    sum. Returns the timing inputs."""
    import numpy as np
    import torch

    from semantic_gaussians_torch.ops import segsum_probe as sp
    from semantic_gaussians_torch.tools import probe_common as pc
    from semantic_gaussians_torch.tools.summing_cases import shuffle_inside_chunks

    rng = np.random.default_rng(0)
    cot = pc.make_cot(rng, pc.P_FULL, dev)
    owners_np = pc.make_owners(rng, pc.ROWS_FULL, pc.P_FULL)
    owners = torch.from_numpy(owners_np).to(dev)
    out = {"cot": cot, "owners": owners, "modes": {}}
    for mode in sp.MODES:
        out["modes"][mode] = check_probe(mode, cot, owners, mode)
    # The kernel's other branch: owners out of order inside every 64th chunk
    # (112 of 7,168; each takes a thread per window row that scans the chunk).
    mixed = torch.from_numpy(shuffle_inside_chunks(rng, owners_np, every=64)).to(dev)
    for mode in sp.MODES:
        check_probe(f"{mode}, owners out of order in every 64th chunk", cot, mixed, mode)
    return out


def check_probe(name, cot, owners, mode):
    """The probe on (cot, owners), twice for the same bits, against its
    plain version (rtol 1e-5, atol 1e-5 x the panel's largest |value|);
    both are also printed against the plain version summed in float64."""
    import torch

    from semantic_gaussians_torch.ops import segsum_probe as sp

    got = sp.segsum_probe(cot, owners, mode)
    again = sp.segsum_probe(cot, owners, mode)
    want = sp.segsum_probe_plain(cot, owners, mode)
    exact = sp.segsum_probe_plain(cot, owners, mode, acc_dtype=torch.float64)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        fail(f"segsum_probe {name}: two runs differ")
    if got.shape != (sp.PANEL, cot.shape[1]) or not torch.isfinite(got).all():
        fail(f"segsum_probe {name}: bad shape or non-finite values")
    top = float(want.abs().max())
    try:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * top)
    except AssertionError as e:
        fail(f"segsum_probe {name} vs plain: {e}")
    err = float((got - want).abs().max())
    err64 = float((got - exact).abs().max())
    plain64 = float((want - exact).abs().max())
    rows = int((got != 0).any(dim=1).sum())
    print(f"segsum_probe {name}: within rtol 1e-5 / atol 1e-5 x max |{top:.4g}|, "
          f"bit-identical over two runs, max |kernel - plain| = {err:.3g}; against a "
          f"float64 sum: kernel {err64:.3g}, plain {plain64:.3g}; {rows} panel rows "
          f"written, sum {float(got.sum()):.6g}")
    return dict(max_abs_err=err, err_vs_f64=err64, plain_err_vs_f64=plain64)


def time_probe_kernels(probe):
    """CUDA-event times of the probe kernels, their plain version and
    index_add_ on the probe's precomputed target rows (the one PyTorch call
    that computes the same fold), with the byte bound: the stream and the
    owners read once, the panel written once; one add per element."""
    import torch

    from semantic_gaussians_torch.ops import segsum_probe as sp

    cot, owners = probe["cot"], probe["owners"]
    p, d = cot.shape
    pbytes = p * d * 4 + p * 4 + sp.PANEL * d * 4
    out = {}
    for mode, case in probe["modes"].items():
        base, off = sp.probe_scalars(owners, mode)
        col = owners - base.repeat_interleave(sp.CHUNK)
        rows = (off.repeat_interleave(sp.CHUNK) + col).long()
        if bool(((col < 0) | (col >= sp.WIN)).any()):
            fail("probe data: a column falls outside its window")

        def library():
            torch.zeros((sp.PANEL, d), device=cot.device).index_add_(0, rows, cot)

        out[mode] = dict(
            case,
            ms=cuda_ms(lambda: sp.segsum_probe(cot, owners, mode), 10),
            plain_ms=cuda_ms(lambda: sp.segsum_probe_plain(cot, owners, mode), 3),
            library_ms=cuda_ms(library, 10),
            device_us=device_us(lambda: sp.segsum_probe(cot, owners, mode)),
            library_device_us=device_us(library),
            bound=(pbytes / PEAK_BYTES, p * d / PEAK_F32),
        )
    return out


def class_cones(means):
    """20 classes for the fusion / eval scene: 5 x 4 cones seen from the
    first ring camera (at (0, 0.9, -2)), equal-count quantile bins of the
    Gaussians' projected x and y. Every class covers a large patch of that
    camera's image, the one evaluation looks at."""
    import numpy as np

    def bins(x, k):
        return np.digitize(x, np.quantile(x, np.linspace(0, 1, k + 1)[1:-1]))

    z = means[:, 2] + 2.0
    return bins(means[:, 0] / z, 5) * 4 + bins((means[:, 1] - 0.15 * TRAIN_RADIUS) / z, 4)


def fusion_depth_renders(views, dim, chunk=4):
    """Depth renders the fusion CLI launches for `views` views of `dim`
    channels at chunk_views = `chunk`: one a view without chunks; with
    them, every slot of every chunk (the last one padded) and the warm-up
    of the chunk's graph before its capture (pipelines/fusion.py)."""
    from semantic_gaussians_torch.pipelines.fusion import _CHUNK_FEAT_BYTES_BUDGET

    k = min(chunk, max(1, _CHUNK_FEAT_BYTES_BUDGET // (4 * FUSE_W * FUSE_H * dim)))
    if k <= 1 or views <= 1:
        return views
    return -(-views // k) * k + k


def fuse_through_cli(tmpdir, scene, arrays, dev, card):
    """The fusion main path: the fusion CLI, in process, on the training
    scene's 8 ring views with one precomputed 648x484x768 float16 feature
    map per view, in chunks (the YAML's chunk_views = 4, capped at 2 by the
    maps' bytes: one CUDA-graph replay a chunk), every launch count set to
    0 just before and read just after. (The CLI view by view against the
    chunked CLI, .pt bit for bit, is phase 18's, with a depth input;
    fuse_scene chunked against view by view on these views is timed and
    compared below.) The maps are rendered from a class palette, so the
    right fused feature of every Gaussian is known. Returns what the eval
    phase needs."""
    import numpy as np
    import torch

    from semantic_gaussians_torch.cli import fusion as fusion_cli
    from semantic_gaussians_torch.config.config import default_config_dir, load_config
    from semantic_gaussians_torch.core.gaussians import params_from_numpy
    from semantic_gaussians_torch.data.scannet_constants import COCOMAP_CLASS_LABELS
    from semantic_gaussians_torch.io.ply import save_gaussian_ply
    from semantic_gaussians_torch.io.scene import load_scene, realize_camera
    from semantic_gaussians_torch.models.predictors import RandomFeatureProvider, make_predictor
    from semantic_gaussians_torch.pipelines.eval_segmentation import text_feature_matrix
    from semantic_gaussians_torch.pipelines.fusion import (
        FusionConfig, _intrinsic_for, fuse_scene, fuse_view, load_fused_features, upload_map,
        view_depth,
    )
    from semantic_gaussians_torch.renderer import render_chn

    model_dir, feature_dir, out_dir = tmpdir / "target_model", tmpdir / "feats", tmpdir / "fused"
    opaque = dict(arrays, opacity_logits=arrays["opacity_logits"] + np.float32(OPACITY_BOOST))
    save_gaussian_ply(model_dir / "point_cloud" / "iteration_1" / "point_cloud.ply",
                      params_from_numpy(opaque, "cpu"))
    overrides = [
        f"scene.scene_path={scene}", f"model.model_dir={model_dir}",
        f"fusion.out_dir={out_dir}", "fusion.model_2d=precomputed",
        f"fusion.feature_dir={feature_dir}", f"fusion.embedding_dim={FEAT_DIM}",
        "fusion.depth=render", "fusion.every_k_views=1", f"fusion.img_dim=[{FUSE_W},{FUSE_H}]",
        "fusion.feat_dtype=float16", f"fusion.visibility_threshold={VISIBILITY}",
    ]
    yaml = default_config_dir() / "fusion_scannet.yaml"
    params, alive = fusion_cli.load_model(load_config(yaml, overrides), dev)
    n = len(arrays["means"])
    labels = COCOMAP_CLASS_LABELS
    text = text_feature_matrix(RandomFeatureProvider(FEAT_DIM), labels)  # row 0 = 'other'
    cls = torch.zeros(params.capacity, dtype=torch.long, device=dev)
    cls[:n] = torch.from_numpy(class_cones(arrays["means"])).to(dev)
    palette = (torch.from_numpy(text).to(dev)[cls + 1] * alive[:, None]).contiguous()

    infos = load_scene(scene, eval_split=False).train_cameras
    cams = [realize_camera(ci, with_image=False).resized(FUSE_W, FUSE_H).to(dev) for ci in infos]
    feature_dir.mkdir()
    t0 = time.perf_counter()
    with torch.no_grad():
        for ci, cam in zip(infos, cams):
            fmap = render_chn(cam, params, palette, alive=alive)["render"]
            np.save(feature_dir / f"{ci.image_name}.npy", fmap.to(torch.float16).cpu().numpy())
    del fmap
    print(f"fusion scene: {len(cams)} feature maps of {FUSE_W}x{FUSE_H}x{FEAT_DIM} float16 "
          f"rendered and written in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    summary, launches = count_launches(
        "fusion", lambda: fusion_cli.main([str(yaml), *overrides]), ("expand", "composite_fwd"))
    wall = time.perf_counter() - t0
    print(f"fusion CLI: {summary['views']} views fused in {wall:.1f} s (scene and model load "
          f"and the .pt save included); launches {launches}")
    renders = fusion_depth_renders(len(cams), FEAT_DIM)
    for name in ("expand", "composite_fwd"):  # one a depth render
        if launches[name] != renders:
            fail(f"fusion launched {name} {launches[name]} times for {renders} depth renders "
                 f"of {len(cams)} views")
    feats, visited = load_fused_features(summary["out_path"], capacity=params.capacity,
                                         device=dev)
    if int(visited.sum()) != summary["visited"] or bool(visited[~alive].any()):
        fail("the fused .pt does not reload to the mask the CLI reported")
    share = summary["visited"] / n
    if share < VISITED_FLOOR:
        fail(f"visited share {share:.3f} below the floor {VISITED_FLOOR}")
    cos = torch.nn.functional.cosine_similarity(feats[visited], palette[visited], dim=-1)
    if not torch.isfinite(feats).all() or float(cos.mean()) < 0.9:
        fail(f"fused features: mean cosine against the palette {float(cos.mean()):.4f} < 0.9")
    print(f"fused {summary['visited']} of {n} Gaussians (share {share:.3f}); mean cosine "
          f"against the palette {float(cos.mean()):.4f}, least {float(cos.min()):.4f}")

    # Where one fused view's time goes: view 0's four steps as fuse_scene
    # takes them, each ended by a synchronize; median of 3 after a warm-up.
    provider = make_predictor("precomputed", {
        "feature_dir": str(feature_dir), "embedding_dim": FEAT_DIM, "feat_dtype": "float16"})
    fcfg = FusionConfig(img_dim=(FUSE_W, FUSE_H), every_k_views=1, depth="render",
                        visibility_threshold=VISIBILITY, feat_dtype="float16")
    intrinsic = torch.from_numpy(_intrinsic_for(cams[0], fcfg.img_dim)).to(dev)
    sem = torch.zeros((params.capacity, FEAT_DIM), device=dev)
    counts = torch.zeros(params.capacity, device=dev)
    staging, runs = [], []
    for _ in range(4):
        marks = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        with torch.no_grad():
            fmap = np.asarray(provider.extract_image_feature(infos[0].image_path, fcfg.img_dim),
                              np.dtype(fcfg.feat_dtype))
            mark()
            fmap = upload_map(fmap, dev, staging)
            mark()
            depth = view_depth("render", cams[0], params, alive, intrinsic, fcfg)
            mark()
            fuse_view(sem, counts, params.means, alive, cams[0].world_view, intrinsic, fmap,
                      depth, fcfg.img_dim, fcfg.visibility_threshold, fcfg.cut_boundary)
            mark()
        runs.append([(b - a) * 1e3 for a, b in zip(marks, marks[1:])])
    del fmap, depth, sem, counts, staging
    parts = {k: statistics.median(r[i] for r in runs[1:])
             for i, k in enumerate(("map_load", "map_copy", "depth", "accumulate"))}
    # A fused view through fuse_scene over the 8 views, chunked (K = 2, a
    # capture a call) against view by view, host clock ending in a
    # synchronize; the float32 features must agree bit for bit.
    scene_ms, scene_out = {}, {}
    for name, chunk in (("chunked", 4), ("per_view", 1), ("chunked_again", 4)):
        cfg_c = dataclasses.replace(fcfg, chunk_views=chunk)
        t0 = time.perf_counter()
        scene_out[name] = fuse_scene(params, alive, cams, provider, cfg_c,
                                     image_paths=[ci.image_path for ci in infos])
        torch.cuda.synchronize()
        scene_ms[name] = (time.perf_counter() - t0) * 1e3 / len(cams)
    for name in ("per_view", "chunked_again"):
        if not all(torch.equal(a, b) for a, b in zip(scene_out["chunked"], scene_out[name])):
            fail(f"fuse_scene: chunked float32 features differ from the {name} run's")
    del scene_out
    print(f"fuse_scene a view: chunked {scene_ms['chunked']:.1f} / {scene_ms['chunked_again']:.1f}"
          f" ms, view by view {scene_ms['per_view']:.1f} ms; float32 features bit for bit")
    times = dict(fuse_view_ms=sum(parts.values()), parts_ms=parts, fuse_scene_view_ms=scene_ms,
                 cli_wall_s=wall, views=len(cams))
    print(json.dumps({"card": card, "fusion": dict(
        times, visited=summary["visited"], visited_share=share,
        cosine_mean=float(cos.mean()), launches=launches)}))
    return dict(launches=launches, state=(params, alive, cls, text, infos, cams),
                fusion_out=out_dir, model_dir=model_dir, times=times)


# ------------------------------------------------------------------ distill
DISTILL_ARCH = "MinkUNet34A"  # the reference's distill net, 56 -> 768
DISTILL_VOXEL, DISTILL_BUDGET = 0.02, 200_000  # distill_scannet.yaml's
DISTILL_EPOCHS = 24  # one scene: one step an epoch; the hook runs at 12 and 24
# Timed repetitions of the step, its parts and the UNet forward: few, as
# phase 17's bench_distill times the step at full width on a room and the
# semantic harness at a surface's density.
DISTILL_TIMED = 2
DISTILL_LOSS_DROP = 0.15  # measured 0.198 on this scene (0.995 -> 0.797, 24 steps)
UNET_CHECK_VOXELS = 4096
FLIP_NEAR_ZERO = 1e-5  # a ReLU flip's |float64 pre-activation| over its layer's max


def distill_through_cli(tmpdir, scene, fused, dev, card):
    """The distill main path: the distill CLI, in process, on the fusion
    phase's model and fused .pt, every launch count set to 0 just before
    and read just after; then the UNet against itself on the CPU and the
    step's times. Returns what the eval phase needs."""
    import numpy as np
    import torch

    from semantic_gaussians_torch.cli import distill as distill_cli
    from semantic_gaussians_torch.config.config import default_config_dir
    from semantic_gaussians_torch.io.scene import load_scene
    from semantic_gaussians_torch.pipelines.distill import load_distill_model

    out_dir = tmpdir / "distill"
    yaml = default_config_dir() / "distill_scannet.yaml"
    overrides = [
        f"model.model_dir={fused['model_dir']}", "model.load_iteration=-1",
        f"fusion.out_dir={fused['fusion_out'] / scene.name}", f"fusion.embedding_dim={FEAT_DIM}",
        f"distill.model_3d={DISTILL_ARCH}", f"distill.voxel_size={DISTILL_VOXEL}",
        f"distill.voxel_budget={DISTILL_BUDGET}", "distill.aug=true",
        f"distill.epochs={DISTILL_EPOCHS}", f"distill.save_interval={DISTILL_EPOCHS}",
        f"distill.eval_interval={DISTILL_EPOCHS // 2}", f"distill.eval_scene={scene}",
        f"distill.out_dir={out_dir}",
    ]
    t0 = time.perf_counter()
    summary, launches = count_launches(
        "distill", lambda: distill_cli.main([str(yaml), *overrides]), ("expand", "composite_fwd"))
    wall = time.perf_counter() - t0
    losses = summary["losses"]
    print(f"distill CLI: {len(losses)} steps in {wall:.1f} s (scene load, the eval scene's "
          f"voxelization, two hook renders and the checkpoint included); launches {launches}")
    print(f"distill losses: {[round(x, 5) for x in losses]}")
    if len(losses) != DISTILL_EPOCHS or not np.isfinite(losses).all():
        fail(f"distill losses: {losses}")
    drop = losses[0] - losses[-1]
    if not drop >= DISTILL_LOSS_DROP:
        fail(f"distill loss fell {drop:.5f} from the first step to the last, less than "
             f"{DISTILL_LOSS_DROP}")
    views = len(load_scene(scene, eval_split=False).train_cameras[::40][:3])  # the CLI's
    if len(summary["hook_dirs"]) != 2:
        fail(f"the eval render hook ran {len(summary['hook_dirs'])} times, not 2")
    for d in summary["hook_dirs"]:
        pngs = sorted(Path(d).glob("*.png"))
        if len(pngs) != views or any(p.stat().st_size == 0 for p in pngs):
            fail(f"the hook wrote {len(pngs)} PNGs to {d} for {views} views")
    for name in ("expand", "composite_fwd"):  # one render (C = 3) a view a hook call
        if launches[name] != views * len(summary["hook_dirs"]):
            fail(f"distill launched {name} {launches[name]} times for {views} view(s) x "
                 f"{len(summary['hook_dirs'])} hook calls")
    ckpt = summary["checkpoints"][-1]
    model = summary["model"]
    again = load_distill_model(ckpt, 56, FEAT_DIM, DISTILL_ARCH, dev)
    for (k, a), b in zip(model.state_dict().items(), again.state_dict().values()):
        if not torch.equal(a, b):
            fail(f"checkpoint {ckpt.name} reloads {k} changed")
    print(f"distill: loss {losses[0]:.5f} -> {losses[-1]:.5f} (drop {drop:.5f}); checkpoint "
          f"{ckpt.name} reloads bit for bit; hook PNGs in {[Path(d).name for d in summary['hook_dirs']]}")
    del model, again, summary
    ply = sorted((fused["model_dir"] / "point_cloud").glob("iteration_*"))[-1] / "point_cloud.ply"
    pt = sorted((fused["fusion_out"] / scene.name).glob("*.pt"))[0]
    item, unet_errs = check_unet_card_vs_cpu(ply, pt, dev)
    times = time_distill(item, fused, out_dir, dev, card)
    print(json.dumps({"card": card, "distill": dict(
        steps=len(losses), loss_first=losses[0], loss_last=losses[-1], loss_drop=drop,
        cli_wall_s=wall, launches=launches, unet_card_vs_cpu=unet_errs)}))
    return dict(launches=launches, out_dir=out_dir, epochs=DISTILL_EPOCHS, losses=losses,
                cli_wall_s=wall, times=times, unet_errs=unet_errs)


def distill_item(ply, pt, seed=0, budget=DISTILL_BUDGET):
    """The distill dataset's item of the fusion scene (aug on), as the CLI
    draws it."""
    from semantic_gaussians_torch.data.feature_dataset import FeatureDataset

    ds = FeatureDataset([str(ply)], [str(pt)], voxel_size=DISTILL_VOXEL, aug=True,
                        voxel_budget=budget)
    return ds.__getitem__(0, seed=seed)


def check_unet_card_vs_cpu(ply, pt, dev):
    """The plain-torch UNet on the card against itself on the CPU (it has
    no kernel of its own): MinkUNet34A (56 -> 768), one set of weights, on
    the first UNET_CHECK_VOXELS voxels of the scene's item (an x slab, so
    that every level has live voxels). Within 1e-4 x each leaf's largest
    magnitude: the eval-mode output in float32, and the training-mode loss
    and the gradients of the cosine loss in float64, card against CPU.

    Float32 gradients part from float64 by a few percent of a leaf's max
    where a ReLU pre-activation that float64 puts within rounding of zero
    lands on the other side in float32 (`tools/relu_flips.py`); which
    entries flip follows the order of the sums, so the card and the CPU
    flip different ones. So each side's float32 gradients are held, within
    1e-4 x each leaf's max, against float64 run through that side's own
    float32 ReLU masks, and every flip must lie within FLIP_NEAR_ZERO x its
    layer's largest |pre-activation| of zero. The plain float32 gaps (card
    vs CPU, each vs float64) and their worst leaf are printed. Returns the
    full item and the numbers."""
    import copy

    import numpy as np
    import torch

    from semantic_gaussians_torch.models.unet3d import build_topology, mink_unet
    from semantic_gaussians_torch.tools.relu_flips import relu_calls, sign_flips
    from semantic_gaussians_torch.utils.losses import cosine_distill_loss

    item = distill_item(ply, pt)
    v = UNET_CHECK_VOXELS
    coords = item.coords[:v] - item.coords[:v].min(0)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (
        coords, item.feats[:v], item.gt[:v], item.gt_mask[:v], item.mask[:v])]
    base = mink_unet(56, FEAT_DIM, DISTILL_ARCH, seed=SEED + 2)
    got = {}
    for side, device in (("cpu", "cpu"), ("card", dev)):
        c, f, g, gm, m = (a.to(device) for a in args)
        topo = build_topology(c, m)
        masks = None
        for run, dtype in (("f32", torch.float32), ("f64", torch.float64),
                           ("f64_f32_masks", torch.float64)):
            model = copy.deepcopy(base).to(device=device, dtype=dtype)
            r = dict(alive=[int(l.mask.sum()) for l in topo.levels])
            if run == "f32":
                model.eval()
                with torch.no_grad():
                    r["out"] = model(f, topo).cpu()
            model.train()
            with relu_calls(masks if run == "f64_f32_masks" else None) as pre:
                loss = cosine_distill_loss(model(f.to(dtype), topo), g.to(dtype), mask=gm)
            loss.backward()
            r.update(loss=float(loss.detach()), pre=pre,
                     grads={k: p.grad.double().cpu() for k, p in model.named_parameters()})
            if run == "f32":
                masks = [x > 0 for x in pre]
            got[(side, run)] = r
            del model
        got[(side, "flips")] = sign_flips(got[(side, "f32")]["pre"], got[(side, "f64")]["pre"])
        for run in ("f32", "f64", "f64_f32_masks"):
            del got[(side, run)]["pre"]

    def gaps(a, b):  # {leaf: largest |a - b| over b's largest}
        return {k: float((a[k] - b[k]).abs().max() / max(float(b[k].abs().max()), 1e-300))
                for k in b}

    def worst(a, b):
        return max(gaps(a, b).values())

    cpu32, card32 = got[("cpu", "f32")], got[("card", "f32")]
    cpu64, card64 = got[("cpu", "f64")], got[("card", "f64")]
    if min(cpu32["alive"]) <= 0 or cpu32["alive"] != card32["alive"]:
        fail(f"UNet check: alive voxels by level {cpu32['alive']} / {card32['alive']}")
    errs = dict(
        out_f32=float((cpu32["out"] - card32["out"]).abs().max() / cpu32["out"].abs().max()),
        loss_f64=abs(cpu64["loss"] - card64["loss"]) / abs(cpu64["loss"]),
        grads_f64=worst(card64["grads"], cpu64["grads"]),
        grads_f32_cpu_vs_f64_same_masks=worst(cpu32["grads"], got[("cpu", "f64_f32_masks")]["grads"]),
        grads_f32_card_vs_f64_same_masks=worst(card32["grads"],
                                               got[("card", "f64_f32_masks")]["grads"]),
    )
    bad = {k: x for k, x in errs.items() if not x <= 1e-4}
    flips = {side: got[(side, "flips")] for side in ("cpu", "card")}
    far = {side: [fl for fl in fs if not fl[2] <= FLIP_NEAR_ZERO] for side, fs in flips.items()}
    if bad or far["cpu"] or far["card"]:
        fail(f"UNet on the card against the CPU, relative to each leaf's max: {bad}; ReLU "
             f"flips (call, entries, |float64 pre-activation| over the call's max) farther "
             f"than {FLIP_NEAR_ZERO} from zero: {far}")
    plain = {"card_vs_cpu": gaps(card32["grads"], cpu32["grads"]),
             "cpu_vs_f64": gaps(cpu32["grads"], cpu64["grads"]),
             "card_vs_f64": gaps(card32["grads"], card64["grads"])}
    for name, g in plain.items():
        leaf = max(g, key=g.get)
        errs[f"grads_f32_{name}"] = g[leaf]
        errs[f"grads_f32_{name}_leaf"] = leaf
    for side, fs in flips.items():
        errs[f"relu_flips_{side}"] = sum(fl[1] for fl in fs)
        errs[f"relu_flip_nearest_zero_{side}"] = max((fl[2] for fl in fs), default=0.0)
        errs[f"relu_flip_calls_{side}"] = [fl[:2] for fl in fs]
    print(f"UNet {DISTILL_ARCH} card vs CPU on {v} voxels (alive by level {cpu32['alive']}): "
          + ", ".join(f"{k} {x:.3g}" if isinstance(x, float) else f"{k} {x}"
                      for k, x in errs.items()))
    return item, errs


def time_distill(item, fused, out_dir, dev, card):
    """One distill step at the full voxel count from a fresh MinkUNet34A:
    the whole step (median of DISTILL_TIMED after warm-up, host clock
    ending in a synchronize), its parts (topology, forward + loss,
    backward, AdamW, each ended by a synchronize; median of DISTILL_TIMED,
    the model warm from the whole steps), the device-busy share of a step,
    peak device memory, voxels a second; and one UNet inference as eval 3d
    runs it (voxelize, topology, checkpoint load, forward, scatter-back;
    one after warm-up) and its forward alone (median of DISTILL_TIMED)."""
    import torch

    from semantic_gaussians_torch.cli.eval_segmentation import distilled_features
    from semantic_gaussians_torch.config.config import default_config_dir, load_config
    from semantic_gaussians_torch.models.unet3d import build_topology
    from semantic_gaussians_torch.pipelines.distill import (
        DistillConfig, item_tensors, load_distill_model, make_distill_state, make_distill_step,
    )
    from semantic_gaussians_torch.utils.losses import cosine_distill_loss

    print(f"distill item: {item.num_voxels} voxels of {DISTILL_VOXEL * 100:.0f} cm from "
          f"{N_GAUSSIANS} Gaussians (budget {DISTILL_BUDGET}), "
          f"{int(item.gt_mask.sum())} supervised")
    cfg = DistillConfig(model_3d=DISTILL_ARCH, feature_dim=FEAT_DIM, epochs=1000)
    model, opt, schedule = make_distill_state(cfg, 1, SEED, device=dev)
    step = make_distill_step(model, opt, schedule, cfg)
    tensors = item_tensors(item, item.coords, dev)
    # how much of each conv's gather lands on a neighbour: the step's
    # index_add_ sums every missing slot into the one zero row
    neighbours = []
    for lvl in build_topology(tensors[0], tensors[4]).levels:
        k, v = lvl.nbr.shape
        alive, found = int(lvl.mask.sum()), int((lvl.nbr < v).sum())
        neighbours.append(dict(alive=alive, offsets=k,
                               found_besides_itself=(found - alive) / max(alive, 1),
                               missing_slot_share=1 - found / max(k * alive, 1)))
    print("distill topology by level (alive voxels, offsets, neighbours found a voxel "
          "besides itself, share of gather slots that miss): "
          + "; ".join(f"{n['alive']}, {n['offsets']}, {n['found_besides_itself']:.4f}, "
                      f"{n['missing_slot_share']:.4f}" for n in neighbours))

    def one():
        step(*tensors)
        torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    step_ms = host_ms(one, DISTILL_TIMED)
    peak = torch.cuda.max_memory_allocated()

    def in_parts():
        marks = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        c, f, g, gm, m = tensors
        topo = build_topology(c, m)
        mark()
        model.train()
        loss = cosine_distill_loss(model(f, topo), g, mask=gm)
        mark()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        mark()
        opt.step()
        mark()
        return [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]

    runs = [in_parts() for _ in range(DISTILL_TIMED)]
    parts = {k: statistics.median(r[i] for r in runs)
             for i, k in enumerate(("topology", "forward", "backward", "adamw"))}
    prof = profile(one)
    del model, opt, step, tensors
    torch.cuda.empty_cache()

    # One UNet inference as eval 3d runs it, on the CLI's checkpoint.
    params, alive = fused["state"][:2]
    ecfg = load_config(default_config_dir() / "eval.yaml", [
        f"distill.model_dir={out_dir}", f"distill.iteration={DISTILL_EPOCHS}",
        f"distill.model_3d={DISTILL_ARCH}", f"distill.voxel_size={DISTILL_VOXEL}",
        f"distill.voxel_budget={DISTILL_BUDGET}"])

    def infer():
        with torch.no_grad():
            feats = distilled_features(ecfg, params, alive, FEAT_DIM)
        torch.cuda.synchronize()
        return feats

    infer_ms = host_ms(infer, 1)
    feats = infer()
    if feats.shape != (params.capacity, FEAT_DIM) or not torch.isfinite(feats).all():
        fail(f"eval 3d features: shape {tuple(feats.shape)}, finite {bool(torch.isfinite(feats).all())}")
    net = load_distill_model(out_dir / f"model_{DISTILL_EPOCHS}.npz", 56, FEAT_DIM, DISTILL_ARCH, dev)
    c, f, _, _, m = item_tensors(item, item.coords, dev)
    topo = build_topology(c, m)

    def forward():
        with torch.no_grad():
            net(f, topo)
        torch.cuda.synchronize()

    forward_ms = host_ms(forward, DISTILL_TIMED)
    times = dict(step_ms=step_ms, parts_ms=parts, profile=prof, peak_mem_gib=peak / 2**30,
                 voxels=item.num_voxels, voxels_per_s=item.num_voxels / (step_ms / 1e3),
                 neighbours=neighbours,
                 eval3d_features_ms=infer_ms, eval3d_forward_ms=forward_ms)
    print(json.dumps({"card": card, "distill_step": times}))
    return times


def write_eval_scene(root, scene, views=EVAL_VIEWS):
    """A Blender-layout scene of `views` frames, of which the eval CLI
    evaluates every 10th (EVAL_VIEWS // 10 views). Frame i takes the pose
    of training view (i // 10) mod TRAIN_VIEWS, so the evaluated views are
    the fused ones, in turn (as the eval phase's single view was before it
    had a ring); each frame is a hard link to the training scene's first
    image (the eval CLI reads only its size). It is named as the training
    scene, whose fused .pt the CLI looks up by name. Returns its
    directory."""
    import os

    (root / "train").mkdir(parents=True)
    meta = json.loads((scene / "transforms_train.json").read_text())
    src = scene / (meta["frames"][0]["file_path"] + ".png")
    frames = []
    for i in range(views):
        os.link(src, root / "train" / f"e_{i}.png")
        pose = meta["frames"][(i // 10) % len(meta["frames"])]["transform_matrix"]
        frames.append({"file_path": f"./train/e_{i}", "transform_matrix": pose})
    (root / "transforms_train.json").write_text(
        json.dumps({"camera_angle_x": meta["camera_angle_x"], "frames": frames}))
    return root


def eval_through_cli(tmpdir, scene, fused, distilled, dev, card):
    """The eval main path: the eval CLI, in process, on the training scene
    (its first ring view evaluated) in mode 2d with pred_on_3d true and
    false, in mode labelmap on its own ground truth, then in modes 3d,
    2d_and_3d concat and 2d_and_3d argmax on the distilled checkpoint; and
    in mode 2d both ways on EVAL_VIEWS frames (write_eval_scene:
    EVAL_VIEWS // 10 evaluated, one chunk of 8 in one CUDA-graph replay and
    one view alone). The launch counts run over all eight. Those two again
    view by view (chunk_views = 1): the confusion matrices must be equal."""
    import numpy as np
    import torch
    from PIL import Image

    from semantic_gaussians_torch.cli import eval_segmentation as eval_cli
    from semantic_gaussians_torch.config.config import default_config_dir
    from semantic_gaussians_torch.data.scannet_constants import COCOMAP_CLASS_LABELS
    from semantic_gaussians_torch.io.scene import load_scene, realize_camera
    from semantic_gaussians_torch.ops import composite
    from semantic_gaussians_torch.pipelines.eval_segmentation import (
        _eval_chunk, eval_views, predict_label_image,
    )
    from semantic_gaussians_torch.pipelines.fusion import load_fused_features
    from semantic_gaussians_torch.pipelines.train import stack_camera_chunk
    from semantic_gaussians_torch.utils.graphs import GraphRunner

    params, alive, cls, text, infos, cams = fused["state"]
    k = len(COCOMAP_CLASS_LABELS)
    eye = torch.eye(k + 1, device=dev)
    onehot = eye[cls + 1] * alive[:, None]

    def write_labels(label_dir, infos, cams):
        """Ground truth of the views the CLI evaluates (every 10th)."""
        label_dir.mkdir()
        gts = {}
        for ci, cam in list(zip(infos, cams))[::10]:
            gt = predict_label_image(cam, params, alive, onehot, eye, pred_on_3d=True)
            gts[ci.image_name] = gt.cpu().numpy().astype(np.uint8)
            Image.fromarray(gts[ci.image_name]).save(label_dir / f"{ci.image_name}.png")
        return gts

    label_dir = tmpdir / "labels"
    gts = write_labels(label_dir, infos, cams)
    unlabeled = float(np.mean([(g == k).mean() for g in gts.values()]))
    print(f"eval scene: {len(gts)} ground-truth label image(s) of {FUSE_W}x{FUSE_H}, "
          f"{unlabeled:.3f} of the pixels unlabeled")
    ring = write_eval_scene(tmpdir / "eval" / scene.name, scene)
    ring_infos = load_scene(ring, eval_split=False).train_cameras
    ring_cams = [realize_camera(ci, with_image=False).resized(FUSE_W, FUSE_H).to(dev)
                 for ci in ring_infos]
    ring_gts = write_labels(tmpdir / "ring_labels", ring_infos, ring_cams)
    ring_labeled = sum(int((g < k).sum()) for g in ring_gts.values())

    def base(at, labels):
        return [
            str(default_config_dir() / "eval.yaml"), f"scene.scene_path={at}",
            f"model.model_dir={fused['model_dir']}", f"fusion.out_dir={fused['fusion_out']}",
            f"fusion.embedding_dim={FEAT_DIM}", f"eval.width={FUSE_W}", f"eval.height={FUSE_H}",
            f"eval.label_dir={labels}", f"eval.log_file={tmpdir / 'eval_result.log'}",
            f"eval.chunk_views={EVAL_CHUNK}",
        ]

    one, chunked = base(scene, label_dir), base(ring, tmpdir / "ring_labels")
    distill = [f"distill.model_dir={distilled['out_dir']}", f"distill.iteration={distilled['epochs']}",
               f"distill.model_3d={DISTILL_ARCH}", f"distill.voxel_size={DISTILL_VOXEL}",
               f"distill.voxel_budget={DISTILL_BUDGET}", "eval.pred_on_3d=true"]
    two_d = (("2d_onehot", "true"), ("2d_features", "false"))

    def run_all():
        out = {
            "2d_onehot": eval_cli.main(one + ["eval.eval_mode=2d", "eval.pred_on_3d=true"]),
            "2d_features": eval_cli.main(one + ["eval.eval_mode=2d", "eval.pred_on_3d=false"]),
            "labelmap": eval_cli.main(one + ["eval.eval_mode=labelmap"]),
            "3d": eval_cli.main(one + distill + ["eval.eval_mode=3d"]),
            "2d_and_3d_concat": eval_cli.main(one + distill + [
                "eval.eval_mode=2d_and_3d", "eval.feature_fusion=concat"]),
            "2d_and_3d_argmax": eval_cli.main(one + distill + [
                "eval.eval_mode=2d_and_3d", "eval.feature_fusion=argmax"]),
        }
        for name, p3 in two_d:
            out[f"{name}_chunked"] = eval_cli.main(
                chunked + ["eval.eval_mode=2d", f"eval.pred_on_3d={p3}"])
        return out

    results, launches = count_launches("eval", run_all, ("expand", "composite_fwd"))
    widths = composite.LAUNCHES.by_key
    print(f"eval CLI: launches {launches}; forward composite by channel width {widths}")
    # One render a view a rendering mode on the training scene: C = K + 1
    # (one-hot) in 2d_onehot and the three distilled modes, C = 768 in
    # 2d_features; labelmap renders none. On the ring, each view once and
    # the chunk's views once more in the warm-up before the capture.
    per_ring = len(ring_gts) + (EVAL_CHUNK if len(ring_gts) >= EVAL_CHUNK else 0)
    if launches["expand"] != 5 * len(gts) + 2 * per_ring:
        fail(f"eval launched expand {launches['expand']} times for 5 x {len(gts)} + 2 x "
             f"{per_ring} renders")
    for c, renders in ((k + 1, 4), (FEAT_DIM, 1)):  # two kernels a call from LIST_MIN_CHANNELS on
        per_call = 2 if c >= composite.LIST_MIN_CHANNELS else 1
        if widths.get(c, 0) != per_call * (renders * len(gts) + per_ring):
            fail(f"eval launched the forward composite at C={c} {widths.get(c, 0)} times")
    for name, p3 in two_d:
        got = results[f"{name}_chunked"][2]
        alone = eval_cli.main(chunked + ["eval.eval_mode=2d", f"eval.pred_on_3d={p3}",
                                         "eval.chunk_views=1"])
        if not np.array_equal(alone[2], got):
            fail(f"eval {name}: the chunked confusion differs from the per-view one by "
                 f"{int(np.abs(alone[2] - got).sum())} counts")
        if int(got.sum()) != ring_labeled:
            fail(f"eval {name} chunked: the confusion counts {int(got.sum())} labeled pixels")
    print(f"eval CLI on the ring ({len(ring_gts)} views, chunks of {EVAL_CHUNK}), modes 2d: "
          f"confusion matrices equal to the per-view runs'; mIoU "
          f"{results['2d_onehot_chunked'][0]:.4f} / {results['2d_features_chunked'][0]:.4f}")
    miou = {name: r[0] for name, r in results.items()}
    for name in ("2d_onehot", "2d_features"):
        if not miou[name] >= 0.9:
            fail(f"eval {name}: mIoU {miou[name]:.4f} < 0.9")
    if miou["labelmap"] != 1.0:
        fail(f"eval labelmap on its own ground truth: mIoU {miou['labelmap']}")
    for name in ("3d", "2d_and_3d_concat", "2d_and_3d_argmax"):
        if not 0.0 <= miou[name] <= 1.0:
            fail(f"eval {name}: mIoU {miou[name]}")
    print(f"eval 3d mIoU {miou['3d']:.4f}; 2d_and_3d concat {miou['2d_and_3d_concat']:.4f}, "
          f"argmax {miou['2d_and_3d_argmax']:.4f}")
    pixels = len(gts) * FUSE_W * FUSE_H
    for name, (_, _, conf) in results.items():
        if not name.endswith("_chunked") and int(conf.sum()) != round(pixels * (1 - unlabeled)):
            fail(f"eval {name}: the confusion counts {int(conf.sum())} labeled pixels")

    # One evaluated view per path (host clock ending in the confusion's copy).
    feats, _ = load_fused_features(
        sorted((fused["fusion_out"] / scene.name).glob("*.pt"))[0], capacity=params.capacity,
        device=dev)
    gt0 = [next(iter(gts.values()))]
    view_ms = {
        name: host_ms(lambda p3=p3: eval_views(cams[:1], gt0, params, alive, feats, text,
                                               COCOMAP_CLASS_LABELS, pred_on_3d=p3), 5)
        for name, p3 in (("2d_onehot", True), ("2d_features", False))
    }
    # An evaluated view over the ring's evaluated views: a whole eval_views
    # call a view, chunked (a capture a call, one replay, the tail alone) and
    # view by view; and a chunk's replay alone a view (_eval_chunk on a kept
    # runner).
    ev_cams, ev_gts = ring_cams[::10], list(ring_gts.values())
    stack = stack_camera_chunk(ev_cams[:EVAL_CHUNK])
    gt_stack = torch.from_numpy(np.stack(ev_gts[:EVAL_CHUNK]).astype(np.int32)).to(dev)
    text_t = torch.from_numpy(text).to(dev)
    for name, p3 in (("2d_onehot", True), ("2d_features", False)):
        runner = GraphRunner(dev)
        conf0 = torch.zeros((k, k + 1), dtype=torch.int64, device=dev)

        def replay(p3=p3, runner=runner, conf0=conf0):
            _eval_chunk(runner, stack, gt_stack, conf0, params, alive, feats, text_t, k, p3,
                        "tiled")
            torch.cuda.synchronize()

        view_ms[name] = dict(one_view=view_ms[name], **{
            f"call_{mode}": host_ms(lambda p3=p3, c=c: eval_views(
                ev_cams, ev_gts, params, alive, feats, text, COCOMAP_CLASS_LABELS,
                pred_on_3d=p3, chunk_views=c), 3) / len(ev_gts)
            for mode, c in (("chunked", EVAL_CHUNK), ("per_view", 1))},
            replay=host_ms(replay, 5) / EVAL_CHUNK)
        del runner
    print(json.dumps({"card": card, "eval": dict(
        miou=miou, macc={n: r[1] for n, r in results.items()}, eval_view_ms=view_ms,
        launches=launches, composite_fwd_by_channels={str(c): v for c, v in widths.items()})}))
    return dict(launches=launches, miou=miou, view_ms=view_ms, label_dir=label_dir, gts=gts,
                labeled_pixels=round(pixels * (1 - unlabeled)))


# ------------------------------------------------------------------ 2D models
# The towers at their published widths, random weights from SEED: SAM ViT-H
# at 1024^2, CLIP ViT-L/14@336 (image and text towers), LSeg ViT-L/16 with
# its DPT decoder and the bundled CLIP ViT-B/32 text tower.
SAM_2D = dict()  # SamConfig.vit_h()
CLIP_TEXT_2D = dict(width=768, layers=12, heads=12, embed_dim=768)
CLIP_VISION_2D = dict(image_size=336, patch=14, width=1024, layers=24, heads=16, embed_dim=768)
LSEG_2D = dict()  # LSegConfig()
LSEG_TEXT_2D = dict(width=512, layers=12, heads=8, embed_dim=512)
# Card against CPU: the same widths at a cut depth (SAM one windowed and one
# global block, CLIP two blocks, LSeg four with all four taps).
CUT_SAM = dict(depth=2, global_blocks=(1,))
CUT_CLIP_LAYERS = 2
CUT_LSEG = dict(layers=4, taps=(0, 1, 2, 3))
# max |card - CPU| / max |CPU| of a tower's outputs: in float32 (cuDNN's TF32
# convolutions off for the check) and with torch's defaults (TF32 convs)
GAP_FP32, GAP_DEFAULT = 1e-4, 2e-2
VIEWS_2D = 2  # the 2D-model fusion runs fuse 2 of the 8 ring views (every_k_views=4)
CROPS_FLOOR = 64  # CLIP crops a view in the timed SAMCLIP run
TIMED_TOP_IOU = 128  # its IoU threshold: the view's 128th-best candidate IoU


def gap(card, cpu):
    """max |card - cpu| over max |cpu|."""
    cpu = cpu.float()
    return float((card.float().cpu() - cpu).abs().max() / cpu.abs().max().clamp(min=1e-30))


def card_gaps(name, model, args_fn, dev):
    """One tower (on the CPU) and its copy on the card on the same inputs
    (args_fn(device) -> forward arguments): the largest gap of its outputs
    in float32 and with the defaults; fails past the gates."""
    import copy

    import torch

    as_tuple = lambda o: o if isinstance(o, tuple) else (o,)  # noqa: E731
    cudnn = torch.backends.cudnn
    with torch.inference_mode():
        want = as_tuple(model(*args_fn("cpu")))
        card = copy.deepcopy(model).to(dev)
        args = args_fn(dev)
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            fp32 = as_tuple(card(*args))
        default = as_tuple(card(*args))
    out = dict(fp32=max(gap(a, b) for a, b in zip(fp32, want)),
               default=max(gap(a, b) for a, b in zip(default, want)))
    print(f"card vs CPU, {name}: float32 {out['fp32']:.3g}, defaults {out['default']:.3g} "
          f"of the CPU's largest magnitude")
    if not (out["fp32"] <= GAP_FP32 and out["default"] <= GAP_DEFAULT):
        fail(f"{name}: card vs CPU {out} (gates {GAP_FP32} float32, {GAP_DEFAULT} defaults)")
    return out


def ring_image(scene, i=0):
    """Ring view i resized to the fusion configs' 648x484 (PIL bilinear)."""
    import numpy as np
    from PIL import Image

    img = Image.open(str(scene / "train" / f"r_{i}.png")).convert("RGB")
    return np.asarray(img.resize((FUSE_W, FUSE_H), Image.BILINEAR))


class _PointDecoder:
    """Sam.predict_points as a module call (for card_gaps)."""

    def __init__(self, model):
        self.model = model

    def __call__(self, emb, pts, labels):
        return self.model.predict_points(emb, pts, labels)

    def to(self, dev):
        return _PointDecoder(self.model.to(dev))

    def __deepcopy__(self, memo):
        import copy

        return _PointDecoder(copy.deepcopy(self.model, memo))


def check_towers_card_vs_cpu(scene, bpe, dev):
    """Phase 14a: each tower at its full width and a cut depth on the card
    and on the CPU with the same weights and inputs; the AMG's logits card
    against CPU, and its discrete stage run twice on the card's logits."""
    import torch

    from semantic_gaussians_torch.data.scannet_constants import SCANNET20_CLASS_LABELS
    from semantic_gaussians_torch.models import automask, clip_text, clip_vision, lseg, sam
    from semantic_gaussians_torch.models.common import random_init_
    from semantic_gaussians_torch.tools.random_checkpoints import sam_model

    img = ring_image(scene)
    gaps = {}
    cfg = sam.SamConfig(**dict(SAM_2D, **CUT_SAM))
    cut_sam = sam_model(cfg, seed=SEED)
    gaps["sam_encoder"] = card_gaps(
        "SAM ViT-H encoder (1 windowed + 1 global block, 1024^2)", cut_sam.image_encoder,
        lambda d: (sam.preprocess_image(img, cfg.img_size, d)[0][None],), dev)
    gen = automask.SamAutoMask(cut_sam)
    emb, rhw = gen.embed(img)
    pts = gen.prompts((FUSE_H, FUSE_W))[:64, None]
    labels = torch.ones((64, 1), dtype=torch.int32)
    gaps["sam_decoder"] = card_gaps(
        "SAM decoder (64 point prompts: logits, IoU)", _PointDecoder(cut_sam),
        lambda d: (emb.to(d), pts.to(d), labels.to(d)), dev)
    gaps["amg_logits"] = _resampled_gap(cut_sam, emb, pts, labels, rhw, dev)
    gaps["amg_discrete"] = _amg_discrete_twice(cut_sam, img, dev)
    del cut_sam, gen

    vis = random_init_(clip_vision.CLIPVisionTower(**dict(CLIP_VISION_2D, layers=CUT_CLIP_LAYERS)),
                       seed=SEED)
    crops = torch.rand((8, vis.image_size, vis.image_size, 3),
                       generator=torch.Generator().manual_seed(SEED))
    gaps["clip_vision"] = card_gaps("CLIP ViT-L/14@336 image tower (2 blocks, 8 crops)", vis,
                                    lambda d: (crops.to(d),), dev)
    ids = torch.from_numpy(clip_text.tokenize(list(SCANNET20_CLASS_LABELS), str(bpe)))
    for key, kw, name in (("clip_text_l14", CLIP_TEXT_2D, "CLIP ViT-L/14 text tower"),
                          ("clip_text_b32", LSEG_TEXT_2D, "CLIP ViT-B/32 text tower")):
        tower = random_init_(clip_text.CLIPTextTower(**dict(kw, layers=CUT_CLIP_LAYERS)),
                             seed=SEED)
        gaps[key] = card_gaps(f"{name} (2 blocks, 20 labels)", tower, lambda d: (ids.to(d),),
                              dev)
    net = random_init_(lseg.LSegNet(lseg.LSegConfig(**dict(LSEG_2D, **CUT_LSEG))),
                       seed=SEED).eval()
    x = (torch.tensor(lseg._resize_image_np(img, 384, 544)).float() / 255.0 - 0.5) / 0.5
    gaps["lseg"] = card_gaps("LSeg ViT-L/16 + DPT (4 blocks, 4 taps, 384x544)", net,
                             lambda d: (x[None].to(d),), dev)
    return gaps


def _resampled_gap(model, emb, pts, labels, rhw, dev):
    """The decoder's logits resampled to 648x484, card against CPU in
    float32 (gated) and with the defaults, and the pixels whose sign
    differs in each (not gated: the discrete stage is held on shared
    logits)."""
    import copy

    import torch

    from semantic_gaussians_torch.models.automask import resample_logits

    def logits(m, d):
        lg = m.predict_points(emb.to(d), pts.to(d), labels.to(d))[0][:, 1:]
        return resample_logits(lg, (FUSE_H, FUSE_W), rhw)

    cudnn = torch.backends.cudnn
    with torch.inference_mode():
        up = logits(model, "cpu")
        card = copy.deepcopy(model).to(dev)
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            fp32 = logits(card, dev).cpu()
        default = logits(card, dev).cpu()
    out = dict(fp32=gap(fp32, up), default=gap(default, up),
               sign_flips_fp32=int(((fp32 > 0) != (up > 0)).sum()),
               sign_flips_default=int(((default > 0) != (up > 0)).sum()), pixels=up.numel())
    print(f"card vs CPU, AMG logits at {FUSE_W}x{FUSE_H} (64 points): {out}")
    if not (out["fp32"] <= GAP_FP32 and out["default"] <= GAP_DEFAULT):
        fail(f"AMG logits card vs CPU {out}")
    return out


def _amg_discrete_twice(model, img, dev):
    """The 32x32 grid through the cut SAM on the card; each batch's filters
    run on the card's logits on the card and again on the CPU, then both
    candidate sets through NMS and region removal (the same host code on the
    same arrays): the annotations must be identical. As in the timed view,
    the IoU filter keeps the TIMED_TOP_IOU best candidates, stability keeps
    all and NMS at 1.0 suppresses none, so that region removal and the
    second NMS see every kept mask."""
    import copy

    import numpy as np
    import torch

    from semantic_gaussians_torch.models import automask

    gen = automask.SamAutoMask(copy.deepcopy(model).to(dev))
    keys = ("masks", "iou", "stab", "boxes")
    sides = {s: [{k: [] for k in keys} for _ in range(3)] for s in ("card", "cpu")}
    with torch.inference_mode():
        emb, rhw = gen.embed(img)
        pts = gen.prompts((FUSE_H, FUSE_W))
        bsz = gen.amg.points_per_batch

        def batches():
            for i0 in range(0, len(pts), bsz):
                yield gen.decode_batch(emb, pts[i0: i0 + bsz], (FUSE_H, FUSE_W), rhw)

        ious = torch.cat([iou.flatten() for _, iou in batches()]).sort().values
        gen.amg = automask.AutoMaskConfig(pred_iou_thresh=float(ious[-TIMED_TOP_IOU - 1]),
                                          stability_score_thresh=-1.0, box_nms_thresh=1.0)
        for lg, iou in batches():
            for side, args in (("card", (lg, iou)), ("cpu", (lg.cpu(), iou.cpu()))):
                for sc, arrays in enumerate(gen.select(*args, len(lg))):
                    for k, a in zip(keys, arrays):
                        sides[side][sc][k].append(a)
    for sc in range(3):
        for k in keys:
            if not all(np.array_equal(a, b) for a, b in zip(sides["card"][sc][k],
                                                            sides["cpu"][sc][k])):
                fail(f"AMG filters: {k} of scale {sc} differ between the card and the CPU")
    anns = {side: gen.annotations(per_scale) for side, per_scale in sides.items()}
    for a_set, b_set in zip(anns["card"], anns["cpu"]):
        same = len(a_set) == len(b_set) and all(
            np.array_equal(a["segmentation"], b["segmentation"])
            and all(a[k] == b[k] for k in ("bbox", "area", "predicted_iou", "stability_score"))
            for a, b in zip(a_set, b_set))
        if not same:
            fail("AMG annotations differ between the card's and the CPU's discrete stage")
    out = dict(candidates_by_scale=[sum(len(m) for m in sc["masks"]) for sc in sides["card"]],
               annotations_merged_s_m_l=[len(a) for a in anns["card"]])
    print(f"AMG discrete stage on the card's logits, run on the card and on the CPU: "
          f"identical {out}")
    return out


def write_2d_checkpoints(root):
    """Phase 14b: every tower at its published width with random weights
    from SEED, saved in its public layout where the CLIs read it, and a BPE
    merges file of the label words. Returns the paths and the CPU models."""
    from semantic_gaussians_torch.data.scannet_constants import (
        COCOMAP_CLASS_LABELS, SCANNET20_CLASS_LABELS,
    )
    from semantic_gaussians_torch.models.lseg import LSegConfig
    from semantic_gaussians_torch.models.sam import SamConfig
    from semantic_gaussians_torch.tools import random_checkpoints as rc

    t0 = time.perf_counter()
    paths = dict(sam=root / "sam_vit_h.pth", clip=root / "clip_vit_l14_336.pt",
                 lseg=root / "lseg_demo.ckpt", bpe=root / "bpe_random.txt.gz")
    models = dict(sam=rc.write_sam(paths["sam"], SamConfig(**SAM_2D), seed=SEED))
    models["clip_text"], models["clip_vision"] = rc.write_clip(
        paths["clip"], dict(CLIP_TEXT_2D), dict(CLIP_VISION_2D), seed=SEED)
    models["lseg"], models["lseg_text"] = rc.write_lseg(
        paths["lseg"], LSegConfig(**LSEG_2D), dict(LSEG_TEXT_2D), seed=SEED)
    words = {w for lab in SCANNET20_CLASS_LABELS + COCOMAP_CLASS_LABELS for w in lab.split()}
    rc.write_bpe(paths["bpe"], sorted(words | {"a", "other", "background"}))
    sizes = {k: round(p.stat().st_size / 2**30, 3) for k, p in paths.items()}
    print(f"2D checkpoints written in {time.perf_counter() - t0:.1f} s (GiB): {sizes}")
    return paths, models


def fuse_2d_through_cli(name, tmpdir, scene, fused, overrides, dev):
    """One 2D-model fusion main path: the fusion CLI on VIEWS_2D ring views
    with depth=render, its launch counts set to 0 just before and read just
    after. Checks the fused .pt and returns its numbers."""
    import torch

    from semantic_gaussians_torch.cli import fusion as fusion_cli
    from semantic_gaussians_torch.config.config import default_config_dir
    from semantic_gaussians_torch.pipelines.fusion import load_fused_features

    out = tmpdir / f"fused_{name}"
    args = [str(default_config_dir() / "fusion_scannet.yaml"), f"scene.scene_path={scene}",
            f"model.model_dir={fused['model_dir']}", f"fusion.out_dir={out}",
            "fusion.depth=render", f"fusion.every_k_views={TRAIN_VIEWS // VIEWS_2D}",
            f"fusion.img_dim=[{FUSE_W},{FUSE_H}]", f"fusion.visibility_threshold={VISIBILITY}",
            f"fusion.device={dev.type}", *overrides]
    t0 = time.perf_counter()
    summary, launches = count_launches(f"fusion {name}", lambda: fusion_cli.main(args),
                                       ("expand", "composite_fwd"))
    wall = time.perf_counter() - t0
    feats, visited = load_fused_features(summary["out_path"], device=dev)
    renders = fusion_depth_renders(VIEWS_2D, feats.shape[1])
    for k in ("expand", "composite_fwd"):  # one a depth render
        if launches[k] != renders:
            fail(f"fusion {name} launched {k} {launches[k]} times for {renders} depth renders "
                 f"of {VIEWS_2D} views")
    norms = feats[visited].norm(dim=-1)
    if int(visited.sum()) != summary["visited"] or summary["views"] != VIEWS_2D:
        fail(f"fusion {name}: the .pt does not reload to the CLI's summary {summary}")
    if not torch.isfinite(feats).all() or bool((norms > 1 + 1e-3).any()):
        fail(f"fusion {name}: fused features non-finite or longer than a unit vector")
    res = dict(cli_wall_s=wall, s_per_view=wall / VIEWS_2D, visited=summary["visited"],
               covered=int((norms > 1e-6).sum()), mean_norm_covered=float(
                   norms[norms > 1e-6].mean()) if bool((norms > 1e-6).any()) else 0.0,
               dim=feats.shape[1], launches=launches)
    print(f"fusion CLI, model_2d={name}: {json.dumps(res)}")
    return res, launches


def native_detections(scene, towers_cfg, dev):
    """make_predictor's native VLPart detector on the fusion CLI's views:
    the AMG proposals its checkpoint's CLIP image tower classifies, those
    not classed as background, and those that pass VLPart's box
    threshold. Fails unless every view has a proposal."""
    from semantic_gaussians_torch.models.predictors import load_image, make_predictor

    pred = make_predictor("vlpart", towers_cfg, dev)
    out = {}
    for i in range(0, TRAIN_VIEWS, TRAIN_VIEWS // VIEWS_2D):
        _, scores, _ = pred.detector(load_image(str(scene / "train" / f"r_{i}.png")))
        out[f"r_{i}"] = dict(proposals=pred.detector.automask.counts["merged"]["annotations"],
                             not_background=len(scores),
                             max_score=float(scores.max()) if len(scores) else None,
                             passing=int((scores >= pred.box_threshold).sum()))
        if out[f"r_{i}"]["proposals"] == 0:
            fail(f"native VLPart detector: no AMG proposal on view r_{i}")
    print(f"native VLPart detector (box threshold {pred.box_threshold}): {json.dumps(out)}")
    return out


def paths_2d(tmpdir, scene, fused, evaluated, ckpt, dev):
    """Phase 14c: the 2D-model main paths through their CLIs: SAMCLIP,
    LSeg and VLPart (precomputed and native detections) fusion, each at the
    fusion YAML's AMG thresholds, and the eval CLI in mode pretrained with
    eval.model_2d=lseg."""
    import numpy as np

    from semantic_gaussians_torch.cli import eval_segmentation as eval_cli
    from semantic_gaussians_torch.config.config import default_config_dir
    from semantic_gaussians_torch.data.scannet_constants import COCOMAP_CLASS_LABELS
    from semantic_gaussians_torch.models.vlpart import save_detections

    towers_cfg = dict(sam_checkpoint=str(ckpt["sam"]), clip_checkpoint=str(ckpt["clip"]),
                      bpe_path=str(ckpt["bpe"]), vocabulary=list(COCOMAP_CLASS_LABELS))
    towers = [f"fusion.{k}={v}" for k, v in towers_cfg.items() if k != "vocabulary"]
    towers.append("fusion.vocabulary=[" + ",".join(COCOMAP_CLASS_LABELS) + "]")
    det_dir = tmpdir / "detections"
    rng = np.random.default_rng(SEED)
    for i in range(TRAIN_VIEWS):  # six boxes a view on a 3 x 2 grid, in the image's frame
        x0, y0 = np.meshgrid(np.arange(3) * WIDTH / 3, np.arange(2) * HEIGHT / 2)
        boxes = np.stack([x0.ravel() + 8, y0.ravel() + 8, x0.ravel() + WIDTH / 3 - 8,
                          y0.ravel() + HEIGHT / 2 - 8], -1)
        save_detections(det_dir / f"r_{i}.npz", boxes, rng.uniform(0.35, 0.95, 6),
                        rng.integers(0, len(COCOMAP_CLASS_LABELS), 6))
    runs = {
        "samclip": ["fusion.model_2d=samclip", *towers],
        "lseg": ["fusion.model_2d=lseg", f"fusion.lseg_checkpoint={ckpt['lseg']}",
                 f"fusion.bpe_path={ckpt['bpe']}"],
        "vlpart": ["fusion.model_2d=vlpart", f"fusion.detections_dir={det_dir}", *towers],
        "vlpart_native": ["fusion.model_2d=vlpart", *towers],
    }
    out, launches = {}, {}
    for name, overrides in runs.items():
        out[name], launches[f"fusion_{name}"] = fuse_2d_through_cli(
            name, tmpdir, scene, fused, overrides, dev)
    clip_dim, lseg_dim = CLIP_TEXT_2D["embed_dim"], LSEG_TEXT_2D["embed_dim"]
    for name, dim in (("samclip", clip_dim), ("lseg", lseg_dim), ("vlpart", clip_dim)):
        if out[name]["dim"] != dim:
            fail(f"fusion {name}: {out[name]['dim']}-d features, expected {dim}")
    if out["lseg"]["covered"] != out["lseg"]["visited"]:
        fail(f"fusion lseg: LSeg covers every pixel, got {out['lseg']}")
    for name in ("samclip", "vlpart"):  # masks pass the YAML's filters / boxes given
        if out[name]["covered"] == 0:
            fail(f"fusion {name}: no point covered by a mask {out[name]}")
    out["vlpart_native"]["detector"] = native_detections(scene, towers_cfg, dev)

    args = [str(default_config_dir() / "eval.yaml"), f"scene.scene_path={scene}",
            f"model.model_dir={fused['model_dir']}", "eval.eval_mode=pretrained",
            "eval.model_2d=lseg", f"eval.lseg_checkpoint={ckpt['lseg']}",
            f"eval.bpe_path={ckpt['bpe']}", f"eval.label_dir={evaluated['label_dir']}",
            f"eval.width={FUSE_W}", f"eval.height={FUSE_H}", f"fusion.embedding_dim={lseg_dim}",
            f"eval.log_file={tmpdir / 'eval_2d.log'}", f"eval.device={dev.type}"]
    t0 = time.perf_counter()
    (miou, macc, conf), launches["eval_pretrained"] = count_launches(
        "eval pretrained", lambda: eval_cli.main(args), ())
    wall = time.perf_counter() - t0
    views = len(evaluated["gts"])
    if not (0.0 <= miou <= 1.0) or int(conf.sum()) != evaluated["labeled_pixels"]:
        fail(f"eval pretrained lseg: mIoU {miou}, {int(conf.sum())} pixels counted")
    out["eval_pretrained_lseg"] = dict(miou=miou, macc=macc, cli_wall_s=wall,
                                       s_per_view=wall / views, views=views)
    print(f"eval CLI, pretrained, model_2d=lseg: {json.dumps(out['eval_pretrained_lseg'])}")
    return out, launches


def peak_gib(fn):
    """fn() and the peak device memory it allocated above what was
    allocated before it (the earlier phases' tensors and the weights stay
    out), GiB."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 2**30


def weights_gib(module):
    return sum(t.numel() * t.element_size() for t in module.state_dict().values()) / 2**30


def time_2d(scene, ckpt, models, dev, card):
    """Phase 14d: the towers' times on the card after warm-up (CUDA events
    for device calls, the host clock for calls that end on the host), the
    device-busy share of a SAMCLIP and an LSeg view, and peak memory."""
    import numpy as np
    import torch

    from semantic_gaussians_torch.data.scannet_constants import SCANNET20_CLASS_LABELS
    from semantic_gaussians_torch.models import automask, clip_text, clip_vision, lseg, sam
    from semantic_gaussians_torch.models.samclip import (
        SAMCLIPPredictor, pad_square_crop, sum_crop_features,
    )

    img = ring_image(scene)
    path = str(scene / "train" / "r_0.png")
    t = {"card": card, "precision": dict(
        matmul_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_tf32=torch.backends.cudnn.allow_tf32, dtype="float32")}
    sam_model = models.pop("sam").to(dev)
    t["weights_gib"] = {k: weights_gib(m) for k, m in models.items()}
    t["weights_gib"]["sam"] = weights_gib(sam_model)
    x, rhw = sam.preprocess_image(img, sam_model.cfg.img_size, dev)
    with torch.inference_mode():
        t["sam_encoder_ms"] = cuda_ms(lambda: sam_model.encode_image(x[None]), 5)
        _, t["sam_encoder_call_peak_gib"] = peak_gib(lambda: sam_model.encode_image(x[None]))
        t["sam_encoder_profile"] = profile(lambda: sam_model.encode_image(x[None]))

    # The timed SAMCLIP view: IoU threshold at the view's TIMED_TOP_IOU-th
    # best candidate, stability and NMS keeping all (the random SAM's masks
    # follow its image embedding more than the point prompts, so at the
    # YAML's NMS threshold a set keeps one or a few).
    probe = automask.SamAutoMask(sam_model, automask.AutoMaskConfig(
        pred_iou_thresh=-1e9, stability_score_thresh=-1.0))
    ious = np.sort(np.concatenate([np.concatenate(sc["iou"]) for sc in probe.candidates(img)]))
    amg = automask.AutoMaskConfig(pred_iou_thresh=float(ious[-TIMED_TOP_IOU - 1]),
                                  stability_score_thresh=-1.0, box_nms_thresh=1.0)
    clip_enc = clip_vision.CLIPImageEncoder(models["clip_vision"], device=dev)
    pred = SAMCLIPPredictor(sam_model=sam_model, clip_encoder=clip_enc, amg=amg, device=dev)
    gen = pred.mask_generator
    t["timed_amg"] = dataclasses.asdict(amg)

    # The SAMCLIP fusion CLI's views at its (the YAML's default) AMG
    # thresholds: the masks each stage keeps.
    yaml_gen = automask.SamAutoMask(sam_model)
    t["amg_yaml_counts"] = {}
    for i in range(0, TRAIN_VIEWS, TRAIN_VIEWS // VIEWS_2D):
        view = pred.prepare_image(str(scene / "train" / f"r_{i}.png"), (FUSE_W, FUSE_H))
        yaml_gen.generate((view * 255).astype(np.uint8))
        t["amg_yaml_counts"][f"r_{i}"] = yaml_gen.counts
        print(f"AMG at the YAML's thresholds, view r_{i}: {json.dumps(yaml_gen.counts)}")

    def amg_parts():
        marks = [time.perf_counter()]
        per_scale = gen.candidates(img)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        anns = gen.annotations(per_scale)
        marks.append(time.perf_counter())
        return [(b - a) * 1e3 for a, b in zip(marks, marks[1:])], anns

    amg_parts()
    runs = [amg_parts() for _ in range(2)]
    anns = sorted(runs[-1][1][0], key=lambda a: a["area"], reverse=True)
    t["amg_timed_counts"] = gen.counts
    print(f"AMG at the timed thresholds, view r_0: {json.dumps(gen.counts)}")
    t["amg_view_ms"] = dict(
        device_batches_ms=statistics.median(r[0][0] for r in runs),
        host_nms_regions_ms=statistics.median(r[0][1] for r in runs),
        masks_kept_merged_s_m_l=[len(a) for a in runs[-1][1]])
    if len(anns) < CROPS_FLOOR:
        fail(f"timed SAMCLIP view: {len(anns)} crops, fewer than {CROPS_FLOOR}")
    img01 = img.astype(np.float32) / 255.0
    with torch.inference_mode():
        crops = torch.stack([pad_square_crop(img01, a["segmentation"], a["bbox"],
                                             clip_enc.tower.image_size, dev) for a in anns[:64]])
        clip_ms = cuda_ms(lambda: clip_enc.encode(crops), 5)
        _, t["clip_vision_call_peak_gib"] = peak_gib(lambda: clip_enc.encode(crops))
        t["clip_crops_per_s"] = 64 / clip_ms * 1e3
        t["clip_batch64_ms"] = clip_ms
        embs = pred.crop_embeddings(img01, anns)
        masks = torch.from_numpy(np.stack([a["segmentation"] for a in anns])).to(dev)
        t["per_pixel_sum_ms"] = cuda_ms(lambda: sum_crop_features(masks, embs), 10)
        t["per_pixel_sum_masks"] = len(anns)

    def samclip_view():
        f = pred.extract_image_feature(path, (FUSE_W, FUSE_H))
        torch.cuda.synchronize()
        return f

    feat = samclip_view()
    norms = np.linalg.norm(feat, axis=-1)
    if feat.shape != (FUSE_H, FUSE_W, clip_enc.embedding_dim) or not np.isfinite(feat).all() or not (
            np.abs(norms[norms > 1e-6] - 1) < 1e-3).all() or not (norms > 1e-6).any():
        fail(f"SAMCLIP view: shape {feat.shape}, not unit-norm where covered")
    t["samclip_view_s"] = host_ms(samclip_view, 1) / 1e3
    t["samclip_view_crops"] = len(anns)
    t["samclip_view_covered_share"] = float((norms > 1e-6).mean())
    t["samclip_view_profile"] = profile(samclip_view)
    del pred, gen, probe, clip_enc, masks, embs, crops, feat, x, sam_model
    torch.cuda.empty_cache()

    text_l14 = clip_text.CLIPTextEncoder(tower=models["clip_text"], bpe_path=str(ckpt["bpe"]),
                                         device=dev)
    text_b32 = clip_text.CLIPTextEncoder(tower=models["lseg_text"], bpe_path=str(ckpt["bpe"]),
                                         device=dev)
    labels = list(SCANNET20_CLASS_LABELS)
    for key, enc in (("clip_text_l14", text_l14), ("clip_text_b32", text_b32)):
        feats = enc.extract_text_feature(labels)
        if feats.shape != (len(labels), enc.embedding_dim) or not np.allclose(
                np.linalg.norm(feats, axis=-1), 1.0, atol=1e-4):
            fail(f"{key}: text features {feats.shape} not unit rows")
        t[f"{key}_ms"] = host_ms(lambda enc=enc: enc.extract_text_feature(labels), 5)
        _, t[f"{key}_call_peak_gib"] = peak_gib(lambda enc=enc: enc.extract_text_feature(labels))

    lp = lseg.LSegPredictor(net=models.pop("lseg").to(dev), text_encoder=text_b32, device=dev)
    for mode, sliding in (("single", False), ("sliding", True)):
        def view(sliding=sliding):
            f = lp.extract_image_feature(path, (FUSE_W, FUSE_H), sliding=sliding)
            torch.cuda.synchronize()
            return f

        f = view()
        if f.shape != (FUSE_H, FUSE_W, lp.embedding_dim) or not np.allclose(
                np.linalg.norm(f, axis=-1), 1.0, atol=1e-3):
            fail(f"LSeg {mode}: {f.shape}, not unit-norm")
        t[f"lseg_{mode}_ms"] = host_ms(view, 5)
        _, t[f"lseg_{mode}_call_peak_gib"] = peak_gib(view)
    t["lseg_single_profile"] = profile(lambda: lp.extract_image_feature(path, (FUSE_W, FUSE_H)))
    del lp, text_l14, text_b32
    torch.cuda.empty_cache()
    print(json.dumps({"card": card, "models_2d_times": t}, default=str))
    return t


def models_2d_phase(tmpdir, scene, fused, evaluated, dev, card):
    """Phase 14: the 2D models (see the module docstring)."""
    t0 = time.perf_counter()
    ckpt, models = write_2d_checkpoints(tmpdir / "ckpt_2d")
    gaps = check_towers_card_vs_cpu(scene, ckpt["bpe"], dev)
    paths, launches = paths_2d(tmpdir, scene, fused, evaluated, ckpt, dev)
    times = time_2d(scene, ckpt, models, dev, card)
    for name, r in paths.items():
        if name.startswith(("samclip", "lseg", "vlpart")):
            times[f"fusion_{name}_s_per_view"] = r["s_per_view"]
    times["eval_pretrained_lseg_s_per_view"] = paths["eval_pretrained_lseg"]["s_per_view"]
    wall = time.perf_counter() - t0
    print(json.dumps({"card": card, "models_2d": dict(
        phase_s=wall, card_vs_cpu=gaps, paths=paths)}, default=str))
    return dict(launches=launches, gaps=gaps, paths=paths, times=times, phase_s=wall)


def run_probe_tools():
    """The tools main path: both probe tools' `main` at full size, the
    launch counts run over both. Their tables are printed as they run."""
    from semantic_gaussians_torch.tools import exp_panel, exp_panel2

    def run_both():
        return {"exp_panel": exp_panel.main([]), "exp_panel2": exp_panel2.main([])}

    tables, launches = count_launches(
        "tools", run_both, ("segsum", "segsum_probe_fold", "segsum_probe_window"))
    for tool, lines in tables.items():
        bad = [l["label"] for l in lines if "ms" in l and not l["ms"] > 0]
        if bad or not lines:
            fail(f"{tool}: no time for {bad}")
    sums = {l["label"]: l["value"] for l in tables["exp_panel2"] if "value" in l}
    if abs(sums["A sum"] - sums["B sum"]) > 1e-4 * max(1.0, abs(sums["A sum"])) + 0.5:
        fail(f"exp_panel2: fold and window fold the same terms but sum to {sums}")
    print(f"probe tools: launches {launches}")
    print(json.dumps({"tools": tables}))
    return dict(launches=launches, tables=tables)



# ------------------------------------------------------------------ distributed (15)
DIST_TIMEOUT_S = 420  # a rank's process-group timeout and the wait for a child
DIST_LOOP_ITERS = 30  # the hybrid loop on two ranks: one densify, at 20
DIST_CLI_ITERS = 30
# Two MinkUNet34A steps side by side on one card: the 200,000 budget of
# phase 9b peaks at 50.5 GiB in one process, so each rank takes a quarter.
DIST_DISTILL_BUDGET = 50_000
DIST_REPS = 10
SCHEDULES = ("dp", "band", "band_zero", "hybrid", "hybrid_zero")


def counted(acc, fn):
    """Run one distributed call with every launch count set to 0 just
    before and read just after, adding the counts to `acc`."""
    import torch

    counters = all_counters()
    for c in counters:
        c.reset()
    out = fn()
    torch.cuda.synchronize()
    for c in counters:
        acc[c.name] = acc.get(c.name, 0) + c.count
    return out


def schedule_step(kind, world, cfg, h, w):
    """(mesh, step, the axis its ZeRO moments shard over or None) of one
    schedule over `world` ranks: view-DP, band and band-ZeRO on a 1D mesh,
    the hybrid steps on a 1 x world (view, band) mesh."""
    from semantic_gaussians_torch.parallel import train_parallel as tp
    from semantic_gaussians_torch.parallel.mesh import make_mesh, make_mesh_of

    if kind.startswith("hybrid"):
        mesh = make_mesh_of((1, world), ("view", "band"))
        make = tp.make_hybrid_train_step_zero if kind.endswith("zero") else \
            tp.make_hybrid_train_step
        return mesh, make(mesh, cfg, 3, h, w), "band" if kind.endswith("zero") else None
    mesh = make_mesh(world)
    if kind == "dp":
        return mesh, tp.make_parallel_train_step(mesh, cfg, 3), None
    if kind == "band":
        return mesh, tp.make_band_train_step(mesh, cfg, 3), None
    return mesh, tp.make_band_train_step_zero(mesh, cfg, 3, h, w), "data"


def reference_dp_step(state, cams, bg, cfg):
    """The single-device step of view-DP's semantics on several views: each
    view's gradient in turn, their mean, per-view densify norms summed."""
    import dataclasses as dc

    import torch

    from semantic_gaussians_torch.core.densify import add_stats_prereduced
    from semantic_gaussians_torch.core.gaussians import FIELDS
    from semantic_gaussians_torch.core.optimizer import adam_update, lr_tree
    from semantic_gaussians_torch.renderer import render
    from semantic_gaussians_torch.utils.losses import photometric_loss

    params = state.params
    total, norms, vis, radii = None, 0.0, 0.0, None
    for cam in cams:
        leaves = {f: getattr(params, f).detach().requires_grad_(True) for f in FIELDS}
        offset = torch.zeros((params.capacity, 2), device=params.device, requires_grad=True)
        out = render(cam, type(params)(**leaves), alive=state.alive, bg=bg,
                     active_sh_degree=3, mean2d_offset=offset)
        loss = photometric_loss(out["render"], cam.image, cfg.lambda_dssim)
        grads = torch.autograd.grad(loss, [leaves[f] for f in FIELDS] + [offset])
        total = grads[:-1] if total is None else [a + b for a, b in zip(total, grads[:-1])]
        visible = out["radii"] > 0
        scale = torch.tensor([[cam.width * 0.5, cam.height * 0.5]], device=params.device)
        norms = norms + torch.where(visible, torch.linalg.norm(grads[-1] * scale, dim=-1), 0.0)
        vis = vis + visible.float()
        radii = out["radii"] if radii is None else torch.maximum(radii, out["radii"])
    gparams = type(params)(**{f: g / len(cams) for f, g in zip(FIELDS, total)})
    dstate = add_stats_prereduced(state.dstate, norms, vis, radii)
    new_params, adam = adam_update(gparams, state.adam, params,
                                   lr_tree(cfg.hyper, cfg.spatial_lr_scale, state.step), cfg.hyper)
    return dc.replace(state, params=new_params, adam=adam, dstate=dstate, step=state.step + 1)


def state_gap(what, got, want, cfg):
    """A TrainState one step from the zero-moment start against the
    single-device one: bit for bit, or else within test_parallel.py's
    tolerances (each leaf's gradient, its Adam first moment / 0.1, at 2e-3
    of the leaf's largest; densify norms at 2e-3; visibility and max radii
    exact) and Adam's first step (every parameter within 2 lr; within
    1e-2 lr where |g| >= 1e-3 of the leaf's largest). Fails beyond them."""
    import torch

    from semantic_gaussians_torch.core.gaussians import FIELDS
    from semantic_gaussians_torch.core.optimizer import lr_tree

    lrs = lr_tree(cfg.hyper, cfg.spatial_lr_scale, 0)
    exact = True
    worst = {"grad": 0.0, "param_lr": 0.0, "strong_param_lr": 0.0}
    for f in FIELDS:
        pg, pw = getattr(got.params, f), getattr(want.params, f)
        mg, mw = getattr(got.adam.mu, f), getattr(want.adam.mu, f)
        exact &= torch.equal(pg, pw) and torch.equal(mg, mw) and torch.equal(
            getattr(got.adam.nu, f), getattr(want.adam.nu, f))
        scale = float(mw.abs().max()) / 0.1 + 1e-20
        grad = float((mg - mw).abs().max()) / 0.1 / scale
        lr = float(getattr(lrs, f))
        d = (pg - pw).abs()
        strong = (mw / 0.1).abs() >= 1e-3 * scale
        gaps = dict(grad=grad, param_lr=float(d.max()) / lr,
                    strong_param_lr=float(d[strong].max()) / lr if bool(strong.any()) else 0.0)
        for k, v in gaps.items():
            worst[k] = max(worst[k], v)
        if grad > 2e-3 or gaps["param_lr"] > 2 * 1.0001 or gaps["strong_param_lr"] > 1e-2:
            fail(f"{what} {f} against the single-device step: {gaps}")
    for k in ("denom", "max_radii2d"):
        exact &= torch.equal(getattr(got.dstate, k), getattr(want.dstate, k))
        if not torch.equal(getattr(got.dstate, k), getattr(want.dstate, k)):
            fail(f"{what} densify {k} differs from the single-device step")
    acc_g, acc_w = got.dstate.xyz_grad_accum, want.dstate.xyz_grad_accum
    worst["accum"] = float((acc_g - acc_w).abs().max() / (acc_w.max() + 1e-12))
    exact &= torch.equal(acc_g, acc_w)
    if worst["accum"] > 2e-3:
        fail(f"{what} densify norms against the single-device step: {worst['accum']}")
    return dict(bit_for_bit=bool(exact), **worst)


def image_gap(what, got, want):
    """render_sharded's outputs against the single-device render's: bit for
    bit, or else render rtol 1e-4 / atol 1e-5, depth 1e-4, final_T 1e-5,
    n_contrib exact (the CPU tests' tolerances)."""
    import torch

    exact = all(torch.equal(got[k], want[k]) for k in ("render", "depth", "final_T",
                                                       "n_contrib"))
    if not torch.equal(got["n_contrib"], want["n_contrib"]):
        fail(f"{what}: n_contrib differs at {int((got['n_contrib'] != want['n_contrib']).sum())} px")
    for k, rtol, atol in (("render", 1e-4, 1e-5), ("depth", 1e-4, 1e-4),
                          ("final_T", 1e-4, 1e-5)):
        try:
            torch.testing.assert_close(got[k], want[k], rtol=rtol, atol=atol)
        except AssertionError as e:
            fail(f"{what} {k} against the single-device render: {e}")
    if int(got["overflow"]) != 0:
        fail(f"{what}: overflow {int(got['overflow'])}")
    return dict(bit_for_bit=bool(exact),
                max_abs_err=float((got["render"] - want["render"]).abs().max()))


def state_digest(state):
    """sha256 of a TrainState's parameters, alive mask and moments."""
    import hashlib

    from semantic_gaussians_torch.core.gaussians import FIELDS

    h = hashlib.sha256()
    for p in (state.params, state.adam.mu, state.adam.nu):
        for f in FIELDS:
            h.update(getattr(p, f).detach().cpu().numpy().tobytes())
    h.update(state.alive.cpu().numpy().tobytes())
    return h.hexdigest()


def distributed_items(world, job):
    """Phase 15's items on this rank (world = 1: one rank over NCCL in the
    main process; world = 2: a child process of two over gloo), each
    distributed call counted and timed and held against its single-device
    counterpart on the card, computed after it. Returns launches, checks,
    per-rank times and the bytes handed to collectives a step."""
    import dataclasses as dc

    import numpy as np
    import torch

    from semantic_gaussians_torch.core.gaussians import params_from_numpy
    from semantic_gaussians_torch.io.ply import load_gaussian_ply
    from semantic_gaussians_torch.io.scene import load_scene, realize_camera
    from semantic_gaussians_torch.parallel import train_parallel as tp
    from semantic_gaussians_torch.parallel.mesh import make_mesh, make_mesh_of
    from semantic_gaussians_torch.parallel.render_sharded import render_sharded
    from semantic_gaussians_torch.pipelines import distill as td
    from semantic_gaussians_torch.pipelines.fusion import (
        FusionConfig, _intrinsic_for, fuse_view, make_parallel_fuse_step,
    )
    from semantic_gaussians_torch.pipelines.train import TrainConfig, init_train_state, train_step
    from semantic_gaussians_torch.renderer import render

    dev = torch.device(job["device"])
    launches, checks, times, comm = {}, {}, {}, {}

    def synced(fn):
        def run():
            out = fn()
            torch.cuda.synchronize()
            return out
        return run

    # -- render_sharded on the viewer scene, RGB (and C = 768 at one rank)
    arrays, feats_np = make_scene(np, N_GAUSSIANS, feats=world == 1)
    params, alive = padded_params(arrays, dev)
    cam = viewer_camera(dev)
    mesh = make_mesh(world)
    cases = {"rgb": None}
    if world == 1:
        feats = torch.zeros((params.capacity, FEAT_DIM), device=dev)
        feats[:N_GAUSSIANS] = torch.from_numpy(feats_np).to(dev)
        cases[f"C={FEAT_DIM}"] = feats
    for name, override in cases.items():
        mesh.comm_bytes.clear()
        got = counted(launches, lambda: render_sharded(cam, params, alive, mesh,
                                                        override_color=override))
        comm[f"render_sharded {name}"] = dict(mesh.comm_bytes)
        want = render(cam, params, alive=alive, override_color=override)
        checks[f"render_sharded {name}"] = image_gap(f"render_sharded {name}", got, want)
        times[f"render_sharded {name}"] = host_ms(synced(
            lambda: render_sharded(cam, params, alive, mesh, override_color=override)), DIST_REPS)
        times[f"render {name}"] = host_ms(synced(
            lambda: render(cam, params, alive=alive, override_color=override)), DIST_REPS)
    del params, alive, cases, arrays, feats_np
    torch.cuda.empty_cache()

    # -- the train steps on the timed training view (view-DP: `world` views)
    info = load_scene(job["scene"])
    cams = [realize_camera(ci, device=dev) for ci in info.train_cameras]
    _, _, tparams, talive = training_view(job["scene"], dev)
    # random rotations and anisotropic scales, as the JAX package's parallel
    # tests draw them: the point cloud's isotropic splats have a rotation
    # gradient of exactly zero, which would hold rounding against rounding
    draw = np.random.default_rng(SEED)
    tparams = dc.replace(
        tparams,
        quats=torch.from_numpy(draw.normal(size=tuple(tparams.quats.shape)).astype(np.float32)
                               ).to(dev),
        log_scales=tparams.log_scales + torch.from_numpy(draw.uniform(
            -0.8, 0.8, size=tuple(tparams.log_scales.shape)).astype(np.float32)).to(dev),
    )
    extent = float(info.nerf_normalization["radius"])
    cfg = TrainConfig(spatial_lr_scale=extent)
    state0 = init_train_state(tparams, talive)
    bg = torch.zeros(3, device=dev)
    h, w = cams[0].height, cams[0].width
    single = train_step(state0, cams[0], bg, cfg, 3)[0]
    times["train_step"] = host_ms(synced(lambda: train_step(state0, cams[0], bg, cfg, 3)),
                                  DIST_REPS)
    for kind in SCHEDULES:
        kmesh, step, zaxis = schedule_step(kind, world, cfg, h, w)
        arg = tp.stack_cameras(cams[:world]) if kind == "dp" else (
            tp.stack_cameras(cams[:1]) if kind.startswith("hybrid") else cams[0])
        start = tp.shard_moments(state0, kmesh, zaxis) if zaxis else state0
        kmesh.comm_bytes.clear()
        new, _ = counted(launches, lambda: step(start, arg, bg))
        comm[kind] = dict(kmesh.comm_bytes)
        if zaxis:
            new = tp.gather_moments(new, kmesh, zaxis)
        want = reference_dp_step(state0, cams[:world], bg, cfg) if kind == "dp" and world > 1 \
            else single
        checks[kind] = state_gap(kind, new, want, cfg)
        times[kind] = host_ms(synced(lambda: step(start, arg, bg)), DIST_REPS)
    del single, new, start

    # -- the hybrid loop (two ranks): a densify at 20, ranks bitwise equal
    if world > 1:
        lcfg = dc.replace(cfg, densify_from_iter=10, densification_interval=20,
                          densify_until_iter=DIST_LOOP_ITERS)
        lmesh = make_mesh_of((1, world), ("view", "band"))
        gen = torch.Generator(device=dev).manual_seed(SEED)
        t0 = time.perf_counter()
        state, hist = counted(launches, lambda: tp.hybrid_train_loop(
            state0, cams, lcfg, gen, lmesh, scene_extent=extent, num_iters=DIST_LOOP_ITERS))
        checks["hybrid_loop"] = dict(
            digest=state_digest(state), alive_before=int(talive.sum()),
            alive_after=int(state.alive.sum()), capacity=state.params.capacity,
            step=int(state.step), wall_s=time.perf_counter() - t0)
        del state
    del state0, tparams, talive
    torch.cuda.empty_cache()

    # -- view-parallel fusion: `world` ring views of the fusion phase's maps
    fp, fa = load_gaussian_ply(job["fusion_model"])
    fparams, falive = params_from_numpy(fp, dev), torch.from_numpy(fa).to(dev)
    fcfg = FusionConfig(img_dim=(FUSE_W, FUSE_H), visibility_threshold=VISIBILITY)
    fcams = [realize_camera(ci, with_image=False).resized(FUSE_W, FUSE_H).to(dev)
             for ci in info.train_cameras[:world]]
    intr = torch.stack([torch.from_numpy(_intrinsic_for(c, fcfg.img_dim)) for c in fcams]).to(dev)

    def fmap(i):
        path = Path(job["feature_dir"]) / f"{info.train_cameras[i].image_name}.npy"
        return torch.from_numpy(np.load(path)).to(dev)

    rank = torch.distributed.get_rank() if torch.distributed.is_initialized() else 0
    maps = [fmap(i) if i == rank else None for i in range(world)]
    fmesh = make_mesh(world)
    fstep = make_parallel_fuse_step(fmesh, fcfg.img_dim, VISIBILITY, fcfg.cut_boundary)
    zeros = (torch.zeros((fparams.capacity, FEAT_DIM), device=dev),
             torch.zeros(fparams.capacity, device=dev))
    ones = torch.ones(world, device=dev)
    fmesh.comm_bytes.clear()
    sem, cnt = counted(launches, lambda: fstep(*zeros, fparams, falive, fcams, intr, maps, ones))
    comm["fuse"] = dict(fmesh.comm_bytes)
    times["fuse"] = host_ms(synced(lambda: fstep(*zeros, fparams, falive, fcams, intr, maps,
                                                  ones)), 3)
    ssem, scnt = torch.zeros_like(zeros[0]), torch.zeros_like(zeros[1])
    with torch.no_grad():
        for i in range(world):
            depth = render(fcams[i], fparams, alive=falive, override_shape=fcfg.img_dim)["depth"]
            fuse_view(ssem, scnt, fparams.means, falive, fcams[i].world_view, intr[i],
                      maps[i] if maps[i] is not None else fmap(i), depth, fcfg.img_dim,
                      VISIBILITY, fcfg.cut_boundary)
    if not torch.equal(cnt, scnt):
        fail(f"parallel fusion counts differ from serial at {int((cnt != scnt).sum())} rows")
    try:
        torch.testing.assert_close(sem, ssem, rtol=1e-6, atol=1e-6)
    except AssertionError as e:
        fail(f"parallel fusion features against serial fuse_view: {e}")
    checks["fuse"] = dict(bit_for_bit=bool(torch.equal(sem, ssem)), visited=int((cnt > 0).sum()),
                          max_abs_err=float((sem - ssem).abs().max()))
    del sem, cnt, ssem, scnt, zeros, maps, fparams, falive
    torch.cuda.empty_cache()

    # -- scene-parallel distillation: the distill phase's item, one a rank
    budget = DISTILL_BUDGET if world == 1 else DIST_DISTILL_BUDGET
    dcfg = td.DistillConfig(model_3d=DISTILL_ARCH, feature_dim=FEAT_DIM, epochs=1000)
    items = [distill_item(job["fusion_model"], job["distill_pt"], seed=i, budget=budget)
             for i in range(world)]
    batch = td.stack_items(items, dev)
    model, opt, schedule = td.make_distill_state(dcfg, 1, SEED, device=dev)
    pstep = td.make_parallel_distill_step(model, opt, schedule, dcfg, make_mesh(world))
    torch.cuda.reset_peak_memory_stats()
    loss = float(counted(launches, lambda: pstep(*batch)))
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not np.isfinite(loss):
        fail(f"parallel distill loss {loss}")
    stats = {k: v for k, v in model.state_dict().items() if k.endswith((".mean", ".var"))}
    dcheck = dict(loss=loss, voxels=[it.num_voxels for it in items], budget=budget,
                  peak_gib=peak)
    if world == 1:
        # against make_distill_step from the same weights: the sums of the
        # conv backward (index_add_) run in no fixed order on the card
        ref, ropt, rsched = td.make_distill_state(dcfg, 1, SEED, device=dev)
        rloss = float(td.make_distill_step(ref, ropt, rsched, dcfg)(
            *td.item_tensors(items[0], items[0].coords, dev)))
        rstate = ref.state_dict()
        lr = rsched(0)
        dcheck.update(single_loss=rloss, bit_for_bit=all(
            torch.equal(v, rstate[k]) for k, v in model.state_dict().items()))
        if abs(loss - rloss) > 1e-4 * abs(rloss):
            fail(f"parallel distill loss {loss} against the single-device step's {rloss}")
        worst_stat = max(float((v - rstate[k]).abs().max() / (rstate[k].abs().max() + 1e-30))
                         for k, v in stats.items())
        worst_w = max(float((p.detach() - rstate[k]).abs().max()) / lr
                      for k, p in model.named_parameters())
        dcheck.update(batch_stats_gap=worst_stat, weights_gap_lr=worst_w)
        if worst_stat > 1e-4 or worst_w > 2 * 1.0001:
            fail(f"parallel distill against the single-device step: batch stats "
                 f"{worst_stat}, weights {worst_w} lr")
        del ref, ropt
    else:
        import hashlib

        h = hashlib.sha256()
        for v in model.state_dict().values():
            h.update(v.detach().cpu().numpy().tobytes())
        dcheck["digest"] = h.hexdigest()
    # one timed call after the checked one: the step is timed on one device
    # in phase 9b and by bench_distill in phase 17
    times["distill_step"] = host_ms(synced(lambda: pstep(*batch)), 1)
    checks["distill"] = dcheck
    del model, opt, pstep, batch
    torch.cuda.empty_cache()
    return dict(launches=launches, checks=checks, times_ms=times, comm_bytes=comm)


def _items_rank(rank, world, job):
    """One of phase 15's two ranks sharing the card over gloo."""
    return distributed_items(world, job)


def _cli_rank(rank, world, job):
    """The train CLI with pipeline.distributed=true on this rank (it makes
    the process group from the launch variables)."""
    import torch

    from semantic_gaussians_torch.cli import train as train_cli

    acc = {}
    t0 = time.perf_counter()
    summary = counted(acc, lambda: train_cli.main([
        str(ROOT / "semantic_gaussians_torch" / "config" / "yamls" / "official_train.yaml"),
        f"scene.scene_path={job['scene']}", f"train.out_dir={job['out_dir']}",
        f"train.iterations={DIST_CLI_ITERS}", "train.test_iterations=[]",
        "train.save_iterations=[]", "train.densify_from_iter=10",
        "train.densification_interval=20", f"train.densify_until_iter={DIST_CLI_ITERS}",
        "pipeline.distributed=true", "pipeline.dist_backend=gloo", "pipeline.zero=true",
        f"train.device={torch.device(job['device']).type}",
    ]))
    wall = time.perf_counter() - t0
    state = summary["state"]
    return dict(launches=acc, plys=[str(p) for p in summary["plys"]], wall_s=wall,
                digest=state_digest(state), alive=int(state.alive.sum()),
                loss=[m["loss"] for _, m in summary["logs"][-1]["history"]],
                device=str(state.params.device), peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def spawn_ranks(job, world=2):
    """Run `job` on `world` spawned processes sharing the card; return
    their results in rank order. A child's failure, non-zero exit or
    silence past DIST_TIMEOUT_S fails the run; every child is stopped."""
    from semantic_gaussians_torch.parallel import multihost

    if job["kind"] == "cli":
        fn, init = _cli_rank, None
    else:  # both ranks on the one card: NCCL refuses two ranks a device
        fn, init = _items_rank, dict(device=job["device"], backend="gloo",
                                     timeout_s=DIST_TIMEOUT_S)
    try:
        return multihost.spawn_ranks(fn, world, job, timeout=DIST_TIMEOUT_S, init=init)
    except (RuntimeError, TimeoutError) as e:
        fail(f"phase 15 {job['kind']}: {e}")


def distributed_phase(tmpdir, scene, fused, dev, card):
    """Phase 15, the multi-device schedules (parallel/): (a) one rank over
    NCCL in this process at full width, (b) two processes sharing the card
    over gloo, then the train CLI with pipeline.distributed=true on two
    processes. Returns the distributed path's launches (all three parts)
    and the numbers."""
    import torch

    from semantic_gaussians_torch.cli.view_server import ViewerState
    from semantic_gaussians_torch.config.config import default_config_dir, load_config
    from semantic_gaussians_torch.parallel import multihost

    t_phase = time.perf_counter()
    ply = sorted((fused["model_dir"] / "point_cloud").glob("iteration_*"))[-1] / "point_cloud.ply"
    job = dict(kind="items", device=str(dev), scene=str(scene),
               feature_dir=str(tmpdir / "feats"), fusion_model=str(ply), distill_pt=str(sorted(
                   (fused["fusion_out"] / scene.name).glob("*.pt"))[0]))
    torch.cuda.empty_cache()

    # (a) one rank over NCCL: every collective an identity
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    multihost.init_distributed(f"127.0.0.1:{port}", 1, 0, device=dev,
                               backend="nccl" if dev.type == "cuda" else "gloo",
                               timeout_s=DIST_TIMEOUT_S)
    try:
        t0 = time.perf_counter()
        one = distributed_items(1, job)
        one["wall_s"] = time.perf_counter() - t0
    finally:
        torch.distributed.destroy_process_group()
    torch.cuda.empty_cache()
    print(json.dumps({"card": card, "distributed_one_rank_nccl": one}, default=str))

    # (b) two ranks on the card over gloo
    t0 = time.perf_counter()
    two = spawn_ranks(job)
    wall_two = time.perf_counter() - t0
    a, b = two
    if a["checks"]["hybrid_loop"]["digest"] != b["checks"]["hybrid_loop"]["digest"]:
        fail("hybrid loop: the two ranks' states differ")
    loop = a["checks"]["hybrid_loop"]
    if loop["alive_after"] == loop["alive_before"] or loop["step"] != DIST_LOOP_ITERS:
        fail(f"hybrid loop: no densify or wrong step count: {loop}")
    if a["checks"]["distill"]["digest"] != b["checks"]["distill"]["digest"]:
        fail("parallel distill: the two ranks' weights differ")
    print(json.dumps({"card": card, "distributed_two_ranks_gloo": two,
                      "wall_s": wall_two}, default=str))

    # (b') the train CLI, distributed, on two processes
    out_dir = tmpdir / "dist_train_out"
    t0 = time.perf_counter()
    cli = spawn_ranks(dict(kind="cli", device=str(dev), scene=str(scene),
                           out_dir=str(out_dir)))
    wall_cli = time.perf_counter() - t0
    plys = sorted(out_dir.rglob("*.ply"))
    if cli[1]["plys"] or len(cli[0]["plys"]) != 1 or [str(p) for p in plys] != cli[0]["plys"]:
        fail(f"distributed train CLI: PLYs {plys}, rank 0 {cli[0]['plys']}, rank 1 {cli[1]['plys']}")
    if cli[0]["digest"] != cli[1]["digest"]:
        fail("distributed train CLI: the two ranks' states differ")
    viewer = ViewerState(load_config(default_config_dir() / "view_scannet.yaml",
                                     [f"model.model_dir={out_dir}", f"render.device={dev}"]))
    img = viewer.render({"mode": ["RGB"], "w": [str(WIDTH)], "h": [str(HEIGHT)],
                         "fov": ["1.1"], "pose": [POSE]})
    if img.shape != (HEIGHT, WIDTH, 3) or img.max() == img.min():
        fail(f"the distributed CLI's PLY does not render: {img.shape}")
    del viewer
    print(json.dumps({"card": card, "distributed_train_cli": cli, "wall_s": wall_cli},
                     default=str))

    launches = {}
    for part in [one, *two, *cli]:
        for k, v in part["launches"].items():
            launches[k] = launches.get(k, 0) + v
    for name in ("expand", "composite_fwd", "composite_bwd", "segsum"):
        if launches.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched on the distributed path")
    wall = time.perf_counter() - t_phase
    print(f"phase 15 (distributed): {wall:.1f} s; one rank (NCCL) {one['wall_s']:.1f} s, two "
          f"ranks (gloo) {wall_two:.1f} s, train CLI on two ranks {wall_cli:.1f} s; launches "
          f"{launches}")
    return dict(launches=launches, wall_s=wall)


# ------------------------------------------------------------------ phase 16
PARITY_ITERS = 600  # the first PSNR readings (50, 550) and the first densify (600)
# The semantic harness's depth cut: 6 of 30 fused views, 2 of 8 evaluated,
# 6 of 300 distill steps (the 4th traced for the busy share).
SEMANTIC_CUT = dict(n_fuse=6, n_eval=2, epochs=6)


def check_path_kernels(label, params, alive, cam, budget, features, backward=False,
                       sh_degree=None):
    """Kernels 1-5 against their plain versions on one phase-16 path's
    inputs, built as the renderer builds them (project_gaussians, binning
    with the tight cull, pack_geometry; 16x32 tiles) at the path's pair
    budget: expand bit for bit; composite_forward for each entry of
    `features` ({C: [N, C] features, or None for the projected SH colours
    at `sh_degree`}) at check_forward's tolerances; with `backward`, at C =
    3, composite_backward on a random upstream gradient and the segment sum
    of its generation rows (check_composite's and check_segsum's
    tolerances). Returns {kernel: largest |kernel - plain|}."""
    import torch

    from semantic_gaussians_torch.ops import composite, expand
    from semantic_gaussians_torch.ops.binning import bin_gaussians, depth_sorted_rects
    from semantic_gaussians_torch.ops.projection import project_gaussians
    from semantic_gaussians_torch.ops.rasterize import generation_rows

    dev = params.device
    th, tw = 16, 32
    grid = (-(-cam.height // th), -(-cam.width // tw))
    n = params.capacity
    errs = {"expand": 0.0}
    with torch.no_grad():
        proj = project_gaussians(
            params.means, params.scales, params.quats, params.opacity[:, 0], cam.world_view,
            cam.full_proj, cam.camera_center, cam.width, cam.height, cam.tan_half_fov_x,
            cam.tan_half_fov_y, sh_coeffs=params.sh_coeffs,
            sh_degree=params.max_sh_degree if sh_degree is None else sh_degree, alive=alive)
        ex = depth_sorted_rects(proj.means2d, proj.depths, proj.radii_xy, (th, tw), grid,
                                budget, proj.cull_ellipse)
        check_expand(label, expand, expand_args(ex, budget, grid, n, th, tw))
        binning = bin_gaussians(proj.means2d, proj.depths, proj.radii_xy, (th, tw), grid,
                                budget, proj.cull_ellipse)
        if int(binning.overflow):
            fail(f"{label}: {int(binning.overflow)} pairs past the budget {budget}")
        geom = composite.pack_geometry(proj.means2d, proj.conics, proj.opacities, proj.depths)
        for c, feats in features.items():
            colors = (proj.colors if feats is None else feats).to(torch.float32).contiguous()
            args = (geom, colors, binning.pair_gaussian, binning.tile_start,
                    binning.tile_count, torch.zeros(c, device=dev), grid[1], th, tw)
            if not (backward and c == 3):
                _, errs[f"composite_fwd C={c}"] = check_forward(f"{label} C={c}", args)
                continue
            g_color = torch.randn((binning.tile_start.numel(), 3, th * tw), device=dev,
                                  generator=torch.Generator(dev).manual_seed(SEED + 16))
            bargs, errs["composite_fwd C=3"], errs["composite_bwd"], _, _ = check_composite(
                f"{label} C=3", args, g_color)
            rows = generation_rows(composite.composite_backward(*bargs), binning)
            errs["segsum"] = check_segsum(
                f"{label} D={rows.shape[1]}", (rows, binning.gen_owner, n + 1,
                                               binning.num_pairs), exact=False)
    print(f"{label} ({cam.width}x{cam.height}, n={n}, budget {budget}, "
          f"{int(binning.num_pairs)} pairs): kernels match their plain versions, largest "
          f"|kernel - plain| {errs}")
    return errs


def profile_step_kernels(dev):
    """Kernels 1-5 on profile_step's bench view (its defaults: 100,000
    Gaussians at 640x480, the probe's tuned budget)."""
    from semantic_gaussians_torch.tools import profile_step

    params, alive, cam, _ = profile_step.bench_scene(100_000, 640, 480, dev)
    budget, _ = profile_step.probe_budget(cam, params, alive)
    return {"bench view": check_path_kernels("profile_step bench view", params, alive, cam,
                                             budget, {3: None}, backward=True)}


def parity_kernels(dev):
    """Kernels 1-2 on the parity harness's first GT render (the true scene
    at --gt-ss times 480x352, its GT budget), kernels 1-5 on its first
    training view at 480x352 from the SfM-like init (SH degree 0, the fixed
    training budget)."""
    import numpy as np

    from semantic_gaussians_torch.core.gaussians import init_from_pcd
    from semantic_gaussians_torch.tools import parity_harness as ph

    args = ph.parse_args([])
    rng = np.random.default_rng(11)
    tpts, tcols = ph.build_true_scene(rng, density=args.density)
    true_params, true_alive = init_from_pcd(tpts, tcols, sh_degree=3, device=dev)
    cams, _ = ph.ring_cameras(args.width, args.height, dev)
    ss = args.gt_ss
    out = {"gt view": check_path_kernels(
        "parity GT view", true_params, true_alive,
        cams[0].resized(args.width * ss, args.height * ss), ph.GT_PAIR_BUDGET * ss,
        {3: None})}
    del true_params, true_alive
    params, alive, _ = ph.sfm_init(rng, tpts, tcols, args, dev)
    out["training view"] = check_path_kernels(
        "parity training view", params, alive, cams[0], args.pair_budget, {3: None},
        backward=True, sh_degree=0)
    return out


def semantic_kernels(args, dev):
    """Kernels 1-2 on the semantic harness's first eval view at its tuned
    budget: C = dim (mode 2d's feature render; the fused features' stand-in
    is each Gaussian's oracle text row) and C = K + 1 (the one-hot class
    render of pred_on_3d)."""
    import torch

    from semantic_gaussians_torch.tools import semantic_harness as sh

    sc = sh.build_scene(args, dev)
    budget, _ = sh.eval_pair_budget(sc.eval_cams[0], sc.params, sc.alive)
    cls = torch.from_numpy(sc.cls).to(dev).long()
    labelled = (cls < len(sh.LABELS))[:, None]
    one_hot = torch.nn.functional.one_hot(torch.where(labelled[:, 0], cls + 1, 0),
                                          len(sh.LABELS) + 1).to(torch.float32) * labelled
    feats = torch.from_numpy(sc.lookup).to(dev)[cls] * sc.alive[:, None]
    return {"eval view": check_path_kernels(
        "semantic eval view", sc.params, sc.alive, sc.eval_cams[0], budget,
        {args.dim: feats, len(sh.LABELS) + 1: one_hot})}


def profile_step_path(scene, dev, card):
    """Phase 16 (a): tools.profile_step's bench step (its main), then the
    port's train_step on the timed training view through the same
    tracing, each table printed. Returns both tables' numbers."""
    import torch

    from semantic_gaussians_torch.ops.binning import default_pair_budget
    from semantic_gaussians_torch.pipelines.train import TrainConfig, init_train_state, train_step
    from semantic_gaussians_torch.tools import profile_step

    bench = profile_step.main([])
    info, cam, params, alive = training_view(scene, dev)
    cfg = TrainConfig(spatial_lr_scale=float(info.nerf_normalization["radius"]))
    bg = torch.zeros(3, device=dev)
    budget = default_pair_budget(params.capacity)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tdir:
        prof = profile_step.profile_steps(
            lambda st: train_step(st, cam, bg, cfg, 3, pair_budget=budget)[0],
            init_train_state(params, alive), Path(tdir), dev)
    profile_step.print_table(f"train_step on the timed training view ({card})", prof)
    for name, p in (("bench step", bench), ("train_step", prof)):
        if not p["rows"] or not p["device_busy_ms"]:
            fail(f"profile_step: the {name}'s trace holds no device time")
    return dict(bench=bench, train_step=prof, train_step_budget=budget)


def parity_path(workdir):
    """Phase 16 (b): the parity harness at full width, PARITY_ITERS deep."""
    from semantic_gaussians_torch.tools import parity_harness as ph

    args = ph.parse_args(["--iters", str(PARITY_ITERS), "--out", str(workdir / "parity.json")])
    t0 = time.perf_counter()
    report, extra = ph.run(args)
    wall = time.perf_counter() - t0
    curve = {c["iter"]: c for c in report["curve"]}
    p50, p550 = curve[50]["test_psnr"], curve[550]["test_psnr"]
    n_init, alive = report["config"]["n_init"], curve[PARITY_ITERS]["alive"]
    checks = dict(psnr_rises=p550 >= p50 + 3.0, psnr_floor=p550 >= 27.0,
                  densify_grew=alive > n_init,
                  zero_overflow=report["checks"]["zero_overflow"])
    print(f"parity harness ({PARITY_ITERS} of 30,000 iterations): test PSNR {p50:.2f} at 50, "
          f"{p550:.2f} at 550; alive {n_init} -> {alive} at {PARITY_ITERS}; "
          f"overflow {report['final']['total_overflow']}; {wall:.1f} s; {extra}")
    for name, ok in checks.items():
        if not ok:
            fail(f"parity harness cut: check {name} failed ({report['final']})")
    return dict(psnr_50=p50, psnr_550=p550, psnr_end=report["final"]["test_psnr"],
                n_true=report["config"]["n_true"], n_init=n_init, alive=alive, checks=checks,
                wall_s=wall, **extra)


def semantic_args(workdir):
    """The semantic harness's arguments at SEMANTIC_CUT's depth."""
    from semantic_gaussians_torch.tools import semantic_harness as sh

    cut = SEMANTIC_CUT
    return sh.parse_args([
        "--n-fuse", str(cut["n_fuse"]), "--n-eval", str(cut["n_eval"]),
        "--epochs", str(cut["epochs"]), "--epoch-block", str(cut["epochs"]),
        "--workdir", str(workdir / "semantic"), "--out", str(workdir / "semantic.json")])


def semantic_path(args):
    """Phase 16 (c): the semantic harness at full width, SEMANTIC_CUT deep."""
    import numpy as np

    from semantic_gaussians_torch.tools import semantic_harness as sh

    cut = SEMANTIC_CUT
    report, extra = sh.run(args)
    m = report["metrics"]
    checks = dict(fused_cos=report["checks"]["fused_cos"], visited=report["checks"]["visited"],
                  miou_2d=report["checks"]["miou_2d"],
                  finite=bool(np.isfinite([m["miou_3d"], m["miou_ensemble"]]).all()),
                  all_counted=all(v == extra["labelled_pixels"]
                                  for v in extra["counted_pixels"].values()))
    print(f"semantic harness ({cut}): {json.dumps(m)}; counted {extra['counted_pixels']} of "
          f"{extra['labelled_pixels']} labelled pixels; {extra['wall_s']:.1f} s")
    for name, ok in checks.items():
        if not ok:
            fail(f"semantic harness cut: check {name} failed ({m})")
    return dict(metrics=m, checks=checks, timings=report["timings"],
                labelled_pixels=extra["labelled_pixels"], wall_s=extra["wall_s"])


def harness_phase(scene, dev, card):
    """Phase 16: the three harness paths, each with its launch counts, and
    the kernels held against their plain versions on each path's inputs
    (outside the counted runs)."""
    import torch

    t0 = time.perf_counter()
    kernels_of_training = ("expand", "composite_fwd", "composite_bwd", "segsum")
    out, launches, checked = {}, {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_harness_") as tmp:
        work = Path(tmp)
        checked["profile_step"] = profile_step_kernels(dev)
        out["profile_step"], launches["profile_step"] = count_launches(
            "profile_step", lambda: profile_step_path(scene, dev, card), kernels_of_training)
        checked["parity_harness"] = parity_kernels(dev)
        torch.cuda.empty_cache()
        out["parity"], launches["parity_harness"] = count_launches(
            "parity harness", lambda: parity_path(work), kernels_of_training)
        torch.cuda.empty_cache()
        args = semantic_args(work)
        checked["semantic_harness"] = semantic_kernels(args, dev)
        torch.cuda.empty_cache()
        out["semantic"], launches["semantic_harness"] = count_launches(
            "semantic harness", lambda: semantic_path(args), ("expand", "composite_fwd"))
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    # {kernel: {path: largest |kernel - plain| over the path's checked views}}
    errors = {}
    for path, views in checked.items():
        for errs in views.values():
            for what, err in errs.items():
                kernel = errors.setdefault(what.split(" ")[0], {})
                kernel[path] = max(kernel.get(path, 0.0), err)
    cuts = dict(parity_iters=f"{PARITY_ITERS} of 30,000",
                semantic=f"{SEMANTIC_CUT['n_fuse']} of 30 fused views, {SEMANTIC_CUT['n_eval']} "
                         f"of 8 evaluated, {SEMANTIC_CUT['epochs']} of 300 distill steps")
    bench, train = out["profile_step"]["bench"], out["profile_step"]["train_step"]
    busy = ("wall_ms", "traced_wall_ms", "device_busy_ms", "device_busy_share")
    print(json.dumps({"card": card, "phase16": dict(
        wall_s=wall, cuts=cuts, launches=launches,
        profile_step=dict(
            bench=dict(pairs=bench["pairs"], budget=bench["budget"],
                       **{k: bench[k] for k in busy}, top=bench["rows"][:12]),
            train_step=dict(budget=out["profile_step"]["train_step_budget"],
                            **{k: train[k] for k in busy}, top=train["rows"][:12])),
        parity=out["parity"], semantic=out["semantic"], kernel_checks=checked)},
        default=str))
    print(f"phase 16 (harnesses): {wall:.1f} s; launches {launches}")
    return dict(out, launches=launches, errors=errors, wall_s=wall)


# ------------------------------------------------------------------ phase 17
# bench.py's four configurations (the headline, its serving path, BASELINE
# configs #2 and #4), each run as `python -m semantic_gaussians_torch.tools.bench`.
# The first run probes the card from a child process; the later ones skip
# the probe (--probe-timeout 0), which costs a process start and a CUDA init.
BENCH_RUNS = (("100k fwd+bwd", []),
              ("100k forward-only", ["--forward-only", "--probe-timeout", "0"]),
              ("1M fwd+bwd", ["--n", "1000000", "--probe-timeout", "0"]),
              ("5M 1920x1080 fwd+bwd", ["--n", "5000000", "--width", "1920", "--height", "1080",
                                        "--probe-timeout", "0"]))
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline", "step_ms", "pairs", "device"]
BENCH_TIMEOUT_S = 420
# bench_distill at full width (131,072 room voxels, MinkUNet34A, 56 -> 768),
# cut in depth: 2 warm-up + 2 timed steps, 1 + 2 forwards.
DISTILL_VOXELS = 131_072
DISTILL_CUT = dict(inner=2, iters=1)


def run_bench(label, args, card):
    """bench as a user runs it, in a child process: its one JSON line,
    checked for bench.py's keys and values, and the child's kernel launches
    (its stderr's "kernel launches" line)."""
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "semantic_gaussians_torch.tools.bench", *args], cwd=ROOT,
            capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        fail(f"bench {label}: no result in {BENCH_TIMEOUT_S} s")
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"bench {label}: exit code {proc.returncode}: {proc.stdout[-800:]} {proc.stderr[-2000:]}")
    lines = proc.stdout.strip().splitlines()
    try:
        record = json.loads(lines[-1])
        launches = json.loads(next(l for l in proc.stderr.splitlines()
                                   if l.startswith("kernel launches "))[len("kernel launches "):])
    except (IndexError, StopIteration, json.JSONDecodeError) as e:
        fail(f"bench {label}: malformed output ({e}): {proc.stdout[-800:]} {proc.stderr[-800:]}")
    mode = "forward/serving" if "--forward-only" in args else "fwd+bwd"
    ok = (len(lines) == 1 and isinstance(record, dict) and list(record) == BENCH_KEYS
          and record["unit"] == "rays/s" and record["device"] == card
          and record["metric"].startswith(f"rays/s per chip ({mode}), ")
          and isinstance(record["pairs"], int) and record["pairs"] > 0
          and all(isinstance(record[k], float) and record[k] > 0
                  for k in ("value", "vs_baseline", "step_ms"))
          and record["vs_baseline"] == round(record["value"] / 1e8, 4))
    if not ok:
        fail(f"bench {label}: malformed line {lines}")
    print(f"bench {label}: {json.dumps(record)} ({wall:.1f} s)")
    return dict(record, wall_s=wall), launches


def bench_path_kernels(dev):
    """Kernels 1-5 on the tools' own views, outside the counted run (the
    100k bench view is held in phase 16): bench.py's 1M view and its 5M
    1920x1080 view at the probe's tuned budget, bench_components' view at
    its fixed budget, bench_scaling's SH-0 view at its one-rank band budget;
    kernels 1-2 on bench_eval's first view at C = 768 with its features, at
    eval_views' default budget. Returns {view: {kernel: largest |kernel -
    plain|}} and the seconds each view's check took."""
    import torch

    from semantic_gaussians_torch.ops.binning import default_pair_budget
    from semantic_gaussians_torch.tools import bench, bench_components, bench_eval
    from semantic_gaussians_torch.tools import bench_scaling

    def bench_view(n, w, h):
        params, alive, cam, _ = bench.bench_scene(n, w, h, dev)
        return params, alive, cam, bench.probe_budget(cam, params, alive)[0]

    def eval_view():
        cams, _, params, alive, feats, _, _ = bench_eval.eval_inputs(
            100_000, 768, 1, 640, 480, 19, dev)
        return params, alive, cams[0], default_pair_budget(params.capacity), {768: feats}

    views = {
        "1M view": lambda: bench_view(1_000_000, 640, 480),
        "5M 1920x1080 view": lambda: bench_view(5_000_000, 1920, 1080),
        "bench_components view": lambda: (*bench.bench_scene(100_000, 640, 480, dev)[:3],
                                          bench_components.BUDGET),
        "bench_scaling band view": lambda: (*bench_scaling.scaling_scene(100_000, 640, 480,
                                                                         dev)[:3],
                                            bench_scaling.BAND_BUDGET),
        "bench_eval view 0": eval_view,
    }
    errs, secs = {}, {}
    for label, make in views.items():
        t0 = time.perf_counter()
        params, alive, cam, budget, *feats = make()
        errs[label] = check_path_kernels(f"bench tools, {label}", params, alive, cam, budget,
                                         feats[0] if feats else {3: None}, backward=not feats)
        del params, alive, cam, feats
        torch.cuda.empty_cache()
        secs[label] = time.perf_counter() - t0
        print(f"bench tools, {label}: checked in {secs[label]:.1f} s")
    return errs, secs


def distill_bench(dev):
    """bench_distill's timing body at full width and DISTILL_CUT's depth,
    with the peak memory it allocated."""
    import torch

    from semantic_gaussians_torch.tools import bench_distill

    torch.cuda.empty_cache()
    r, peak = peak_gib(lambda: bench_distill.time_distill(
        DISTILL_VOXELS, "MinkUNet34A", 768, dev, **DISTILL_CUT))
    print(f"bench_distill ({DISTILL_CUT}): {DISTILL_VOXELS} room voxels ({r['voxels']} unique), "
          f"step {r['step_ms']:.1f} ms ({r['step_mvox_s']:.3f} Mvoxels/s, loss {r['loss']:.4f}), "
          f"inference {r['infer_ms']:.1f} ms ({r['infer_mvox_s']:.3f} Mvoxels/s), peak "
          f"{peak:.2f} GiB")
    return dict(r, peak_gib=peak)


def bench_tools_phase(dev, card):
    """Phase 17: the six bench tools on the card, as one main path whose
    launches are counted from 0 (the in-process tools' counters, plus the
    launches the bench and bench_scaling children report), after kernels
    1-5 are held against their plain versions on the tools' views
    (bench_path_kernels)."""
    import torch

    from semantic_gaussians_torch.tools import bench_amg, bench_components, bench_eval
    from semantic_gaussians_torch.tools import bench_scaling

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    checked, check_s = bench_path_kernels(dev)
    children = {}

    def add(launches):
        for k, v in launches.items():
            children[k] = children.get(k, 0) + v

    def run():
        out = {"bench": {}}
        for label, args in BENCH_RUNS:
            out["bench"][label], launches = run_bench(label, args, card)
            add(launches)
        out["bench_components"] = bench_components.main([])
        if out["bench_components"]["overflow"]:
            fail(f"bench_components: overflow {out['bench_components']}")
        out["bench_eval"] = {k: (v if k == "speedup" else {
            m: x for m, x in v.items() if m != "confusion"})
            for k, v in bench_eval.main([]).items()}
        out["bench_amg"] = bench_amg.main([])
        out["bench_distill"] = distill_bench(dev)
        torch.cuda.empty_cache()
        scaling = bench_scaling.main([])
        if [r["devices"] for r in scaling["rows"]] != [1]:
            fail(f"bench_scaling: rows {scaling['rows']}")
        add(scaling["launches"])
        out["bench_scaling"] = scaling["rows"]
        return out

    out, launches = count_launches("bench tools", run,
                                   ("expand", "composite_fwd", "composite_bwd", "segsum"))
    for k, v in children.items():
        launches[k] = launches.get(k, 0) + v
    wall = time.perf_counter() - t0
    print(json.dumps({"card": card, "phase17": dict(
        wall_s=wall, launches=launches, child_launches=children, kernel_checks=checked,
        kernel_check_s=check_s,
        cut=f"bench_distill {DISTILL_CUT}", **out)}, default=str))
    print(f"phase 17 (bench tools): {wall:.1f} s; launches {launches}")
    errors = {}
    for errs in checked.values():
        for what, err in errs.items():
            kernel = what.split(" ")[0]
            errors[kernel] = max(errors.get(kernel, 0.0), err)
    return dict(out, launches=launches, errors=errors, wall_s=wall)


# ------------------------------------------------------------------ phase 18
SCANNET_SCENE = "scene0000_00"
SENS_FRAMES = 120  # a ScanNet scene holds thousands
SENS_COLOR, SENS_DEPTH = (1296, 968), (640, 480)  # ScanNet's two cameras (width, height)
SENS_SKIP = 5  # the reader's default frame_skip: frames 0, 5, ..., 115 exported
SENS_LOST = 35  # its pose is all -inf, as ScanNet marks lost tracking (an exported frame)
# The sweep's radius. The class cones are cut from one viewpoint, so the
# labels a view sees agree with the fused features near it: on an H100, mode
# 2d (C = K + 1 / 768) read mIoU 0.872 / 0.874 from a full ring around the
# target, 0.894 / 0.864 from a 60-degree arc of it, 0.941 / 0.935 from this
# sweep (PERF.md section 6).
SENS_SWEEP = 1.0
# Raw label ids: cone c of class_cones is raw id SENS_RAW[c], above 255 as
# most of ScanNet's are. The TSV maps the cones but SENS_UNMAPPED to the
# classes of the port's ScanNet-20 label set (19 names) in order; that
# cone's raw id and raw 0 (unannotated, where no Gaussian covers a pixel)
# are unmapped and read as unlabeled.
SENS_RAW = tuple(300 + 41 * c for c in range(20))
SENS_UNMAPPED = 7
SCANNET_VISITED_FLOOR = 0.15  # measured 0.177 on this capture (17,721 of 100,000)


def render_full(cam, params, **kw):
    """render() with a pair budget that holds every pair: at the default
    budget first, again at tuned_pair_budget of the full count if pairs
    were dropped. Returns (render's dict, the full pair count)."""
    from semantic_gaussians_torch.pipelines.train import tuned_pair_budget
    from semantic_gaussians_torch.renderer import render

    import torch

    with torch.no_grad():
        out = render(cam, params, **kw)
        total = int(out["num_pairs"]) + int(out["overflow"])
        if int(out["overflow"]):
            out = render(cam, params, pair_budget=tuned_pair_budget(total), **kw)
    return out, total


def sens_rig():
    """The capture's rig: a handheld sweep of SENS_FRAMES frames, the sensor
    on a circle of radius SENS_SWEEP (SENS_SWEEP x 0.6 vertically) around
    the first ring camera's position, (0, 0.9, -2), where class_cones cut
    the classes from, each frame facing the target's centre (0, 0, 4). The
    poses are OpenCV camera-to-world (x right, y down, z forward), as
    ScanNet stores them. The fov is phase 7's (vertical 1.1 rad) at the
    colour camera's aspect, and the depth camera takes the same fov:
    `fusion.depth: image` only resizes the depth PNG onto the colour grid,
    as the reference does, so a fov of its own would put that method's
    error into the fused set. Returns (poses, fov_x, fov_y, {camera: 4x4
    intrinsic with the principal point at the image centre})."""
    import math

    import numpy as np

    centre = np.array([0.0, 0.0, 4.0])
    poses = []
    for i in range(SENS_FRAMES):
        th = 2 * np.pi * i / SENS_FRAMES
        pos = np.array([SENS_SWEEP * np.cos(th), 0.15 * TRAIN_RADIUS
                        + 0.6 * SENS_SWEEP * np.sin(th), -2.0])
        fwd = (centre - pos) / np.linalg.norm(centre - pos)
        right = np.cross(np.array([0.0, 1.0, 0.0]), fwd)
        right /= np.linalg.norm(right)
        c2w = np.eye(4)
        c2w[:3, :3] = np.stack([right, np.cross(fwd, right), fwd], axis=1)
        c2w[:3, 3] = pos
        poses.append(c2w)
    fov_y = 1.1
    fov_x = 2 * math.atan(math.tan(fov_y / 2) * SENS_COLOR[0] / SENS_COLOR[1])
    intrinsics = {}
    for name, (w, h) in (("color", SENS_COLOR), ("depth", SENS_DEPTH)):
        k = np.eye(4, dtype=np.float32)
        k[0, 0], k[1, 1] = w / 2 / math.tan(fov_x / 2), h / 2 / math.tan(fov_y / 2)
        k[0, 2], k[1, 2] = w / 2, h / 2
        intrinsics[name] = k
    return poses, fov_x, fov_y, intrinsics


def cone_train_ids():
    """ScanNet-20 train id of each class cone, -1 for SENS_UNMAPPED."""
    import numpy as np

    return np.array([-1 if c == SENS_UNMAPPED else c - (c > SENS_UNMAPPED)
                     for c in range(len(SENS_RAW))])


def write_sens(scan, arrays, model, dev):
    """A ScanNet download of one scene, written as ScanNet ships it:
    `<scan>/<scene>.sens` (v4: SENS_FRAMES frames of sens_rig's sweep;
    colour at 1296x968 rendered by the port from the 100k target, JPEG
    (`color_compression` 2); depth at 640x480 in millimetres (`depth_shift`
    1000), the median depth of `model` (the near-opaque target the fusion
    phase fuses onto: the surface a depth sensor sees), 0 where the render's
    final T > 0.5, as `zlib_ushort` (1); frame SENS_LOST's pose all -inf),
    `<scan>/<scene>_2d-label-filt.zip` (label-filt/<i>.png for every frame,
    16-bit at 1296x968: the exported frames' raw ids rendered from the
    Gaussians' class cones, a constant unannotated image for the others)
    and the scannetv2-labels TSV beside them. Returns {exported frame:
    depth [480, 640] uint16}."""
    import io
    import struct
    import zipfile

    import numpy as np
    import torch
    from PIL import Image

    from semantic_gaussians_torch.core.gaussians import params_from_numpy
    from semantic_gaussians_torch.utils.camera import make_camera

    params, alive, cls = model
    target = params_from_numpy(arrays, dev)
    poses, fov_x, fov_y, intr = sens_rig()
    onehot = torch.eye(len(SENS_RAW) + 1, device=dev)[cls + 1] * alive[:, None]
    raw_of = np.array(SENS_RAW + (0,), np.uint16)  # the last: no Gaussian (unannotated)
    scan.mkdir(parents=True)
    depths = {}
    blank = io.BytesIO()
    Image.fromarray(np.zeros(SENS_COLOR[::-1], np.uint16)).save(blank, format="PNG")
    with open(scan / f"{SCANNET_SCENE}.sens", "wb") as f, zipfile.ZipFile(
            scan / f"{SCANNET_SCENE}_2d-label-filt.zip", "w") as zf:
        name = b"StructureSensor"
        f.write(struct.pack("<IQ", 4, len(name)) + name)
        for m in (intr["color"], np.eye(4), intr["depth"], np.eye(4)):
            f.write(np.asarray(m, "<f4").tobytes())
        f.write(struct.pack("<ii4IfQ", 2, 1, *SENS_COLOR, *SENS_DEPTH, 1000.0, SENS_FRAMES))
        for i, c2w in enumerate(poses):
            w2c = np.linalg.inv(c2w)
            cam_c, cam_d = (make_camera(w2c[:3, :3].T, w2c[:3, 3], fov_x, fov_y, w, h,
                                        device=dev) for w, h in (SENS_COLOR, SENS_DEPTH))
            rgb, _ = render_full(cam_c, target, bg=torch.zeros(3, device=dev))
            rgb = (torch.clamp(rgb["render"], 0, 1) * 255 + 0.5).to(torch.uint8).cpu().numpy()
            jpg = io.BytesIO()
            Image.fromarray(rgb).save(jpg, format="JPEG", quality=90)
            d, _ = render_full(cam_d, params, alive=alive)
            mm = torch.where(d["final_T"] > 0.5, 0.0, torch.round(d["depth"] * 1000.0))
            depth = mm.clamp(0, 65535).to(torch.int32).cpu().numpy().astype(np.uint16)
            payload = zlib.compress(depth.tobytes())
            pose = np.full((4, 4), -np.inf) if i == SENS_LOST else c2w
            f.write(np.asarray(pose, "<f4").tobytes() + struct.pack(
                "<4Q", 33_333 * i, 33_333 * i + 11, len(jpg.getvalue()), len(payload)))
            f.write(jpg.getvalue() + payload)
            label = blank
            if i % SENS_SKIP == 0:
                depths[i] = depth
                lab, _ = render_full(cam_c, params, alive=alive, override_color=onehot)
                ids = torch.argmax(lab["render"], dim=-1)  # 0: no Gaussian; c + 1: cone c
                raw = raw_of[(ids - 1).remainder(len(SENS_RAW) + 1).cpu().numpy()]
                label = io.BytesIO()
                Image.fromarray(raw).save(label, format="PNG")
            zf.writestr(f"label-filt/{i}.png", label.getvalue())
    train_id = cone_train_ids()
    rows = ["id\traw_category\tscannetid\tcocomapid"] + [
        f"{SENS_RAW[c]}\tcone{c}\t{t}\t{t}" for c, t in enumerate(train_id) if t >= 0]
    (scan / "scannetv2-labels.modified.tsv").write_text("\n".join(rows) + "\n")
    return depths


def scannet_phase(tmpdir, arrays, fused, dev, card):
    """Phase 18: the ScanNet path at ScanNet's widths, its launches counted
    from 0 over each CLI run: write_sens's download; (a) the port's
    `.sens` reader at its defaults (24 frames at 648x484); (b) the port's
    label-filt extractor (24 labels of the zip's 120); (c) the train CLI on
    the export, 100 steps from the loader's own random init (no
    points3d.ply), with phase 7's checks and its graphed step timed, and
    kernels 1-5 held against their plain versions on its first training
    view at the initial state; (d) the fusion CLI
    with `fusion.depth=image` on the near-opaque target (the fusion
    phase's model) from 648x484x768 float16 maps of the ScanNet-20 palette,
    chunked and view by view (.pt bit for bit), then with `depth=render`
    (Jaccard of the visited sets); (e) the eval CLI in mode 2d with
    `scene.dataset_name=scannet20` against label-filt through the TSV, at
    C = K + 1 and 768. Returns the launches and the steps' walls."""
    import numpy as np
    import torch
    from PIL import Image

    from semantic_gaussians_torch.cli import eval_segmentation as eval_cli
    from semantic_gaussians_torch.cli import fusion as fusion_cli
    from semantic_gaussians_torch.cli import train as train_cli
    from semantic_gaussians_torch.config.config import default_config_dir
    from semantic_gaussians_torch.data.scannet_constants import SCANNET20_CLASS_LABELS
    from semantic_gaussians_torch.io.scene import load_scene, realize_camera
    from semantic_gaussians_torch.models.predictors import RandomFeatureProvider
    from semantic_gaussians_torch.pipelines.eval_segmentation import text_feature_matrix
    from semantic_gaussians_torch.pipelines.fusion import load_fused_features
    from semantic_gaussians_torch.pipelines.train import (
        TrainConfig, init_train_state, tuned_pair_budget,
    )
    from semantic_gaussians_torch.renderer import render_chn
    from semantic_gaussians_torch.tools import scannet_sens_reader, unzip_label_filt
    from semantic_gaussians_torch.utils.losses import psnr

    t_phase = time.perf_counter()
    params, alive, cls = fused["state"][:3]
    n = len(arrays["means"])
    walls, launches = {}, {}
    device = ["--device", dev.type]

    def counted(name, run, must):
        out, got = count_launches(f"scannet {name}", run, must)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        return out, got

    # -- the download
    t0 = time.perf_counter()
    scans, export = tmpdir / "scans", tmpdir / "scannet" / SCANNET_SCENE
    depths = write_sens(scans / SCANNET_SCENE, arrays, (params, alive, cls), dev)
    walls["capture"] = time.perf_counter() - t0
    size_mb = (scans / SCANNET_SCENE / f"{SCANNET_SCENE}.sens").stat().st_size / 2**20
    print(f"scannet capture: {SENS_FRAMES} frames, colour {SENS_COLOR}, depth {SENS_DEPTH}, "
          f".sens {size_mb:.1f} MiB, label zip + TSV, in {walls['capture']:.1f} s")

    # -- (a) export
    t0 = time.perf_counter()
    sens = scannet_sens_reader.main(["--input_path", str(scans / SCANNET_SCENE),
                                     "--output_path", str(export)])
    walls["export"] = time.perf_counter() - t0
    frames = list(range(0, SENS_FRAMES, SENS_SKIP))
    for sub, ext in (("color", "jpg"), ("depth", "png"), ("pose", "txt")):
        names = sorted(p.name for p in (export / sub).iterdir())
        if names != sorted(f"{i}.{ext}" for i in frames):
            fail(f"scannet export: {sub}/ holds {len(names)} files, not frames {frames}")
    for i in frames:
        jpg, png = Image.open(export / "color" / f"{i}.jpg"), Image.open(export / "depth" / f"{i}.png")
        if jpg.size != (FUSE_W, FUSE_H) or png.size != (FUSE_W, FUSE_H) or png.mode != "I;16":
            fail(f"scannet export frame {i}: colour {jpg.size}, depth {png.size} {png.mode}")
        want = np.asarray(Image.fromarray(depths[i].astype(np.int32)).resize(
            (FUSE_W, FUSE_H), Image.NEAREST)).astype(np.uint16)
        if not np.array_equal(np.asarray(png), want):
            fail(f"scannet export: depth/{i}.png is not the capture's depth resized")
    print(f"(a) export: {len(sens.frames)} frames read, {len(frames)} exported at "
          f"{FUSE_W}x{FUSE_H} (16-bit depth equal to the capture's, resized with nearest) in "
          f"{walls['export']:.1f} s")

    # -- (b) labels
    t0 = time.perf_counter()
    extracted = unzip_label_filt.main(["--label_root", str(scans),
                                       "--extract_root", str(export.parent)])
    shutil.copy(scans / SCANNET_SCENE / "scannetv2-labels.modified.tsv", export)
    walls["labels"] = time.perf_counter() - t0
    labels = sorted(p.name for p in (export / "label-filt").iterdir())
    if extracted != {SCANNET_SCENE: len(frames)} or labels != sorted(f"{i}.png" for i in frames):
        fail(f"scannet labels: extracted {extracted}, label-filt/ holds {len(labels)}")
    print(f"(b) labels: {len(labels)} label PNGs of the zip's {SENS_FRAMES} in "
          f"{walls['labels']:.2f} s")

    # -- (c) training
    t0 = time.perf_counter()
    if (export / "points3d.ply").exists():
        fail("the export holds a points3d.ply: the loader's random init would not run")
    yaml = default_config_dir() / "official_train.yaml"
    summary, train_launches = counted("train", lambda: train_cli.main([
        str(yaml), f"scene.scene_path={export}", f"train.out_dir={tmpdir / 'scannet_train'}",
        f"train.iterations={TRAIN_ITERS}", f"train.test_iterations=[0,{TRAIN_ITERS}]",
        "train.save_iterations=[]", "train.densify_from_iter=20",
        "train.densification_interval=20", f"train.densify_until_iter={TRAIN_ITERS}",
        "train.random_background=false", *device]),
        ("expand", "composite_fwd", "composite_bwd", "segsum"))
    train_s = time.perf_counter() - t0
    log = summary["logs"][0]
    if not torch.isfinite(log["loss"]).all():
        fail("scannet training: a loss is not finite")
    if not log["densify"] or all(a == n for _, a, _ in log["densify"]):
        fail(f"scannet training: densify did not change the alive count: {log['densify']}")
    if int(log["overflow"][-1]) != 0:
        fail(f"scannet training: the last step overflowed its budget {log['budget'][-1]}")
    info, cam0, params0, alive0 = training_view(export, dev)
    cams = [cam0] + [realize_camera(c, device=dev) for c in info.train_cameras[1:8]]
    bg = torch.zeros(3, device=dev)

    def view_psnr(p, a):
        outs = [render_full(c, p, alive=a, bg=bg) for c in cams]
        return float(np.mean([float(psnr(o["render"], c.image)) for (o, _), c in
                              zip(outs, cams)])), outs[0][1]

    (psnr0, pairs0), (psnr1, _) = view_psnr(params0, alive0), view_psnr(
        summary["state"].params, summary["state"].alive)
    if not psnr1 >= psnr0 + 1.0:
        fail(f"scannet training: train-view PSNR rose {psnr1 - psnr0:.3f} dB, less than 1 dB")
    errs = check_path_kernels("scannet training view", params0, alive0, cam0,
                              tuned_pair_budget(pairs0), {3: None}, backward=True)
    graphed = time_graphed_training(
        export, TrainConfig(spatial_lr_scale=float(info.nerf_normalization["radius"])),
        max(log["budget"]), dev)
    walls["train"] = time.perf_counter() - t0
    (_, test0), (_, test1) = summary["tests"][0], summary["tests"][TRAIN_ITERS]
    print(f"(c) training: {len(info.train_cameras)} train / {len(info.test_cameras)} test "
          f"cameras (frame {SENS_LOST} skipped), init {len(info.points)} random points; "
          f"{TRAIN_ITERS} steps through the train CLI in {train_s:.1f} s; train-view PSNR "
          f"{psnr0:.3f} -> {psnr1:.3f} dB (held-out {test0:.3f} -> {test1:.3f}); densify "
          f"{log['densify']}; budgets {sorted(set(log['budget']))}; first training view "
          f"{pairs0} pairs at {cam0.width}x{cam0.height}; graphed step "
          f"{graphed['step_ms']:.3f} ms; launches {train_launches}; {walls['train']:.1f} s")

    # -- (d) fusion
    t0 = time.perf_counter()
    text = text_feature_matrix(RandomFeatureProvider(FEAT_DIM), SCANNET20_CLASS_LABELS)
    train_id = torch.from_numpy(cone_train_ids()).to(dev)[cls]
    palette = (torch.from_numpy(text).to(dev)[train_id + 1] * alive[:, None]).contiguous()
    infos = load_scene(export, eval_split=False).train_cameras
    feature_dir, out = tmpdir / "scannet_feats", tmpdir / "scannet_fused"
    feature_dir.mkdir()
    fused_views = infos[::5]  # the YAML's every_k_views
    with torch.no_grad():
        for ci in fused_views:
            cam = realize_camera(ci, with_image=False).resized(FUSE_W, FUSE_H).to(dev)
            fmap = render_chn(cam, params, palette, alive=alive)["render"]
            np.save(feature_dir / f"{ci.image_name}.npy", fmap.to(torch.float16).cpu().numpy())
    del fmap
    maps_s = time.perf_counter() - t0
    base = [str(default_config_dir() / "fusion_scannet.yaml"), f"scene.scene_path={export}",
            f"model.model_dir={fused['model_dir']}", "fusion.model_2d=precomputed",
            f"fusion.feature_dir={feature_dir}", f"fusion.embedding_dim={FEAT_DIM}",
            "fusion.feat_dtype=float16", f"fusion.visibility_threshold={VISIBILITY}", *device]
    runs = {}
    for name, extra, must in (
            ("image", ["fusion.depth=image", "fusion.chunk_views=4"], ()),
            ("image_per_view", ["fusion.depth=image", "fusion.chunk_views=1"], ()),
            ("render", ["fusion.depth=render", "fusion.chunk_views=4"],
             ("expand", "composite_fwd"))):
        t1 = time.perf_counter()
        res, got = counted(f"fusion {name}", lambda extra=extra, name=name: fusion_cli.main(
            base + extra + [f"fusion.out_dir={out / name}"]), must)
        runs[name] = dict(summary=res, launches=got, s=time.perf_counter() - t1)
    if runs["image"]["launches"]["expand"] or runs["image"]["summary"]["views"] != 5:
        fail(f"scannet fusion depth=image: {runs['image']}")
    renders = fusion_depth_renders(len(fused_views), FEAT_DIM)
    if runs["render"]["launches"]["expand"] != renders:
        fail(f"scannet fusion depth=render launched expand "
             f"{runs['render']['launches']['expand']} times for {renders} depth renders")
    got, want = (torch.load(runs[k]["summary"]["out_path"], weights_only=True)
                 for k in ("image", "image_per_view"))
    if not (torch.equal(got["feat"], want["feat"])
            and torch.equal(got["mask_full"], want["mask_full"])):
        fail("scannet fusion depth=image: the chunked CLI's .pt differs from the per-view one")
    feats, visited = load_fused_features(runs["image"]["summary"]["out_path"],
                                         capacity=params.capacity, device=dev)
    _, visited_render = load_fused_features(runs["render"]["summary"]["out_path"],
                                            capacity=params.capacity, device=dev)
    share = int(visited.sum()) / n
    cos = torch.nn.functional.cosine_similarity(feats[visited], palette[visited], dim=-1)
    jaccard = int((visited & visited_render).sum()) / max(int((visited | visited_render).sum()), 1)
    walls["fusion"] = time.perf_counter() - t0
    print(f"(d) fusion: {len(fused_views)} views, depth=image chunked {runs['image']['s']:.1f} s "
          f"/ view by view {runs['image_per_view']['s']:.1f} s (.pt bit for bit), depth=render "
          f"{runs['render']['s']:.1f} s; visited {int(visited.sum())} of {n} (share "
          f"{share:.4f}), mean cosine {float(cos.mean()):.4f}; Jaccard with depth=render "
          f"{jaccard:.4f} ({int(visited_render.sum())} visited); maps {maps_s:.1f} s; "
          f"{walls['fusion']:.1f} s")
    if share < SCANNET_VISITED_FLOOR:
        fail(f"scannet fusion: visited share {share:.4f} below {SCANNET_VISITED_FLOOR}")
    if not torch.isfinite(feats).all() or float(cos.mean()) < 0.9:
        fail(f"scannet fusion: mean cosine against the palette {float(cos.mean()):.4f} < 0.9")
    if jaccard < 0.9:
        fail(f"scannet fusion: Jaccard of depth=image and depth=render {jaccard:.4f} < 0.9")
    for p in feature_dir.iterdir():
        p.unlink()

    # -- (e) evaluation
    t0 = time.perf_counter()
    k = len(SCANNET20_CLASS_LABELS)
    ev = [str(default_config_dir() / "eval.yaml"), f"scene.scene_path={export}",
          f"model.model_dir={fused['model_dir']}", f"fusion.out_dir={out / 'image'}",
          f"fusion.embedding_dim={FEAT_DIM}", "scene.dataset_name=scannet20",
          "eval.eval_mode=2d", f"eval.width={FUSE_W}", f"eval.height={FUSE_H}",
          f"eval.log_file={tmpdir / 'scannet_eval.log'}", *device]
    results, eval_launches = counted("eval", lambda: {
        p3: eval_cli.main(ev + [f"eval.pred_on_3d={p3}"]) for p3 in ("true", "false")},
        ("expand", "composite_fwd"))
    lut = {SENS_RAW[c]: t for c, t in enumerate(cone_train_ids()) if t >= 0}
    evaluated = [ci.image_name for ci in infos[::10]]
    counts = np.zeros(k, np.int64)
    for name in evaluated:
        raw = np.asarray(Image.open(export / "label-filt" / f"{name}.png").resize(
            (FUSE_W, FUSE_H), Image.NEAREST)).astype(np.int64)
        gt = np.array([lut.get(int(r), k) for r in range(int(raw.max()) + 1)])[raw]
        counts += np.bincount(gt.ravel(), minlength=k + 1)[:k]
    walls["eval"] = time.perf_counter() - t0
    miou = {p3: r[0] for p3, r in results.items()}
    print(f"(e) evaluation: {len(evaluated)} views (frames {evaluated}), mode 2d, scannet20 "
          f"(K = {k}): mIoU C={k + 1} {miou['true']:.4f}, C={FEAT_DIM} {miou['false']:.4f}; "
          f"{int(counts.sum())} labelled pixels; launches {eval_launches}; "
          f"{walls['eval']:.1f} s")
    if eval_launches["expand"] != 2 * len(evaluated):
        fail(f"scannet eval launched expand {eval_launches['expand']} times for "
             f"2 x {len(evaluated)} views")
    for p3, (m, _, conf) in results.items():
        if not m >= 0.9:
            fail(f"scannet eval pred_on_3d={p3}: mIoU {m:.4f} < 0.9")
        if not np.array_equal(conf.sum(axis=1), counts):
            fail(f"scannet eval pred_on_3d={p3}: confusion row sums {conf.sum(axis=1)} are not "
                 f"the ground truth's class counts {counts}")
    wall = time.perf_counter() - t_phase
    print(json.dumps({"card": card, "scannet": dict(
        wall_s=wall, walls_s=walls, launches=launches, kernel_errors=errs,
        train=dict(cli_s=train_s, psnr=(psnr0, psnr1), held_out_psnr=(test0, test1),
                   densify=log["densify"], budgets=sorted(set(log["budget"])),
                   first_view_pairs=pairs0, graphed_step_ms=graphed["step_ms"],
                   graphed_busy=graphed["profile"]),
        fusion=dict(visited=int(visited.sum()), share=share, cosine=float(cos.mean()),
                    jaccard=jaccard, cli_s={k: v["s"] for k, v in runs.items()},
                    cli_s_per_view={k: v["s"] / len(fused_views) for k, v in runs.items()}),
        eval=dict(miou=miou, cli_s_per_view=walls["eval"] / (2 * len(evaluated)),
                  labelled=int(counts.sum())))}, default=str))
    print(f"phase 18 (scannet): {wall:.1f} s; launches {launches}")
    errors = {}
    for what, err in errs.items():
        kernel = what.split(" ")[0]
        errors[kernel] = max(errors.get(kernel, 0.0), err)
    return dict(launches=launches, wall_s=wall, errors=errors)


# ------------------------------------------------------------------ projection
# (name, Gaussians, width, height, fov_x, fov_y, SH coefficients held,
# active degree, kind): the two train cells' main path (1M at the ScanNet
# export's 648x484 and fov, 5M at 1080p), a feature render at C = 768 and
# the viewer's world_rotate (cov3d_precomp) at 1M, and small cases of the
# kernel's other SH layouts (degree below the coefficients held; 27 and 75
# floats a row take the 4-byte staging; 3 floats).
PROJECTION_CASES = (
    ("scannet.train", 1_000_000, 648, 484, 1.0110, 0.7848, 16, 3, "sh"),
    ("garden.train", 5_000_000, 1920, 1080, 1.2, 0.72, 16, 3, "sh"),
    ("eval C=768", 1_000_000, 648, 484, 1.0110, 0.7848, 0, 3, "override"),
    ("world_rotate", 1_000_000, 640, 480, 1.1, 0.86, 16, 3, "world_rotate"),
    ("degree 1 of 3", 100_000, 640, 480, 1.1, 0.86, 16, 1, "sh"),
    ("K=9 degree 2", 100_000, 640, 480, 1.1, 0.86, 9, 2, "sh"),
    ("K=25 degree 4", 100_000, 640, 480, 1.1, 0.86, 25, 4, "sh"),
    ("K=1 degree 0", 100_000, 640, 480, 1.1, 0.86, 1, 0, "sh"),
)
PROJECTION_OVERRIDE_C = 768
PROJECTION_ZERO_ROWS = 0.4  # share of rows whose cotangents are all zero


def projection_inputs(case, dev):
    """One case's leaves (float32 on `dev`, requiring grad), the keyword
    arguments project_gaussians takes beside them, and its camera: Gaussians
    around 4 units in front of a slightly turned camera, 5% behind it and 2%
    dead, random rotations, anisotropic scales and every SH coefficient
    nonzero."""
    import math

    import numpy as np
    import torch

    from semantic_gaussians_torch.utils.camera import make_camera
    from semantic_gaussians_torch.utils.transforms import build_covariance_3d, strip_symmetric

    name, n, w, h, fov_x, fov_y, k, deg, kind = case
    rng = np.random.default_rng(SEED + n + k)
    means = rng.normal(size=(n, 3)) * np.array([2.0, 1.5, 1.5]) + np.array([0.0, 0.0, 4.0])
    means[: n // 20, 2] = rng.uniform(-2.0, 0.2, size=n // 20)
    a = 0.2
    R = np.array([[math.cos(a), 0, math.sin(a)], [0, 1, 0], [-math.sin(a), 0, math.cos(a)]])
    cam = make_camera(R, np.array([0.1, -0.2, 0.3]), fov_x, fov_y, w, h, device=dev)

    def t(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(dev)

    leaves = dict(means=t(means), scales=t(np.exp(rng.uniform(-5.0, -2.0, size=(n, 3)))),
                  quats=t(rng.normal(size=(n, 4))),
                  opacities=t(1.0 / (1.0 + np.exp(-rng.uniform(-3.0, 3.0, size=n)))))
    kw = dict(sh_degree=deg, alive=t(rng.uniform(size=n)) > 0.02)
    if kind == "override":
        leaves["override_color"] = t(rng.uniform(size=(n, PROJECTION_OVERRIDE_C)))
    else:
        sh = rng.normal(size=(n, k, 3)) * 0.3
        sh[:, 0] = rng.normal(size=(n, 3))
        leaves["sh_coeffs"] = t(sh)
    if kind == "world_rotate":
        rot = t(R.T)
        leaves["means"] = leaves["means"] @ rot
        cov = build_covariance_3d(leaves.pop("scales") * 0.8, leaves.pop("quats"))
        leaves["cov3d_precomp"] = strip_symmetric(rot.T @ cov @ rot)
        kw["scaling_modifier"] = 0.8
    else:
        leaves["mean2d_offset"] = torch.zeros((n, 2), device=dev)
    for v in leaves.values():
        v.requires_grad_(True)
    return leaves, kw, cam


def projection_call(fn, leaves, kw, cam, dtype=None):
    """fn (project_gaussians or the plain forward) on the leaves, cast to
    `dtype` where given; returns (ProjectedGaussians, the leaves used)."""
    import torch

    from semantic_gaussians_torch.ops.projection import project_forward_plain

    if dtype is not None:
        leaves = {k: v.detach().to(dtype).requires_grad_(True) for k, v in leaves.items()}
    wv, fp, cc = (x.to(dtype or torch.float32) for x in (cam.world_view, cam.full_proj,
                                                          cam.camera_center))
    full = dict(leaves)
    scales = full.pop("scales", None)
    quats = full.pop("quats", None)
    means, opac = full.pop("means"), full.pop("opacities")
    if fn is project_forward_plain:
        out = fn(means, scales, quats, opac, wv, fp, cc, projection_frame(cam, kw),
                 alive=kw["alive"], **full)
    else:
        out = fn(means, scales, quats, opac, wv, fp, cc, cam.width, cam.height,
                 cam.tan_half_fov_x, cam.tan_half_fov_y, **full, **kw)
    return out, leaves


def projection_frame(cam, kw):
    """The projection's scalars for `cam` and a case's keyword arguments."""
    from semantic_gaussians_torch.ops.projection import Frame

    return Frame(cam.width, cam.height, cam.tan_half_fov_x, cam.tan_half_fov_y,
                 kw["sh_degree"], kw.get("scaling_modifier", 1.0))


PROJECTION_FLOATS = ("means2d", "depths", "conics", "opacities", "colors", "cull_ellipse")
PROJECTION_GRAD_OUTS = ("means2d", "depths", "conics", "opacities", "colors")


def projection_cotangents(proj, seed):
    """Random cotangents of the differentiable outputs, all zero on a
    PROJECTION_ZERO_ROWS share of the rows (Gaussians without pairs)."""
    import torch

    gen = torch.Generator(proj.means2d.device).manual_seed(seed)
    n = proj.means2d.shape[0]
    live = torch.rand(n, generator=gen, device=proj.means2d.device) >= PROJECTION_ZERO_ROWS
    out = []
    for f in PROJECTION_GRAD_OUTS:
        x = getattr(proj, f)
        g = torch.randn(x.shape, generator=gen, device=x.device)
        out.append(g * (live if x.dim() == 1 else live[:, None]))
    return out, live


def projection_bytes(n, k, c, kind, active, shade):
    """(forward, backward) bytes the kernels need: inputs read once,
    outputs written once; the backward reads the cotangents of every
    Gaussian and the inputs of the `active` ones (the SH rows of the
    `shade` ones, whose colour cotangent is nonzero)."""
    shape = 24 if kind == "world_rotate" else 28  # cov6, or scales + quats
    sh = 12 * k
    offset = 8 if kind != "world_rotate" else 0
    fwd = n * (12 + shape + 4 + sh + 1 + offset) + n * (4 * 13 + 12 - (12 if k == 0 else 0))
    cots = n * 4 * (7 + (3 if k else 0))
    bwd = cots + active * (12 + shape + 1) + shade * sh + n * (12 + shape + 4 + sh)
    return fwd, bwd


def check_projection_case(case, dev):
    """The kernels against the plain version on one case: forward floats
    finite and at rtol 1e-5 (atol 1e-6 x the column's largest |value|),
    widened by twice the plain version's own distance to its float64 run
    (entries whose rounding a cancellation amplifies: the two sum in other
    orders; `widened` counts them), and for the conic and the cull
    quadratic by 8 ulps of the conic's condition (|ac| + b^2) / |det|.
    Every entry of a Gaussian that either version draws (radius > 0) lies
    inside that; outside it (`outside`) only entries of Gaussians both
    cull, on at most 1e-5 of a field's entries (at the camera plane, |p_w|
    near 1e-6). Radii within 1 on at most 1e-4 of the Gaussians (ceil
    ties). The backward's gradients, per leaf, no further from float64
    autograd of the plain forward (norm-relative, over all rows and over
    the drawn rows alone) than twice the float32 autograd's own gap, and
    no further from the hand backward (project_backward_plain, float32 on
    the card, the kernel's order of operations but for cuBLAS's and
    torch's sums) than twice the hand backward's own gap; exact zeros
    where every cotangent is zero, the offset's gradient the means2d
    cotangent itself; then times against the byte bounds."""
    import torch

    from semantic_gaussians_torch.ops import projection

    name, n, _, _, _, _, k, _, kind = case
    leaves, kw, cam = projection_inputs(case, dev)
    kproj, _ = projection_call(projection.project_gaussians, leaves, kw, cam)
    pproj, _ = projection_call(projection.project_forward_plain, leaves, kw, cam)
    proj64, leaves64 = projection_call(projection.project_forward_plain, leaves, kw, cam,
                                       torch.float64)
    culled = (kproj.radii == 0) & (pproj.radii == 0)
    # the conic inverts a 2x2 covariance: det = ac - b^2 amplifies the
    # relative rounding of a, b and c by (|ac| + b^2) / |det|, the same for
    # the conic itself; capped at 2^24, where float32 keeps no bit
    A, B, C = proj64.conics.detach().unbind(-1)
    cond = ((A * C).abs() + B * B) / (A * C - B * B).abs()
    cond = torch.nan_to_num(cond, nan=2.0**24).clamp(max=2.0**24)[:, None]
    widened, outside = {}, {}
    for f in PROJECTION_FLOATS:
        got, want = getattr(kproj, f).detach(), getattr(pproj, f).detach()
        if not bool(torch.isfinite(got).all()):
            fail(f"projection {name}: {f} is not finite")
        bound = 1e-5 * want.abs() + 1e-6 * want.abs().amax(dim=0, keepdim=True)
        own = 2.0 * (want.double() - getattr(proj64, f).detach()).abs()
        if f in ("conics", "cull_ellipse"):
            own = own + 8.0 * 2.0**-24 * cond * want.double().abs()
        diff = (got - want).abs()
        widened[f] = int((diff > bound).sum())
        out = diff > bound + own.float()
        in_culled = culled if out.dim() == 1 else culled[:, None]
        outside[f] = dict(drawn=int((out & ~in_culled).sum()),
                          culled=int((out & in_culled).sum()))
        if outside[f]["drawn"] or outside[f]["culled"] > 1e-5 * got.numel():
            fail(f"projection {name}: {f}: {outside[f]} of {got.numel()} entries out of "
                 f"tolerance: {close_enough(got, want, 1e-5, 1e-6, slack=own.float())}")
    ties = {}
    for f in ("radii", "radii_xy"):
        got, want = getattr(kproj, f), getattr(pproj, f)
        if got.dtype != torch.int32:
            fail(f"projection {name}: {f} is {got.dtype}")
        diff = (got - want).abs()
        ties[f] = int((diff > 0).sum())
        if int(diff.max()) > 1 or ties[f] > 1e-4 * n:
            fail(f"projection {name}: {f} differs on {ties[f]} of {n} (max {int(diff.max())})")
    if kind == "override" and kproj.colors is not leaves["override_color"]:
        fail(f"projection {name}: the override colour was not passed through")

    cots, live = projection_cotangents(pproj, SEED + 1)
    names = list(leaves)

    def grads(proj, lv):
        return dict(zip(names, torch.autograd.grad(
            [getattr(proj, f) for f in PROJECTION_GRAD_OUTS], [lv[x] for x in names], cots,
            retain_graph=True)))

    before = projection.LAUNCHES.snapshot()
    g_kernel = grads(kproj, leaves)
    launched = {key: v for key, v in projection.LAUNCHES.since(before)[1].items() if v}
    if launched != {"bwd": 1}:
        fail(f"projection {name}: the backward launched {launched}")
    g32 = grads(pproj, leaves)
    g64 = dict(zip(names, torch.autograd.grad(
        [getattr(proj64, f) for f in PROJECTION_GRAD_OUTS], [leaves64[x] for x in names],
        [c.double() for c in cots])))
    del proj64, leaves64
    kargs = [leaves["means"], leaves.get("scales"), leaves.get("quats"), leaves.get("sh_coeffs"),
             leaves.get("cov3d_precomp"), kw["alive"], cam.world_view, cam.full_proj,
             cam.camera_center, projection_frame(cam, kw)]
    kargs = [a.detach() if isinstance(a, torch.Tensor) else a for a in kargs]
    colour_cot = cots[4] if k else None
    hand = dict(zip(("means", "scales", "quats", "opacities", "sh_coeffs", "cov3d_precomp"),
                    projection.project_backward_plain(*kargs, *cots[:4], colour_cot)))
    drawn = pproj.radii > 0

    def norm(a, rows):
        return float((a if rows is None else a[rows]).double().norm())

    gaps = {}
    for x in names:
        ref = g64[x]
        for rows_name, rows in (("all", None), ("drawn", drawn)):
            scale = norm(ref, rows) or 1.0
            gk = norm(g_kernel[x].double() - ref, rows) / scale
            gp = norm(g32[x].double() - ref, rows) / scale
            gaps[f"{x}.{rows_name}"] = dict(kernel=gk, plain=gp)
            if not gk <= 2.0 * gp:
                fail(f"projection {name}: gradient of {x} ({rows_name} rows): kernel gap "
                     f"{gk:.3g} > 2 x plain {gp:.3g}")
            if hand.get(x) is not None:
                gh = norm(hand[x].double() - ref, rows) / scale
                kh = norm(g_kernel[x].double() - hand[x].double(), rows) / scale
                gaps[f"{x}.{rows_name}"].update(hand=gh, kernel_to_hand=kh)
                if not kh <= 2.0 * gh:
                    fail(f"projection {name}: gradient of {x} ({rows_name} rows): kernel to "
                         f"hand backward {kh:.3g} > 2 x the hand backward's gap {gh:.3g}")
        if bool(g_kernel[x][~live].any()) or not bool(torch.isfinite(g_kernel[x]).all()):
            fail(f"projection {name}: gradient of {x} not exact zeros on zero-cotangent rows "
                 "or not finite")
    if "mean2d_offset" in names and not torch.equal(g_kernel["mean2d_offset"], cots[0]):
        fail(f"projection {name}: the offset's gradient is not the means2d cotangent")
    del g32, g64, hand

    # times: the kernels (device_us: graph replays), the plain forward and
    # autograd's backward through it (the layer before the kernels)
    with torch.no_grad():
        fwd_us = device_us(lambda: projection_call(
            projection.project_gaussians, leaves, kw, cam))
        plain_fwd_ms = cuda_ms(lambda: projection_call(
            projection.project_forward_plain, leaves, kw, cam), 5)
    bwd_us = device_us(lambda: projection._project_backward_cuda(
        *kargs, cots[0], cots[1], cots[2], cots[3], colour_cot))
    plain_bwd_ms = cuda_ms(lambda: grads(pproj, leaves), 5)
    shade = int((live & (cots[4].abs().sum(-1) > 0)).sum()) if k else 0
    fb, bb = projection_bytes(n, k, PROJECTION_OVERRIDE_C if kind == "override" else 3, kind,
                              int(live.sum()), shade)
    out = dict(n=n, kind=kind, k=k, fwd_ms=fwd_us / 1e3, bwd_ms=bwd_us / 1e3,
               fwd_bound_ms=fb / PEAK_BYTES * 1e3, bwd_bound_ms=bb / PEAK_BYTES * 1e3,
               fwd_bytes=fb, bwd_bytes=bb, plain_fwd_ms=plain_fwd_ms,
               plain_autograd_bwd_ms=plain_bwd_ms, radius_ties=ties, widened=widened,
               outside=outside, grad_gaps=gaps)
    print(f"projection {name}: {json.dumps(out)}")
    return out


def projection_graph_launches(dev):
    """One forward and one backward launch a train step under a CUDA-graph
    replay: two 10-step train_scan_step chunks at 1M Gaussians (648x484,
    random target images); the second, a replay alone, must count 10 of
    each."""
    import numpy as np
    import torch

    from semantic_gaussians_torch.core.gaussians import GaussianParams
    from semantic_gaussians_torch.ops import projection
    from semantic_gaussians_torch.pipelines.train import (
        TrainConfig, init_train_state, stack_camera_chunk, train_scan_step,
    )
    from semantic_gaussians_torch.utils.graphs import GraphRunner

    case = PROJECTION_CASES[0]
    leaves, kw, cam = projection_inputs(case, dev)
    sh = leaves["sh_coeffs"].detach()
    params = GaussianParams(
        means=leaves["means"].detach(), sh_dc=sh[:, :1].contiguous(),
        sh_rest=sh[:, 1:].contiguous(), log_scales=torch.log(leaves["scales"].detach()),
        quats=leaves["quats"].detach(),
        opacity_logits=torch.logit(leaves["opacities"].detach())[:, None])
    gen = torch.Generator(dev).manual_seed(SEED)
    cams = [dataclasses.replace(cam, image=torch.rand((cam.height, cam.width, 3), generator=gen,
                                                      device=dev)) for _ in range(10)]
    stack = stack_camera_chunk(cams)
    bgs = torch.zeros((10, 3), device=dev)
    state = init_train_state(params, kw["alive"])
    runner = GraphRunner(dev)
    state, _ = train_scan_step(state, stack, bgs, TrainConfig(), 3, runner=runner)
    torch.cuda.synchronize()
    before = projection.LAUNCHES.snapshot()
    state, _ = train_scan_step(state, stack, bgs, TrainConfig(), 3, runner=runner)
    torch.cuda.synchronize()
    got = {key: v for key, v in projection.LAUNCHES.since(before)[1].items() if v}
    if got != {"fwd": 10, "bwd": 10} or runner.replays != 2 or runner.captures != 1:
        fail(f"projection launches over one 10-step replay: {got} "
             f"(captures {runner.captures}, replays {runner.replays})")
    return dict(replay_launches=got, captures=runner.captures, replays=runner.replays)


def projection_phase(dev, card):
    """Phase 19: the projection kernels against the plain version on
    PROJECTION_CASES, their times beside the byte bounds, and the launch
    count under a graph replay."""
    import torch

    t0 = time.perf_counter()
    cases = {}
    for case in PROJECTION_CASES:
        cases[case[0]] = check_projection_case(case, dev)
        torch.cuda.empty_cache()
    graph = projection_graph_launches(dev)
    wall = time.perf_counter() - t0
    print(json.dumps({"card": card, "projection": dict(cases=cases, graph=graph,
                                                       wall_s=wall)}))
    return dict(cases=cases, graph=graph, wall_s=wall)


def projection_only():
    """`python3 chip_smoke.py --projection`: builds the kernels and runs
    phase 19 alone."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    from semantic_gaussians_torch.ops import kernels

    card = card_line()
    print(f"card: {card}")
    print(f"kernels built: {kernels.build_all()}")
    for name, log in kernels.BUILD_LOG.items():
        regs = [l.strip() for l in log.splitlines() if "registers" in l or "spill" in l]
        print(f"  {name}: {regs}")
    projection_phase(torch.device("cuda:0"), card)
    print(card_line())


def segsum_replay_only():
    """`python3 chip_smoke.py --segsum-replay`: builds the segment sum and
    runs check_segsum_replay alone, at the main path's shapes without the
    scene (P = the 100k scene's pair budget, its 100,001 output rows, the
    timed training view's live pairs), for a quick look at a tree's kernel
    (an earlier commit's too: copy this file into its checkout)."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    from semantic_gaussians_torch.ops import kernels
    from semantic_gaussians_torch.ops.binning import default_pair_budget

    print(f"card: {card_line()}")
    kernels.build_all(["segsum"])
    p = default_pair_budget(N_GAUSSIANS)
    shape = (p, N_GAUSSIANS + 1, TRAIN_VIEW_PAIRS)
    print(json.dumps({"segsum_replay": check_segsum_replay(torch.device("cuda:0"), {
        9: shape, 6 + FEAT_DIM: shape})}))


if __name__ == "__main__":
    if sys.argv[1:] == ["--segsum-replay"]:
        segsum_replay_only()
    elif sys.argv[1:] == ["--projection"]:
        projection_only()
    else:
        main()
