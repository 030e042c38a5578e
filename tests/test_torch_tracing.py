"""The port's tracing (utils.tracing): phase markers in stream order and
host spans. CPU tests record the phases asked for; the `card` test reads
the markers from a profiled CUDA-graph replay. This file imports neither
JAX nor the JAX package, so that the card test runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_tracing.py
"""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from semantic_gaussians_torch.core.gaussians import params_from_numpy
from semantic_gaussians_torch.ops import kernels
from semantic_gaussians_torch.pipelines.train import (
    TrainConfig,
    init_train_state,
    stack_camera_chunk,
    train_loop,
    train_scan_step,
    train_step,
)
from semantic_gaussians_torch.utils import tracing
from semantic_gaussians_torch.utils.camera import make_camera
from semantic_gaussians_torch.utils.graphs import GraphRunner
from semantic_gaussians_torch.utils.logging_utils import ChunkClock

STEP = ["project", "bin", "composite", "loss", "loss_bwd", "composite_bwd", "segsum",
        "project_bwd", "update"]
FEATURE_LOSS = ["feat_loss", "feat_loss_bwd"]  # between loss and loss_bwd, with a feature field
# between loss and loss_bwd with Gaussian Grouping: the 3D term's two on its steps alone
GROUPING_LOSS = ["obj_loss", "reg3d", "reg3d_bwd", "obj_loss_bwd"]
W, H = 64, 32
CPU = torch.device("cpu")


def _collapsed(names):
    out = []
    for n in names:
        if not out or out[-1] != n:
            out.append(n)
    return out


def _toy(dev, views=4, n=300, seed=3):
    """A small cloud in front of an arc of cameras with noise images: a
    fresh train state and the cameras, on `dev`."""
    rng = np.random.default_rng(seed)
    arrays = dict(
        means=(rng.normal(size=(n, 3)) * [1.0, 0.4, 0.6] + [0, 0, 4]).astype(np.float32),
        sh_dc=rng.normal(size=(n, 1, 3)).astype(np.float32),
        sh_rest=(rng.normal(size=(n, 15, 3)) * 0.05).astype(np.float32),
        log_scales=rng.uniform(-3.4, -1.6, size=(n, 3)).astype(np.float32),
        quats=rng.normal(size=(n, 4)).astype(np.float32),
        opacity_logits=rng.uniform(-2.0, 3.0, size=(n, 1)).astype(np.float32),
    )
    state = init_train_state(params_from_numpy(arrays, dev),
                             torch.ones(n, dtype=torch.bool, device=dev))
    cams = [make_camera(np.eye(3), np.array([0.2 * (i - views / 2), 0.0, 0.0]), 1.2, 0.9, W, H,
                        image=rng.uniform(size=(H, W, 3)).astype(np.float32),
                        image_name=f"v{i}", device=dev) for i in range(views)]
    return state, cams


CFG = TrainConfig(densify_from_iter=10_000)


def test_phase_names_are_the_marker_kernels():
    assert list(tracing.PHASES) == (STEP[:4] + FEATURE_LOSS + GROUPING_LOSS + STEP[4:]
                                    + ["carry", "between"])
    src = (kernels.CSRC / "phase.cu").read_text()
    for name in tracing.PHASES:
        assert f"  X({name})" in src
    assert "phase" in kernels.SOURCES
    with pytest.raises(KeyError):
        tracing.phase("unknown", CPU)


def test_train_step_records_the_phase_table():
    state, cams = _toy(CPU)
    with tracing.recording() as names:
        train_step(state, cams[0], torch.zeros(3), CFG, 3)
    assert names[:2] == ["project", "project"]  # the step's and render's
    assert _collapsed(names) == STEP


def test_a_feature_step_splits_its_loss_from_the_photometric_one():
    """With a feature field the feature L1 is phase feat_loss, and its
    backward, which autograd runs first, feat_loss_bwd; the photometric
    backward opens loss_bwd where the field's gradient leaves the L1."""
    from semantic_gaussians_torch.core.gaussians import with_feature_field

    state, cams = _toy(CPU)
    d = 36
    params = with_feature_field(state.params, d, torch.full((state.params.capacity, d), 0.1))
    state = init_train_state(params, state.alive)
    cfg = dataclasses.replace(CFG, feature_dim=d)
    with tracing.recording() as names:
        train_step(state, cams[0], torch.zeros(3), cfg, 3, teacher=torch.zeros(H, W, d))
    assert _collapsed(names) == STEP[:4] + FEATURE_LOSS + STEP[4:]


@pytest.mark.parametrize("reg3d", [False, True])
def test_a_grouping_step_splits_its_terms_from_the_photometric_one(reg3d):
    """With Gaussian Grouping the identity terms are phase obj_loss; on a
    step with the 3D term, that term is reg3d, and its backward, which
    autograd runs first, reg3d_bwd; the cross-entropy's backward is
    obj_loss_bwd, and the photometric backward opens loss_bwd where the
    field's gradient leaves the classifier."""
    from semantic_gaussians_torch.core.gaussians import with_feature_field
    from semantic_gaussians_torch.core.grouping import GroupingConfig, init_classifier

    state, cams = _toy(CPU)
    d = 16
    params = with_feature_field(state.params, d, torch.full((state.params.capacity, d), 0.1))
    state = init_train_state(params, state.alive,
                             init_classifier(256, d, torch.Generator().manual_seed(0), CPU))
    cfg = dataclasses.replace(CFG, feature_dim=d,
                              grouping=GroupingConfig(reg3d_max_points=200, reg3d_sample=50))
    with tracing.recording() as names:
        train_step(state, cams[0], torch.zeros(3), cfg, 3,
                   object_ids=torch.zeros((H, W), dtype=torch.uint8), reg3d=reg3d)
    terms = GROUPING_LOSS if reg3d else [GROUPING_LOSS[0], GROUPING_LOSS[-1]]
    assert _collapsed(names) == STEP[:4] + terms + STEP[4:]


def test_train_scan_step_records_each_step_then_the_dispatch():
    state, cams = _toy(CPU)
    k = 3
    with tracing.recording() as names:
        train_scan_step(state, stack_camera_chunk(cams[:k]), torch.zeros((k, 3)), CFG, 3)
    assert _collapsed(names) == STEP * k + ["carry", "between"]


def test_recording_nests_and_ends():
    with tracing.recording() as outer:
        tracing.phase("bin", CPU)
        with tracing.recording() as inner:
            tracing.phase("loss", CPU)
    tracing.phase("update", CPU)
    assert outer == ["bin", "loss"] and inner == ["loss"]


def test_no_marker_is_launched_on_the_cpu(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a marker was launched")

    monkeypatch.setattr(kernels, "load", refuse)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        for name in tracing.PHASES:
            tracing.phase(name, CPU)


def test_span_is_the_shared_no_op_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    a, b = tracing.span("sgt.a"), tracing.span("sgt.b")
    assert a is b
    with a:
        pass

    @tracing.spanned("sgt.c")
    def f(x, y=1):
        return x + y

    assert f(2, y=3) == 5 and f.__name__ == "f"


def test_train_loop_spans_under_a_cpu_profiler():
    """Iterations 999 and 1000 at steps_per_dispatch 1: single eager steps;
    densify, a budget check and a log line at 1000."""
    from torch.profiler import ProfilerActivity, profile

    state, cams = _toy(CPU)
    cfg = TrainConfig(densify_from_iter=500)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, log = train_loop(state, cams, cfg, num_iters=2, iter_offset=998,
                                steps_per_dispatch=1, log_every=5)
    assert log["chunks"] == [(999, 1), (1000, 1)]
    assert [d[0] for d in log["densify"]] == [1000]
    names = {e.name for e in prof.events()}
    for span in ("sgt.train_loop", "sgt.loop.prep", "sgt.loop.budget", "sgt.loop.log",
                 "sgt.loop.densify", "sgt.train_step.eager"):
        assert span in names, span
    assert sum(e.name == "sgt.train_loop" for e in prof.events()) == 1


def test_recording_leaves_results_bit_identical():
    def run(record):
        state, cams = _toy(CPU)
        if record:
            with tracing.recording() as names:
                out = train_loop(state, cams, CFG, num_iters=2, steps_per_dispatch=2)
            assert _collapsed(names) == STEP * 2 + ["carry", "between"]
            return out
        return train_loop(state, cams, CFG, num_iters=2, steps_per_dispatch=2)

    (s0, l0), (s1, l1) = run(False), run(True)
    assert torch.equal(l0["loss"], l1["loss"])
    for f in ("means", "sh_dc", "sh_rest", "log_scales", "quats", "opacity_logits"):
        assert torch.equal(getattr(s0.params, f), getattr(s1.params, f)), f


def test_chunk_clock_on_the_host():
    off = ChunkClock(CPU, on=False)
    with off.chunk(4):
        pass
    assert np.isnan(off.read())
    clock = ChunkClock(CPU)
    assert clock.source == "host" and np.isnan(clock.read())
    with clock.chunk(4):
        sum(range(10_000))
    assert 0.0 < clock.read() < 1.0


@pytest.mark.card
def test_markers_in_profiled_replays_follow_the_phase_table(tmp_path):
    """On the card: a 10-step graph, a 9-step graph and the one-step graph
    at iteration 4000, replayed under torch.profiler. The markers' phases, with
    repeats collapsed, follow the table once a step; every composite
    backward kernel runs inside phase composite_bwd; the loop's and the
    runner's spans are in the trace."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    kernels.build_all()
    dev = torch.device("cuda", torch.cuda.current_device())
    state, cams = _toy(dev, views=10)
    runner = GraphRunner(dev)
    calls = [dict(num_iters=10, iter_offset=3010), dict(num_iters=10, iter_offset=3990)]
    with profile(activities=[ProfilerActivity.CPU]) as cap:
        for kw in calls:  # captures the 10-step, the 9-step and the one-step graphs
            state, log = train_loop(state, cams, CFG, steps_per_dispatch=10, runner=runner,
                                    **kw)
    assert log["chunks"] == [(3991, 9), (4000, 1)] and runner.captures == 3
    assert "sgt.graph.capture" in {e.name for e in cap.events()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for kw in calls:
            state, _ = train_loop(state, cams, CFG, steps_per_dispatch=10, runner=runner,
                                  **kw)
        torch.cuda.synchronize()
    assert runner.captures == 3
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    kern = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"),
                  key=lambda e: float(e["ts"]))
    phases, current, bwd = [], None, 0
    for e in kern:
        if e["name"].startswith("sgt_phase_"):
            current = e["name"][len("sgt_phase_"):]
            phases.append(current)
        elif "composite_bwd_kernel" in e["name"]:
            assert current == "composite_bwd", current
            bwd += 1
    assert bwd >= 20
    want = (STEP * 10 + ["carry", "between"] + STEP * 9 + ["carry", "between"]
            + STEP + ["carry", "between"])
    assert _collapsed(phases) == want
    host = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    for span in ("sgt.train_loop", "sgt.loop.prep", "sgt.loop.log", "sgt.loop.budget",
                 "sgt.graph.fill", "sgt.graph.replay"):
        assert span in host, span


_GROW_AND_RECAPTURE = """
import json, sys, torch
sys.path[:0] = sys.argv[1:3]
from semantic_gaussians_torch.ops import kernels
from semantic_gaussians_torch.pipelines.train import TrainConfig, train_loop
from test_torch_tracing import _toy
kernels.build_all()
state, cams = _toy(torch.device("cuda", 0), views=10)
cfg = TrainConfig(densify_from_iter=5, densification_interval=10, densify_until_iter=15)
state, log = train_loop(state, cams, cfg, num_iters=20, steps_per_dispatch=10)
print(json.dumps(dict(capacity=state.params.capacity, graphs=log["graphs"],
                      densify=log["densify"], finite=bool(torch.isfinite(log["loss"]).all()))))
"""


@pytest.mark.card
def test_a_runner_captures_again_after_growth_drops_every_graph():
    """In a fresh process, whose first capture is the runner's: capacity
    growth at iteration 10 drops the only graph, and the next chunk
    captures at twice the capacity. A block made inside the first capture
    outlives its graph, so the runner must not share that pool again (the
    allocator refuses it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tests = Path(__file__).resolve().parent
    out = subprocess.run([sys.executable, "-c", _GROW_AND_RECAPTURE, str(tests.parent),
                          str(tests)], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["capacity"] == 600 and [d[0] for d in got["densify"]] == [10]
    assert got["graphs"] == dict(captures=2, replays=2) and got["finite"]
