"""The Gaussian Grouping cell (`scannet.train_group16`): the object maps'
ray cast, its operation counts by hand, its four readers on a made-up
record, and whole runs at a tiny size on the CPU: the last line, `correct`
false under each fault and under the bfloat16 control."""
import json
import math
import time

import numpy as np
import pytest

from benchmark.common import phases as P
from benchmark.common.checks import passed
from benchmark.common.manifest import HERE, Cell, import_file, load_manifest
from benchmark.common.trace import Trace
from benchmark.metrics import counts as K
from benchmark.metrics import grouping_counts as GK
from benchmark.run import run_cell
from benchmark.scenes import grouping as SG
from benchmark.scenes.common import look_pose
from benchmark.scenes.room import _boxes
from benchmark.tests.tiny import tiny_cell
from benchmark.tools import grouping_controls

CELL = "scannet.train_group16"
READERS = ("group.identity_loss_ms", "group.reg3d_ms", "group.composite_bwd_roofline",
           "group.mfu")


def _cfg():
    return Cell(CELL, load_manifest()).config


def _at(cfg, eye, fwd):
    """The id at the centre pixel of a camera at `eye` looking along `fwd`."""
    ids = SG.object_map(cfg, look_pose(np.array(eye, float), np.array(fwd, float)), "cpu")
    h, w = ids.shape
    return int(ids[h // 2, w // 2])


def test_object_maps_name_what_each_ray_meets_first():
    cfg = _cfg()
    lx, ly, lz = cfg["room"]["size_m"]
    mid = [lx / 2, ly / 2, 1.4]
    assert _at(cfg, mid, [0.01, 0.0, -1.0]) == SG.FLOOR
    walls = [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]]
    for i, fwd in enumerate(walls):  # level, at head height: above every box
        assert _at(cfg, [lx / 2, ly / 2, 1.9], fwd) == SG.FIRST_WALL + i, i
    assert _at(cfg, mid, [0.01, 0.0, 1.0]) == 0  # no ceiling
    lo, size = _boxes(cfg["room"])
    for b in range(len(lo)):  # straight down onto each box's top face: the tallest box there
        top = lo[b] + size[b] * [0.5, 0.5, 1.0]
        under = [(size[j, 2], j) for j in range(len(lo))
                 if np.all((lo[j, :2] <= top[:2]) & (top[:2] <= lo[j, :2] + size[j, :2]))]
        want = SG.FIRST_BOX + max(under)[1]
        assert _at(cfg, top + [0, 0, 0.5], [0.001, 0.0, -1.0]) == want, b
    cfg = dict(cfg, width=64, height=48)
    from benchmark.scenes.room import train_poses

    poses = train_poses(cfg)
    maps = SG.object_maps(cfg, poses, "cpu", which=[3, 7])
    assert maps.shape == (2, 48, 64) and str(maps.dtype) == "torch.uint8"
    assert int(maps.max()) < SG.FIRST_BOX + len(lo)
    again = SG.object_maps(cfg, poses, "cpu", which=[7])
    assert bool((again[0] == maps[1]).all())  # a view can be made again alone


def test_counts_by_hand():
    c = dict(evaluated=1000, contributing=100, up_to_last=600, dense=10, pairs=50, live=40)
    g = dict(num_classes=256, reg3d_max_points=8, reg3d_sample=3, reg3d_k=5)
    d, ch = 16, 19
    rgb = (3 * 10 * (190 + 150) + 18 * 1000 + 2 * ch * 100 + 18 * 600 + (20 + 4 * ch) * 100
           + 3 * 64 * K.LOSS_PIXEL_OPS + 40 * (6 + ch) + 10 * 59 * 12)
    ident = 6 * 64 * d * 256 + 64 * 256 * 8
    reg3d = 6 * 10 * d * 256 + 10 * 256 * 8 + 3 * 8 * 8 + 3 * 5 * 256 * 10
    adam = (10 * d + 17 * 256) * 12
    assert GK.grouping_step_ops(c, 10, 64, d, g, 0.5) == rgb + ident + 0.5 * reg3d + adam


def _ev(cat, ts, dur, name):
    return dict(ph="X", cat=cat, ts=ts, dur=dur, name=name)


def _record():
    """Two traced steps of 100 us, the second with the 3D term: markers and
    the kernels each reader times."""
    m = lambda ts, ph: _ev("kernel", ts, 1, P.MARKER + ph)  # noqa: E731
    dev = []
    for s, reg3d in ((0, False), (100, True)):
        dev += [m(s, "project"), m(s + 2, "bin"), m(s + 4, "composite"),
                _ev("kernel", s + 5, 4, "composite_fwd_kernel<19>"),
                m(s + 12, "loss"), _ev("kernel", s + 13, 2, "ssim"),
                m(s + 16, "obj_loss"), _ev("kernel", s + 17, 3, "gemm")]
        if reg3d:
            dev += [m(s + 21, "reg3d"), _ev("kernel", s + 22, 8, "topk"),
                    m(s + 31, "reg3d_bwd"), _ev("kernel", s + 32, 6, "softmax_bwd")]
        dev += [m(s + 39, "obj_loss_bwd"), _ev("kernel", s + 40, 4, "ce_bwd"),
                m(s + 45, "loss_bwd"), _ev("kernel", s + 46, 2, "ssim_bwd"),
                m(s + 50, "composite_bwd"), _ev("kernel", s + 51, 20, "composite_bwd_kernel_wide"),
                m(s + 72, "segsum"), _ev("kernel", s + 73, 4, "segsum_kernel"),
                m(s + 80, "update"), _ev("kernel", s + 81, 10, "adam"), m(s + 97, "between")]
    counts = dict(evaluated=4000, contributing=1000, up_to_last=3000, dense=50, pairs=300,
                  live=250)
    g = dict(num_classes=256, lambda_3d=2.0, reg3d_interval=2, reg3d_k=5,
             reg3d_max_points=300000, reg3d_sample=1000, reg3d_steps=1)
    return dict(layer=dict(steps=2, wall_s=200e-6, trace=Trace(dev, window_s=200e-6),
                           counts=counts, gaussians=100, pixels=512, channels=19,
                           num_objects=16, grouping=g))


def _read(name, rec):
    return import_file(HERE / "metrics" / f"{name}.py", "m_" + name.replace(".", "_")).read(rec)


def test_readers_on_a_made_up_record():
    rec = _record()
    c, lay = rec["layer"]["counts"], rec["layer"]
    # busy us over two steps: obj_loss 1 + 3 twice, obj_loss_bwd 1 + 4 twice;
    # reg3d 1 + 8 and reg3d_bwd 1 + 6 once
    assert _read("group.identity_loss_ms", rec) == pytest.approx(0.001 * 18 / 2)
    assert _read("group.reg3d_ms", rec) == pytest.approx(0.001 * 16 / 2)
    assert _read("group.composite_bwd_roofline", rec) == pytest.approx(
        100 * K.composite_bwd_bound_s(c, 19, 512) / 20e-6)
    assert _read("group.mfu", rec) == pytest.approx(
        100 * GK.grouping_step_ops(c, 100, 512, 16, lay["grouping"], 0.5) / 100e-6 / K.PEAK_F32)
    for name in READERS:
        assert _read(name, {}) is None
    rgb = _record()
    rgb["layer"].pop("num_objects")
    for name in READERS[2:]:  # a record without the identity field has nothing to read
        assert _read(name, rgb) is None


def test_manifest_entries():
    m = load_manifest()
    cell = Cell(CELL, m)
    assert cell.chips == 1 and cell.traffic == "train_grouping"
    assert [x["name"] for x in cell.end_to_end()] == ["train_step_ms", "setup_s"]
    assert sorted(x["name"] for x in cell.per_layer()) == sorted(READERS)
    cfg = cell.config
    assert cfg["num_objects"] == 16 and cfg["grouping"]["num_classes"] == 256
    assert cfg["reduced"] == [] and cfg["train"]["pair_budget"] is None
    base = Cell("scannet.train", m).config
    for k in ("law", "num_gaussians", "sh_degree", "width", "height", "fov_x", "fov_y", "views",
              "room"):
        assert cfg[k] == base[k], k
    for k, v in base["train"].items():
        assert cfg["train"][k] == v, k


def _tiny():
    return tiny_cell(CELL)


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_schema(trace):
    r = run_cell(_tiny(), 2**31 + 12345, 2.0, trace, "cpu", time.perf_counter())
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["checks"]) == {"loss_gap", "moment_gap", "change_gap", "knn_flips"}
    assert r["checks"]["knn_flips"]["value"] == 0
    json.dumps(r)
    if trace:  # the CPU has no device events: the step count's share alone
        assert set(r["metrics"]) == {"group.mfu"}
        assert 0 < r["metrics"]["group.mfu"]["value"] <= 100
    else:
        assert set(r["metrics"]) == {"train_step_ms", "setup_s"}
        assert math.isfinite(r["metrics"]["train_step_ms"]["value"])


@pytest.mark.parametrize("fault", list(grouping_controls.FAULTS))
def test_a_fault_reads_incorrect(fault):
    with grouping_controls.FAULTS[fault]():
        r = run_cell(_tiny(), 77, 2.0, False, "cpu", time.perf_counter())
    assert r["correct"] is False, r["checks"]


def test_the_control_reads_incorrect():
    import torch

    assert not passed(grouping_controls.control(_tiny(), 78, torch.device("cpu")))


@pytest.mark.card
def test_a_short_run_on_the_card():
    r = run_cell(_tiny(), 5, 2.0, False, "cuda:0", time.perf_counter())
    assert r["correct"] is True and r["device"]["platform"] == "gpu"
