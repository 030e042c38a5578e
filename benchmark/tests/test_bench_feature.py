"""The Feature 3DGS cell (`scannet.train_feat512`): its operation counts by
hand, its six readers on a made-up record, and whole runs at a tiny size on
the CPU (the field cut to 40 channels, so that the composite still takes
its wide path): the last line, `correct` false under each fault and under
the bfloat16 control."""
import json
import time

import pytest

from benchmark.common import phases as P
from benchmark.common.checks import passed
from benchmark.common.manifest import HERE, Cell, import_file, load_manifest
from benchmark.common.trace import Trace
from benchmark.metrics import counts as K
from benchmark.metrics import feature_counts as FK
from benchmark.run import run_cell
from benchmark.tests.tiny import tiny_cell
from benchmark.tools import feature_controls

CELL = "scannet.train_feat512"
READERS = ("feat.mfu", "feat.composite_fwd_roofline", "feat.composite_bwd_roofline",
           "feat.segsum_roofline", "feat.loss_ms", "feat.update_ms")


def test_counts_by_hand():
    c = dict(evaluated=1000, contributing=100, up_to_last=600, dense=10, pairs=50, live=40)
    assert FK.params_per_gaussian(512) == 571
    d, ch = 512, 515
    want = (3 * 10 * (190 + 150) + 18 * 1000 + 2 * ch * 100 + 18 * 600 + (20 + 4 * ch) * 100
            + 3 * 64 * K.LOSS_PIXEL_OPS + 40 * (6 + ch) + 10 * 59 * 12
            + 64 * d * 5 + 10 * d * 12)
    assert FK.feature_step_ops(c, 10, 64, d) == want


def _ev(cat, ts, dur, name):
    return dict(ph="X", cat=cat, ts=ts, dur=dur, name=name)


def _record(feature_dim=512):
    """One traced step of 100 us: markers and the kernels each reader times."""
    m = lambda ts, ph: _ev("kernel", ts, 1, P.MARKER + ph)  # noqa: E731
    dev = [m(0, "project"), m(2, "bin"), m(4, "composite"),
           _ev("kernel", 5, 4, "composite_fwd_kernel<515>"),
           _ev("kernel", 9, 2, "composite_fwd_contract_kernel"),
           m(12, "loss"), _ev("kernel", 13, 2, "ssim"),
           m(16, "feat_loss"), _ev("kernel", 17, 3, "abs_sub"),
           m(21, "feat_loss_bwd"), _ev("kernel", 22, 2, "sign"),
           m(25, "loss_bwd"), _ev("kernel", 26, 2, "ssim_bwd"),
           m(30, "composite_bwd"), _ev("kernel", 31, 30, "composite_bwd_kernel<1>"),
           _ev("kernel", 61, 9, "composite_bwd_kernel<2>"),
           m(71, "segsum"), _ev("kernel", 72, 4, "segsum_kernel"), _ev("kernel", 76, 1, "bump_epoch"),
           m(78, "project_bwd"), m(80, "update"), _ev("kernel", 81, 15, "adam"),
           m(97, "between")]
    counts = dict(evaluated=4000, contributing=1000, up_to_last=3000, dense=50, pairs=300,
                  live=250)
    return dict(layer=dict(steps=1, wall_s=100e-6, trace=Trace(dev, window_s=100e-6),
                           counts=counts, gaussians=100, pixels=512, channels=3 + feature_dim,
                           feature_dim=feature_dim))


def _read(name, rec):
    return import_file(HERE / "metrics" / f"{name}.py", "m_" + name.replace(".", "_")).read(rec)


def test_readers_on_a_made_up_record():
    rec = _record()
    c, lay = rec["layer"]["counts"], rec["layer"]
    # busy us: feat_loss 16-20 (its marker and a kernel), feat_loss_bwd 21-24; update 80-96
    assert _read("feat.loss_ms", rec) == pytest.approx(0.001 * (4 + 3))
    assert _read("feat.update_ms", rec) == pytest.approx(0.001 * 16)
    assert _read("feat.composite_fwd_roofline", rec) == pytest.approx(
        100 * K.composite_fwd_bound_s(c, 515, 512) / 6e-6)
    assert _read("feat.composite_bwd_roofline", rec) == pytest.approx(
        100 * K.composite_bwd_bound_s(c, 515, 512) / 39e-6)
    assert _read("feat.segsum_roofline", rec) == pytest.approx(
        100 * K.segsum_bound_s(250, 101, 521) / 5e-6)
    assert _read("feat.mfu", rec) == pytest.approx(
        100 * FK.feature_step_ops(c, 100, 512, 512) / lay["wall_s"] / K.PEAK_F32)
    for name in READERS:
        assert _read(name, {}) is None
    rgb = _record()
    rgb["layer"].update(feature_dim=0, channels=3)
    for name in READERS[:4]:  # a record without a field has nothing to read
        assert _read(name, rgb) is None


def test_manifest_entries():
    m = load_manifest()
    cell = Cell(CELL, m)
    assert cell.chips == 1 and cell.traffic == "train_feature"
    assert [x["name"] for x in cell.end_to_end()] == ["train_step_ms", "setup_s"]
    assert sorted(x["name"] for x in cell.per_layer()) == sorted(READERS)
    cfg = cell.config
    assert cfg["feature_dim"] == 512 and cfg["train"]["pair_budget"] == 4194304
    base = Cell("scannet.train", m).config
    for k in ("law", "num_gaussians", "sh_degree", "width", "height", "fov_x", "fov_y", "room"):
        assert cfg[k] == base[k], k
    for k, v in base["train"].items():
        assert k == "pair_budget" or cfg["train"][k] == v, k


def _tiny():
    cell = tiny_cell(CELL)
    cell.config["feature_dim"] = 40
    return cell


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_schema(trace):
    cell = _tiny()
    r = run_cell(cell, 2**31 + 12345, 2.0, trace, "cpu", time.perf_counter())
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    json.dumps(r)
    if trace:  # the CPU has no device events: the step count's share alone
        assert set(r["metrics"]) == {"feat.mfu"}
        assert 0 < r["metrics"]["feat.mfu"]["value"] <= 100
    else:
        assert set(r["metrics"]) == {"train_step_ms", "setup_s"}


@pytest.mark.parametrize("fault", list(feature_controls.FAULTS))
def test_a_fault_reads_incorrect(fault):
    cell = _tiny()
    with feature_controls.FAULTS[fault]():
        r = run_cell(cell, 77, 2.0, False, "cpu", time.perf_counter())
    assert r["correct"] is False, r["checks"]


def test_the_control_reads_incorrect():
    import torch

    assert not passed(feature_controls.control(_tiny(), 78, torch.device("cpu")))


@pytest.mark.card
def test_a_short_run_on_the_card():
    r = run_cell(_tiny(), 5, 2.0, False, "cuda:0", time.perf_counter())
    assert r["correct"] is True and r["device"]["platform"] == "gpu"
