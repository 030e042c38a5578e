"""The phase arithmetic (common/phases.py) and its six readers on made-up
traces: markers, kernels, gaps inside phases and between dispatches, and
the program's `sgt.` host spans."""
import pytest

from benchmark.common import phases as P
from benchmark.common.manifest import Cell, load_manifest
from benchmark.common.trace import Trace
from benchmark.metrics import counts as K

READERS = ("train.project_ms", "train.bin_ms", "train.loss_ms", "train.update_ms",
           "train.inner_gap_ms", "train.dispatch_gap_ms")


def _ev(cat, ts, dur, name):
    return dict(ph="X", cat=cat, ts=ts, dur=dur, name=name)


def _m(ts, phase):
    return _ev("kernel", ts, 1, P.MARKER + phase)


def _window():
    """200 us: a graphed step (with a carry) and an eager step's start, in
    microseconds; two steps."""
    dev = [_m(10, "project"), _ev("kernel", 11, 10, "gemmSN_TN_kernel"),  # gap 21-25
           _m(25, "bin"), _ev("kernel", 26, 10, "expand_kernel"),
           _m(36, "loss"), _ev("kernel", 37, 8, "ssim"), _ev("kernel", 40, 10, "blur"),
           _m(50, "project_bwd"), _ev("kernel", 51, 9, "gemv2N_kernel"),  # gap 60-63
           _m(63, "update"), _ev("kernel", 64, 6, "adam"),
           _m(70, "carry"), _ev("gpu_memcpy", 71, 4, "Memcpy DtoD"),
           _m(75, "between"), _ev("gpu_memcpy", 76, 4, "Memcpy DtoD"),  # gap 80-140
           _ev("gpu_memcpy", 140, 5, "Memcpy HtoD"),  # gap 145-150
           _m(150, "project"), _ev("kernel", 151, 9, "gemmSN_TN_kernel"),
           _m(160, "between")]
    host = [_ev("user_annotation", 0, 190, "sgt.train_loop"),
            _ev("user_annotation", 0, 8, "sgt.loop.prep"),
            _ev("user_annotation", 10, 10, "sgt.graph.replay"),
            _ev("user_annotation", 100, 20, "sgt.loop.log"),
            _ev("cpu_op", 105, 10, "aten::copy_"),
            _ev("user_annotation", 138, 12, "sgt.graph.fill"),
            _ev("cuda_runtime", 150, 30, "cudaStreamSynchronize")]
    return Trace(dev + host, window_s=200e-6)


def test_split_by_phase_and_gap():
    s = P.split(_window())
    assert s.busy_us == dict(project=21, bin=11, loss=14, project_bwd=10, update=7, carry=5,
                             between=11)
    assert s.ops == dict(project=2, bin=1, loss=2, project_bwd=1, update=1, carry=1, between=2)
    assert s.inner_us == dict(project=4, project_bwd=3)
    # 80-140 under the log span, 145-150 under the fill, the window's lead
    # (0-10) under prep and its tail (161-200) the harness's edge
    assert s.dispatch_us == {"sgt.loop.log": 60, "sgt.graph.fill": 5, "sgt.loop.prep": 10,
                             P.EDGE: 39}
    assert s.markers == ["project", "bin", "loss", "project_bwd", "update", "carry", "between",
                         "project", "between"]
    assert sorted(s.dispatch_gaps) == [(0, 10, "sgt.loop.prep"), (80, 140, "sgt.loop.log"),
                                       (145, 150, "sgt.graph.fill"),
                                       (161, 200, P.EDGE)]


def test_phases_and_gaps_sum_to_the_window():
    t = _window()
    s = P.split(t)
    busy = sum(s.busy_us.values())
    assert busy == pytest.approx(t.busy_s() * 1e6)
    assert busy + sum(s.inner_us.values()) + sum(s.dispatch_us.values()) == pytest.approx(200)
    idle = K.idle_share({"layer": {"trace": t}}) / 100 * t.window_s * 1e3
    assert s.inner_ms() + s.dispatch_ms() == pytest.approx(idle)


@pytest.mark.parametrize("name, want", [
    ("train.project_ms", (21 + 10) / 2e3), ("train.bin_ms", 11 / 2e3),
    ("train.loss_ms", 14 / 2e3), ("train.update_ms", 7 / 2e3),
    ("train.inner_gap_ms", 7 / 2e3), ("train.dispatch_gap_ms", 114 / 2e3)])
def test_readers(name, want):
    cell = Cell("scannet.train", load_manifest())
    rec = {"layer": {"trace": _window(), "steps": 2}}
    assert cell.metric_reader(name).read(rec) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read_is_none(name):
    """A trace without markers (a program without them), no trace, no
    record: None, never 0."""
    reader = Cell("scannet.train", load_manifest()).metric_reader(name)
    bare = Trace([_ev("kernel", 0, 10, "gemmSN_TN_kernel"), _ev("kernel", 20, 5, "adam")],
                 window_s=40e-6)
    assert reader.read({"layer": {"trace": bare, "steps": 2}}) is None
    assert reader.read({"layer": {"trace": None, "steps": 2}}) is None
    assert reader.read({}) is None


def test_gaps_outside_any_span_and_a_tail_inside_a_dispatch():
    """Without host spans every dispatch gap is outside any span and the
    window's idle edge follows its last device event; a window that ends
    inside a dispatch puts that tail in the phase then in force."""
    t = Trace([_m(0, "project"), _ev("kernel", 1, 4, "a"), _m(5, "between"),
               _ev("kernel", 16, 4, "b"), _m(20, "update"), _ev("kernel", 21, 4, "c")],
              window_s=40e-6)
    s = P.split(t)
    assert s.dispatch_us == {P.OUTSIDE: 10}
    assert s.inner_us == {"update": 15}
    assert sum(s.busy_us.values()) + 10 + 15 == pytest.approx(40)


def test_device_clock_put_on_the_host_clock():
    """The first kernel seems to start 50 us before the host's first launch
    call: the device clock is read 50 us later, and the gap 10-30 falls
    under the span running at host time 70."""
    t = Trace([_m(0, "project"), _ev("kernel", 1, 4, "a"), _m(5, "between"),
               _ev("kernel", 30, 4, "b"),
               _ev("user_annotation", 40, 60, "sgt.graph.replay"),
               _ev("cuda_runtime", 50, 2, "cudaGraphLaunch")], window_s=34e-6)
    s = P.split(t)
    assert s.dispatch_us == {"sgt.graph.replay": 24}


def test_gaps_scaled_to_a_shorter_window():
    """Device events spanning 40 us in a 35 us window: the 15 us of gaps are
    scaled to the window's 10 us of idle time, in proportion."""
    t = Trace([_m(0, "project"), _ev("kernel", 1, 9, "a"), _ev("kernel", 15, 5, "b"),
               _m(20, "between"), _ev("kernel", 31, 9, "c")], window_s=35e-6)
    s = P.split(t)
    busy = sum(s.busy_us.values())
    assert busy == 25
    assert s.inner_us == {"project": pytest.approx(5 * 10 / 15)}
    assert s.dispatch_ms() * 1e3 == pytest.approx(10 * 10 / 15)
    assert busy + s.inner_ms() * 1e3 + s.dispatch_ms() * 1e3 == pytest.approx(35)


def test_every_new_metric_lists_both_train_cells():
    m = {x["name"]: x for x in load_manifest()["per_layer"]}
    for name in READERS:
        assert m[name]["workloads"] == ["scannet.train", "garden.train"]
        assert m[name]["source"] == "device_trace" and m[name]["moves"] == "train_step_ms"
        assert m[name]["unit"] == "ms" and m[name]["better"] == "lower"


def test_phase_table_tool():
    from benchmark.tools.phase_table import STEP, dispatches, table

    step = STEP
    markers = (step * 2 + ["carry", "between"]) * 3 + ["project"] + step + ["between"]
    assert dispatches(markers) == {"2-step graph": 3, "1-step eager": 1}
    assert dispatches(step[::-1] + ["between"]) == {"1-step eager out of order": 1}
    out = table({"layer": {"trace": _window(), "steps": 2}}, "scannet.train")
    assert out["sum_over_wall"] == pytest.approx(1.0)
    assert out["gaps_over_idle"] == pytest.approx(1.0)
    assert out["metrics"]["train.loss_ms"] == pytest.approx(14 / 2e3)
    assert out["named_ms"]["gemmSN_TN"] == {"project": pytest.approx(19 / 2e3)}
    assert [(g["start"], g["us"], g["span"]) for g in out["largest_dispatch_gaps"]] == [
        (70, 60, "sgt.loop.log"), (151, 39, P.EDGE), (-10, 10, "sgt.loop.prep"),
        (135, 5, "sgt.graph.fill")]
    assert out["largest_dispatch_gaps"][0]["host"] == ["aten::copy_", "sgt.loop.log",
                                                      "sgt.train_loop"]
    # the inner gaps 21-25 and 60-63 run under the loop's span alone
    assert out["inner_gap_ms_by_host"] == {"sgt.train_loop": pytest.approx(7 / 2e3)}
    assert out["clock_shift_us"] == 0.0
