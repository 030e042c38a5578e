"""The frozen kernel bounds and step counts against hand counts, and the
trace arithmetic on a made-up trace."""
import pytest

from benchmark.common.trace import Trace
from benchmark.metrics import counts as K


def test_bounds_by_hand():
    # expand: 32 B a dense Gaussian, 12 a slot
    assert K.expand_bound_s(10, 100) == pytest.approx((320 + 1200) / 3.35e12)
    c = dict(evaluated=1000, contributing=100, up_to_last=600, dense=10, pairs=50, live=40)
    # forward: 18 a walked pair-pixel, 2C a contribution; ops beat bytes here
    ops = 18 * 1000 + 2 * 3 * 100
    nbytes = 10 * 11 * 4 + 50 * 4 + 64 * 6 * 4
    assert K.composite_fwd_bound_s(c, 3, 64) == pytest.approx(max(ops / 67e12, nbytes / 3.35e12))
    ops = 18 * 600 + (20 + 12) * 100
    nbytes = 10 * 11 * 4 + 50 * 4 + 64 * 5 * 4 + 50 * 9 * 4
    assert K.composite_bwd_bound_s(c, 3, 64) == pytest.approx(max(ops / 67e12, nbytes / 3.35e12))
    assert K.segsum_bound_s(40, 11, 9) == pytest.approx((40 * 9 * 4 + 40 * 4 + 11 * 9 * 4) / 3.35e12)
    step = K.train_step_ops(c, 10, 64)
    assert step == (3 * 10 * (190 + 150) + 18 * 1000 + 600 + 18 * 600 + 32 * 100
                    + 3 * 64 * K.LOSS_PIXEL_OPS + 40 * 9 + 10 * 59 * 12)
    assert K.share(1.0, 0.0) is None and K.share(1.0, 4.0) == 25.0


def _ev(cat, ts, dur, name):
    return dict(ph="X", cat=cat, ts=ts, dur=dur, name=name)


def test_trace_busy_idle_and_gaps():
    ev = [_ev("kernel", 0, 10, "a_kernel"), _ev("kernel", 5, 10, "b"),  # union 0-15
          _ev("gpu_memcpy", 30, 5, "copy"),  # gap 15-30
          _ev("kernel", 50, 10, "a_kernel"),  # gap 35-50
          _ev("cpu_op", 14, 20, "aten::sort"), _ev("cpu_op", 36, 20, "cudaGraphLaunch")]
    t = Trace(ev, window_s=100e-6)
    assert t.busy_s() == pytest.approx(30e-6)
    assert t.kernel_s("a_kernel") == pytest.approx(20e-6)
    assert t.top_ops(1) == [["a_kernel", pytest.approx(20e-6)]]
    assert dict((n, v) for n, v in t.idle_gaps()) == {
        "aten::sort": pytest.approx(15e-6), "cudaGraphLaunch": pytest.approx(15e-6)}
    assert K.idle_share({"layer": {"trace": t}}) == pytest.approx(70.0)
