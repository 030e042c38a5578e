"""Port parity: the trace helpers (utils.logging_utils.profile_trace,
top_ops, device_busy_ms) and tools.profile_step. top_ops reads a
synthetic Chrome trace that both packages' readers understand (the JAX
reader keeps the events of the process named TPU, the port's those of the
device categories of torch.profiler's export): the same rows, each
divided by the steps, the k largest; profile_trace writes a trace on the
CPU that top_ops reads back; profile_step runs bench.py's step at a toy
size."""
import gzip
import json

import pytest
import torch

from semantic_gaussians_tpu.utils.logging_utils import top_ops as jax_top_ops
from semantic_gaussians_torch.utils.logging_utils import (
    DEVICE_CATEGORIES, device_busy_ms, profile_trace, top_ops,
)
from torch_port_common import np_  # noqa: F401  (one torch thread per worker)

DEVICE_PID, HOST_PID = 7, 1


def _events():
    """Device kernels, copies and fills on two streams of the device's
    process (some overlapping), and host frames that would outweigh them."""
    ev = [
        {"ph": "M", "name": "process_name", "pid": DEVICE_PID, "args": {"name": "/device:TPU:0"}},
        {"ph": "M", "name": "process_name", "pid": HOST_PID, "args": {"name": "python3"}},
    ]
    dev = [("composite_fwd", "kernel", 0, 400), ("composite_bwd", "kernel", 500, 900),
           ("segsum", "kernel", 1450, 100), ("composite_fwd", "kernel", 2000, 380),
           ("Memcpy HtoD", "gpu_memcpy", 2300, 150),  # overlaps the kernel on stream 1
           ("Memset", "gpu_memset", 2600, 20), ("expand", "kernel", 2700, 30),
           ("composite_bwd", "kernel", 2800, 880)]
    for i, (name, cat, ts, dur) in enumerate(dev):
        ev.append({"ph": "X", "cat": cat, "name": name, "pid": DEVICE_PID, "tid": 1 + i % 2,
                   "ts": ts, "dur": dur})
    ev.append({"ph": "i", "cat": "kernel", "name": "instant", "pid": DEVICE_PID, "ts": 5})
    for name, ts, dur in (("aten::mm", 0, 5000), ("cudaLaunchKernel", 10, 3000),
                          ("train_step", 0, 9000)):
        ev.append({"ph": "X", "cat": "cpu_op", "name": name, "pid": HOST_PID, "tid": 3,
                   "ts": ts, "dur": dur})
    return ev


@pytest.fixture
def trace_dir(tmp_path):
    d = tmp_path / "plugins" / "profile" / "run"
    d.mkdir(parents=True)
    with gzip.open(d / "host.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": _events()}, f)
    return tmp_path


@pytest.mark.parametrize("k,steps", [(20, 1), (3, 2), (1, 4)])
def test_top_ops_matches_jax_device_only(trace_dir, k, steps):
    got = top_ops(trace_dir, k=k, steps=steps)
    want = jax_top_ops(str(trace_dir), k=k, steps=steps)
    assert got == want
    full = dict(top_ops(trace_dir, k=99, steps=steps))
    assert set(full.values()) == {"composite_fwd", "composite_bwd", "segsum", "Memcpy HtoD",
                                  "Memset", "expand"}
    assert pytest.approx(sum(full)) == 2860 / 1e3 / steps
    assert got[0] == (1780 / 1e3 / steps, "composite_bwd") and len(got) == min(k, 6)


def test_top_ops_with_host_events(trace_dir):
    got = top_ops(trace_dir, k=3, steps=3, device_only=False)
    assert got == jax_top_ops(str(trace_dir), k=3, steps=3, device_only=False)
    assert [n for _, n in got] == ["train_step", "aten::mm", "cudaLaunchKernel"]
    assert got[0][0] == pytest.approx(3.0)


def test_device_busy_ms_takes_the_union_over_streams(trace_dir):
    # [0, 400] + [500, 1400] + [1450, 1550] + [2000, 2450] + [2600, 2620]
    # + [2700, 2730] + [2800, 3680]
    assert device_busy_ms(trace_dir) == pytest.approx(2780 / 1e3)
    assert set(DEVICE_CATEGORIES) == {"kernel", "gpu_memcpy", "gpu_memset"}


def test_profile_trace_writes_a_trace_top_ops_reads(tmp_path):
    x = torch.randn(64, 64)
    with profile_trace(tmp_path / "t"):
        for _ in range(3):
            x = torch.mm(x, x) / 64
    rows = top_ops(tmp_path / "t", k=50, steps=3, device_only=False)
    names = [n for _, n in rows]
    assert "aten::mm" in names and all(ms >= 0 for ms, _ in rows)
    assert top_ops(tmp_path / "t", steps=3) == []  # no device timeline on the CPU
    assert device_busy_ms(tmp_path / "t") == 0.0


def test_profile_step_on_the_cpu(capsys):
    from semantic_gaussians_torch.tools import profile_step

    out = profile_step.main(["--n", "300", "--width", "32", "--height", "16",
                             "--device", "cpu"])
    assert out["budget"] == 8192 and 0 < out["pairs"] <= 8192
    assert not out["device_only"] and out["device_busy_ms"] is None
    assert out["wall_ms"] > 0 and out["traced_wall_ms"] > 0  # untraced and traced steps
    names = [n for _, n in out["rows"]]
    assert 0 < len(names) <= profile_step.TOP_K and "CompositeFunctionBackward" in names
    assert "bench step: top" in capsys.readouterr().out
    if not torch.cuda.is_available():  # the card is the default device
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            profile_step.main(["--n", "300"])


def test_bench_scene_is_bench_law():
    """The first Gaussians of bench.py's law (seed 0) and its camera."""
    import numpy as np

    from semantic_gaussians_torch.tools.profile_step import bench_scene

    params, alive, cam, target = bench_scene(500, 64, 48, "cpu")
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(500, 3)).astype(np.float32) * np.array([1.6, 1.1, 1.0], np.float32) \
        + np.array([0, 0, 4], np.float32)
    np.testing.assert_array_equal(params.means.numpy(), pts)
    assert bool(alive.all()) and tuple(target.shape) == (48, 64, 3)
    assert (cam.width, cam.height, cam.fov_x, cam.fov_y) == (64, 48, 1.4, 1.1)
