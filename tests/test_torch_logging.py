"""Port parity: TensorBoard logging (utils.logging_utils.TBLogger). Without
tensorboard the logger is a no-op and training runs; with a stand-in
SummaryWriter the port's train_loop logs the JAX package's tags at its
cadence: train/loss, psnr, total_points, iter_time and pair_overflow at
every iteration that is a multiple of 10, the opacity histogram at every
multiple of 1000."""
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch
import torch.utils.tensorboard

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from semantic_gaussians_tpu.pipelines import train as jtrain  # noqa: E402
from semantic_gaussians_torch.pipelines import train as ttrain  # noqa: E402
from semantic_gaussians_torch.utils import logging_utils  # noqa: E402
from test_torch_dispatch import _toy_training  # noqa: E402


class StubWriter:
    """Records what a SummaryWriter is asked to write, per instance."""

    made = []

    def __init__(self, log_dir):
        self.log_dir = log_dir
        self.calls = []
        self.closed = False
        StubWriter.made.append(self)

    def add_scalar(self, tag, value, step):
        self.calls.append(("scalar", tag, step, float(value)))

    def add_histogram(self, tag, values, step):
        self.calls.append(("histogram", tag, step, len(values)))

    def close(self):
        self.closed = True


def test_tblogger_is_a_no_op_without_tensorboard(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # import fails
    tb = logging_utils.TBLogger(tmp_path / "tb")
    assert not tb.active and tb.writer is None
    tb.scalar("train/loss", torch.tensor(1.0), 10)
    tb.histogram("h", np.zeros(3), 10)
    tb.close()
    assert not (tmp_path / "tb").exists()
    _, tstate, _, tcams = _toy_training(views=2)
    _, log = ttrain.train_loop(tstate, tcams, ttrain.TrainConfig(densify_from_iter=10_000),
                               num_iters=10, steps_per_dispatch=5, tb_dir=str(tmp_path / "tb"))
    assert log["chunks"] == [(1, 5), (6, 5)]


def test_tblogger_tags_and_cadence_match_jax(tmp_path, monkeypatch):
    """From iteration 990 for 20 steps at K = 5 (chunks 991-995, 996-999,
    1000-1004, ...): both packages' loggers get the same (kind, tag, step)
    sequence, the histogram at 1000 over the alive opacities, and close."""
    monkeypatch.setattr(torch.utils.tensorboard, "SummaryWriter", StubWriter)
    StubWriter.made.clear()
    jstate, tstate, jcams, tcams = _toy_training(views=2)
    cfg_kw = dict(densify_from_iter=10_000, spatial_lr_scale=2.0)
    jtrain.train_loop(jstate, jcams, jtrain.TrainConfig(**cfg_kw), jax.random.PRNGKey(0),
                      num_iters=20, backend="pallas", tb_dir=str(tmp_path / "j"),
                      iter_offset=990, steps_per_dispatch=5)
    ttrain.train_loop(tstate, tcams, ttrain.TrainConfig(**cfg_kw), num_iters=20,
                      tb_dir=str(tmp_path / "t"), iter_offset=990, steps_per_dispatch=5)
    jw, tw = StubWriter.made
    assert tw.log_dir == str(tmp_path / "t") and tw.closed

    def keys(w):
        return [c[:3] for c in w.calls]

    tags = ["train/loss", "train/psnr", "train/total_points", "train/iter_time",
            "train/pair_overflow"]
    want = [("scalar", t, 1000) for t in tags] + [
        ("histogram", "scene/opacity_histogram", 1000)] + [("scalar", t, 1010) for t in tags]
    assert keys(tw) == keys(jw) == want
    hist = [c for c in tw.calls if c[0] == "histogram"]
    assert hist[0][3] == int(tstate.alive.sum())
    for t, j in zip(tw.calls, jw.calls):
        if t[1] in ("train/total_points", "train/pair_overflow"):
            assert t[3] == j[3]
        elif t[1] in ("train/loss", "train/psnr"):
            np.testing.assert_allclose(t[3], j[3], rtol=5e-3)
