"""The port's parity harness end to end on the CPU at a toy size: every
8th point of the density-1 scene as the true model, 4 training and 2
held-out ring views at 64x48 (ground truth at 2x, 65,536 pairs), 20 iterations in calls
of 10, cut after its first call by --max-seconds 0 (exit 3) and resumed
from --state. The report has the JAX tool's keys (read from the root
tool's source and from the committed PARITY_HARNESS.json) and its
checks."""
import json

import numpy as np
import pytest

from harness_keys import REPO, report_layout
from semantic_gaussians_torch.tools import parity_harness as ph
from torch_port_common import np_  # noqa: F401  (one torch thread per worker)


def _keys(d):
    return {k: _keys(v) if isinstance(v, dict) else None for k, v in d.items()}


def _same_layout(report, layout):
    """The report's keys are the layout's; where the layout names the keys
    of a nested dict, the report's nested dict has exactly those."""
    assert set(report) == set(layout)
    for k, sub in layout.items():
        if sub:
            _same_layout(report[k], sub)


@pytest.fixture
def toy(monkeypatch):
    full = ph.build_true_scene

    def every_8th(rng, density=1, return_classes=False):
        return tuple(a[::8] for a in full(rng, density, return_classes))

    monkeypatch.setattr(ph, "build_true_scene", every_8th)
    monkeypatch.setattr(ph, "N_TRAIN", 4)
    monkeypatch.setattr(ph, "N_TEST", 2)
    monkeypatch.setattr(ph, "GT_PAIR_BUDGET", 32768)


def test_parity_harness_toy_run_resumes_and_reports(toy, tmp_path, capsys):
    state, out = tmp_path / "state.pkl", tmp_path / "report.json"
    argv = ["--device", "cpu", "--density", "1", "--width", "64", "--height", "48",
            "--iters", "20", "--chunk-iters", "10", "--capacity", "4096",
            "--pair-budget", "16384", "--init-frac", "0.1",
            "--state", str(state), "--out", str(out)]
    with pytest.raises(SystemExit) as cut:
        ph.main(argv + ["--max-seconds", "0"])
    assert cut.value.code == 3 and state.exists() and not out.exists()
    assert "CHUNK DONE at iter 10" in capsys.readouterr().out
    assert list(tmp_path.glob("state.pkl.gt_ss2_64x48_*.npz"))  # the cached ground truth

    with pytest.raises(SystemExit) as done:  # the toy misses the PSNR floor
        ph.main(argv)
    text = capsys.readouterr().out
    assert done.value.code == 1 and "resumed at iter 10" in text
    report = json.loads(out.read_text())

    layout = report_layout("parity_harness")
    _same_layout(report, layout["report"])
    assert set(report["checks"]) == set(layout["checks"])
    assert all(set(c) == set(layout["curve"]) for c in report["curve"])
    committed = json.loads((REPO / "PARITY_HARNESS.json").read_text())
    assert _keys(report) == _keys(committed)

    assert [c["iter"] for c in report["curve"]] == [10, 20]
    assert report["config"] == dict(iters=20, width=64, height=48,
                                    n_true=len(ph.build_true_scene(
                                        np.random.default_rng(11), 1)[0]),
                                    n_init=report["config"]["n_init"])
    assert report["config"]["n_init"] == max(64, int(report["config"]["n_true"] * 0.1))
    final = report["final"]
    assert np.isfinite(final["test_psnr"]) and final["test_psnr"] > 10
    assert final["alive"] == report["config"]["n_init"] and final["total_overflow"] == 0
    assert report["checks"]["zero_overflow"] and report["opacity_reset_checks"] == []
    assert not report["checks"]["psnr_floor"]
