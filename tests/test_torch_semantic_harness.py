"""The port's semantic harness end to end on the CPU at a toy size: every
8th point of the density-1 scene, D = 16, 3 fused and 2 evaluated views
at 64x48, MinkUNet14A for 2 epochs at 10 cm voxels; cut after fusion by
--max-seconds 0 (exit 3) and resumed from --state. The report has the JAX
tool's keys (read from the root tool's source and from the committed
SEMANTIC_HARNESS.json), every labelled pixel is counted in each mode."""
import json

import numpy as np
import pytest

from harness_keys import REPO, report_layout
from semantic_gaussians_torch.tools import semantic_harness as sh
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
    full = sh.build_true_scene

    def every_8th(rng, density=1, return_classes=False):
        return tuple(a[::8] for a in full(rng, density, return_classes))

    monkeypatch.setattr(sh, "build_true_scene", every_8th)
    monkeypatch.setattr(sh, "MODEL_3D", "MinkUNet14A")


def test_semantic_harness_toy_run_resumes_and_reports(toy, tmp_path, capsys):
    state, out = tmp_path / "state.pkl", tmp_path / "report.json"
    argv = ["--device", "cpu", "--density", "1", "--dim", "16", "--width", "64",
            "--height", "48", "--n-fuse", "3", "--n-eval", "2", "--chunk-views", "2",
            "--epochs", "2", "--epoch-block", "1", "--voxel-size", "0.1",
            "--voxel-budget", "1024",
            "--workdir", str(tmp_path / "work"), "--state", str(state), "--out", str(out)]
    with pytest.raises(SystemExit) as cut:
        sh.main(argv + ["--max-seconds", "0"])
    assert cut.value.code == 3 and "CHUNK DONE (fuse)" in capsys.readouterr().out

    args = sh.parse_args(argv)
    report, extra = sh.run(args)
    assert "resumed: stage=fuse view=2" in capsys.readouterr().out

    layout = report_layout("semantic_harness")
    _same_layout(report, layout["report"])
    assert set(report["checks"]) == set(layout["checks"])
    assert set(report["metrics"]) == layout["metrics"]
    committed = json.loads((REPO / "SEMANTIC_HARNESS.json").read_text())
    # the committed file predates the JAX tool's feat_dtype key
    assert set(report["config"]) == set(committed["config"]) | {"feat_dtype"}
    assert set(report) == set(committed) and set(report["checks"]) == set(committed["checks"])
    assert set(report["metrics"]) == set(committed["metrics"])

    m = report["metrics"]
    assert report["timings"]["fuse"]["views"] == 3 and len(report["timings"]["fuse"]["chunks"]) == 2
    assert report["timings"]["distill"]["epochs"] == 2 and len(report["loss_curve"]) == 2
    assert m["fused_cos_mean"] > 0.95 and report["checks"]["fused_cos"]
    assert 0 < m["visited_frac_labeled"] <= 1 and m["live_pairs"] > 0
    for mode in ("2d", "3d", "2d_and_3d"):
        assert np.isfinite(report["timings"]["eval"][mode]["miou"])
        assert extra["counted_pixels"][mode] == extra["labelled_pixels"] > 0
    assert 0 < report["config"]["n_gaussians"] <= report["config"]["capacity"]
    assert report["config"]["device"] == "cpu"
