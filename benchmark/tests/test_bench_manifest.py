"""BENCHMARK.json against the contract's shape, the finding of files by
name, and a cell added by new files alone."""
import json
import re
import shutil
import sys
import time

import pytest

from benchmark.common.manifest import HERE, ROOT, Cell, load_manifest
from benchmark.tests.tiny import with_held_cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_keys_and_names():
    m = load_manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert m["paths"] == ["benchmark"] and 1 <= m["run_seconds"] <= 51
    names = [c["name"] for c in m["configs"]] + [w["name"] for w in m["workloads"]]
    names += [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).exists()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
    e2e = {x["name"] for x in m["end_to_end"]}
    assert "setup_s" in e2e
    for x in m["end_to_end"]:
        assert 0.01 <= x["bound"] <= 0.25 and x["source"] in ("host_clock", "device_trace")
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
    for x in m["per_layer"]:
        assert x["moves"] in e2e and UNIT.match(x["unit"]) and "\n" not in x["layer"]
        assert x["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


HELD = with_held_cells()


@pytest.mark.parametrize("name", [w["name"] for w in HELD["workloads"]])
def test_every_cell_finds_its_files(name):
    """The cells of BENCHMARK.json, and those held back (held_cells.json)."""
    cell = Cell(name, HELD)
    assert cell.driver_path.exists() and hasattr(cell.driver(), "run")
    assert cell.end_to_end() and any(m["name"] == "setup_s" for m in cell.end_to_end())
    assert len(cell.end_to_end()) >= 2 and cell.per_layer()
    for m in cell.per_layer():
        assert cell.metric_reader(m["name"]).read({}) is None  # nothing to read: no number
    for m in HELD["per_layer"]:
        assert m["workloads"]
        for w in m["workloads"]:
            assert m["moves"] in {x["name"] for x in Cell(w, HELD).end_to_end()}


DUMMY_DRIVER = '''
def run(ctx):
    ctx.mark("imports")
    ctx.window_start()
    ctx.window_end()
    return dict(e2e={"dummy_ms": 1.5}, attempted=3, failed=0, memory_peak_bytes=0,
                layer={"x": 2.0}, checks=[("gap", 0.0, ctx.workload["limit"])])
'''


def test_a_cell_is_added_by_new_files_alone(tmp_path):
    """A configuration, a traffic driver, a per-layer metric and a cell,
    added in a copy as new files and new entries: no existing file edited."""
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(root): p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}
    b = root / "benchmark"
    (b / "configs" / "dummy_cfg.json").write_text(json.dumps({"name": "dummy_cfg"}))
    (b / "workloads" / "dummy.cell.json").write_text(json.dumps({"limit": 0.5}))
    (b / "traffic" / "dummy.py").write_text(DUMMY_DRIVER)
    (b / "metrics" / "dummy.layer.py").write_text("def read(rec):\n    return rec['layer']['x']\n")
    m = load_manifest()
    m["configs"].append({"name": "dummy_cfg", "source": "https://example.org",
                         "file": "benchmark/configs/dummy_cfg.json", "reduced": [], "why": "x"})
    m["workloads"].append({"name": "dummy.cell", "config": "dummy_cfg", "traffic": "dummy",
                           "chips": 1, "why": "x"})
    m["end_to_end"].append({"name": "dummy_ms", "unit": "ms", "better": "lower", "bound": 0.05,
                            "source": "host_clock", "workloads": ["dummy.cell"]})
    m["per_layer"].append({"name": "dummy.layer", "unit": "ms", "better": "lower",
                           "source": "program_span", "layer": "x", "moves": "dummy_ms",
                           "workloads": ["dummy.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    for rel, data in before.items():
        assert (root / rel).read_bytes() == data
    from benchmark.run import run_cell

    cell = Cell("dummy.cell", load_manifest(root), bench_dir=b)
    r = run_cell(cell, 1, 1.0, False, "cpu", time.perf_counter())
    assert r["correct"] and r["metrics"]["dummy_ms"]["value"] == 1.5
    assert "setup_s" in r["metrics"]
    r = run_cell(cell, 1, 1.0, True, "cpu", time.perf_counter())
    assert r["metrics"] == {"dummy.layer": {"value": 2.0, "unit": "ms"}}


def test_the_run_refuses_without_a_card(monkeypatch, capsys):
    import torch

    from benchmark import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "scannet.train", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_forbidden_modules_compare_whole_names(monkeypatch):
    from benchmark.run import forbidden_modules

    assert "semantic_gaussians_torch" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert forbidden_modules() == ["jaxlib"]


def test_no_jax_in_the_harness_or_the_port():
    import subprocess

    code = ("import sys; import benchmark.run, benchmark.tools.controls; "
            "import semantic_gaussians_torch.pipelines.train, semantic_gaussians_torch.pipelines.distill, "
            "semantic_gaussians_torch.cli.view_server; "
            "[__import__('benchmark.' + p) for p in ('traffic.train', 'traffic.distill', 'traffic.view')]; "
            "from benchmark.run import forbidden_modules; print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
