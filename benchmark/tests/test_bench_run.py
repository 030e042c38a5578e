"""Whole runs at tiny sizes on the CPU (the look for a card skipped): the
last line's schema, and `correct` false under each fault and under the
control."""
import json
import time

import pytest
import torch

from benchmark.common.checks import passed
from benchmark.run import run_cell
from benchmark.tests.tiny import tiny_cell
from benchmark.tools import controls

CELLS = ["scannet.train", "scannet.distill", "scannet.view"]
SECONDS = {"scannet.view": 8.0}  # a window that reaches every mode on the CPU


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_last_line_schema(name, trace):
    cell = tiny_cell(name)
    r = run_cell(cell, 2**31 + 12345, SECONDS.get(name, 2.0), trace, "cpu", time.perf_counter())
    keys = list(r)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    json.dumps(r)
    own = {m["name"] for m in (cell.per_layer() if trace else cell.end_to_end())}
    assert set(r["metrics"]) <= own
    if not trace:
        assert set(r["metrics"]) == own
    for v in r["metrics"].values():
        assert set(v) == {"value", "unit"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}


FAULTS = [(c, f) for c, t in (("scannet.train", "train"), ("scannet.distill", "distill"),
                              ("scannet.view", "view")) for f in controls.FAULTS[t]]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_a_fault_reads_incorrect(name, fault):
    cell = tiny_cell(name)
    with controls.FAULTS[cell.traffic][fault]():
        r = run_cell(cell, 77, SECONDS.get(name, 2.0), False, "cpu", time.perf_counter())
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("name", [
    "scannet.train", "scannet.view",
    pytest.param("scannet.distill", marks=pytest.mark.card),  # TF32 exists on the card only
])
def test_the_control_reads_incorrect(name):
    cell = tiny_cell(name)
    dev = torch.device("cuda:0" if name == "scannet.distill" else "cpu")
    assert not passed(controls.CONTROLS[cell.traffic](cell, 78, dev))


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS + ["garden.train"])
def test_a_short_run_on_the_card(name):
    cell = tiny_cell(name)
    r = run_cell(cell, 5, 2.0, False, "cuda:0", time.perf_counter())
    assert r["correct"] is True and r["device"]["platform"] == "gpu"
