"""Finding a cell's pieces by name.

`BENCHMARK.json` at the checkout's root lists the configurations, cells and
metrics. Each has its files under `benchmark/`, found by name alone, so a
later change adds a configuration, a cell, a traffic driver or a metric as
new files and new entries, and edits none:

  configs/<config>.json     the configuration as it is run
  workloads/<cell>.json     the cell's traffic parameters and the limits of its checks
  traffic/<traffic>.py      the driver the cell's `traffic` names: run(ctx) -> record
                            (set-up, warm-up, window, check)
  metrics/<metric>.py       read(record) -> number or None, a per-layer metric
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parents[1]  # the benchmark's folder
ROOT = HERE.parent  # the checkout


def load_manifest(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _by_name(items: List[Dict], name: str, what: str) -> Dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def import_file(path: Path, name: str) -> ModuleType:
    """A module from its file, whatever its name (metric files carry dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One cell of the manifest with everything found by its names."""

    def __init__(self, name: str, manifest: Dict, bench_dir: Path = HERE):
        self.manifest = manifest
        self.entry = _by_name(manifest["workloads"], name, "workload")
        self.name = name
        self.chips = int(self.entry["chips"])
        cfg_entry = _by_name(manifest["configs"], self.entry["config"], "config")
        self.config = load_json(bench_dir.parent / cfg_entry["file"])
        self.workload = load_json(bench_dir / "workloads" / f"{name}.json")
        self.traffic = self.entry["traffic"]
        self.driver_path = bench_dir / "traffic" / f"{self.traffic}.py"
        self.bench_dir = bench_dir

    def driver(self) -> ModuleType:
        return import_file(self.driver_path, f"benchmark_traffic_{self.traffic}")

    def _applies(self, metric: Dict) -> bool:
        if "workloads" in metric:
            return self.name in metric["workloads"]
        return True

    def end_to_end(self) -> List[Dict]:
        return [m for m in self.manifest["end_to_end"] if self._applies(m)]

    def per_layer(self) -> List[Dict]:
        """The cell's per-layer metrics: those that list it by name."""
        return [m for m in self.manifest["per_layer"] if self.name in m.get("workloads", ())]

    def metric_reader(self, metric: str) -> ModuleType:
        return import_file(self.bench_dir / "metrics" / f"{metric}.py",
                           "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"))
