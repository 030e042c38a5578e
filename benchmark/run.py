"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is found by name in BENCHMARK.json
and its files under benchmark/ (common/manifest.py). The run makes its
inputs from the seed on the card, sets up and warms up the program
(`semantic_gaussians_torch`), measures a window of `--seconds`, checks
what the window produced against the plain reference, and prints as its
last line one JSON object: correct, attempted, failed, metrics (the
cell's end-to-end metrics, or with `--trace 1` its per-layer ones),
device and, traced, breakdown; last in it, "checks": each number compared
beside its limit, which also close standard error. Earlier lines carry
the set-up's parts and what the window counted.

A machine without CUDA, or with fewer cards than the cell asks for, gets
exit code 2 and no result; a run whose process holds JAX or the JAX
package once the window has closed gets exit code 3 and no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "semantic_gaussians_tpu")


def cache_env(root: Path = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port builds its kernels in semantic_gaussians_torch/csrc/_build);
    no library may load JAX through its optional backends."""
    cache = root / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list:
    """Top-level names in sys.modules that are JAX's or the JAX package's,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Ctx:
    """What a traffic driver is handed, and what it reports through."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool, device, t_start: float):
        import torch

        self.cell = cell
        self.config = cell.config
        self.workload = cell.workload
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.t_start = t_start
        self.marks = [("start", t_start)]
        self.notes: Dict[str, Dict] = {}
        self.t_window: Optional[float] = None

    def sync(self) -> None:
        if self.cuda:
            import torch

            torch.cuda.synchronize(self.device)

    def mark(self, name: str) -> None:
        """The end of a part of the set-up."""
        self.marks.append((name, time.perf_counter()))

    def window_start(self) -> None:
        self.sync()
        self.t_window = time.perf_counter()

    def window_end(self) -> None:
        self.sync()

    def memory_peak(self) -> int:
        """The process's peak of device memory so far: read after the
        window and before the reference runs."""
        if not self.cuda:
            return 0
        import torch

        return int(torch.cuda.max_memory_allocated(self.device))

    def free(self) -> None:
        import gc

        gc.collect()
        if self.cuda:
            import torch

            torch.cuda.empty_cache()

    def note(self, name: str, **values) -> None:
        self.notes[name] = values

    def setup_parts(self) -> Dict[str, float]:
        out, prev = {}, self.marks[0][1]
        for name, t in self.marks[1:]:
            out[name] = t - prev
            prev = t
        if self.t_window is not None:
            out["rest"] = self.t_window - prev
        return out


def device_info(ctx: Ctx, chips: int, peak: int) -> Dict:
    if not ctx.cuda:
        return dict(platform="cpu", kind="cpu", count=chips, memory_peak_bytes=peak)
    import torch

    info = dict(platform="gpu", kind=torch.cuda.get_device_name(ctx.device), count=chips,
                memory_peak_bytes=peak)
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True)
        info["power_limit"] = out.stdout.strip().splitlines()[ctx.device.index or 0]
    except (OSError, subprocess.SubprocessError, IndexError):
        info["power_limit"] = "unknown"
    return info


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> Dict:
    """Run the cell once on `device` and return the result object (the
    run's last line). Prints the set-up's parts and the driver's notes."""
    ctx = Ctx(cell, seed, seconds, trace, device, t_start)
    rec = cell.driver().run(ctx)
    setup_s = ctx.t_window - t_start
    print(json.dumps({"setup_parts_s": ctx.setup_parts(), "setup_s": setup_s}), flush=True)
    for name, values in ctx.notes.items():
        print(json.dumps({name: values}), flush=True)
    metrics: Dict = {}
    if not trace:
        values = dict(rec["e2e"], setup_s=setup_s)
        for m in cell.end_to_end():
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for m in cell.per_layer():
            v = cell.metric_reader(m["name"]).read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    from benchmark.common.checks import passed

    checks = rec["checks"]
    device = device_info(ctx, cell.chips, rec["memory_peak_bytes"])
    result = dict(correct=passed(checks), attempted=int(rec["attempted"]),
                  failed=int(rec["failed"]), metrics=metrics, device=device)
    layer = rec.get("layer")
    if trace and layer and layer.get("trace") is not None:
        tr = layer["trace"]
        device["busy_s"] = tr.busy_s()
        device["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_ops(10), "idle_gaps": tr.idle_gaps(10)}
    result["checks"] = {name: {"value": v if math.isfinite(v) else str(v), "limit": lim}
                        for name, v, lim in checks}
    return result


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    cache_env()
    sys.path.insert(0, str(ROOT))
    from benchmark.common.manifest import Cell, load_manifest

    cell = Cell(args.workload, load_manifest(ROOT))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"no result: the cell needs {cell.chips} CUDA device(s), this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START)
    found = forbidden_modules()
    if found:
        print(f"no result: the process holds {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
