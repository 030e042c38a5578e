"""The phase table of a train cell's traced window.

    python3 -m benchmark.tools.phase_table --workload <cell> --seed <n> [--out <file>]

Runs the cell once as `--trace 1` runs it, on the card, and prints one JSON
line: the traced steps and wall; for each phase of the program's markers
(common/phases.py) its busy ms, device operations and inner gap ms a step;
the inner gaps a step by the host event running at their middle; the
dispatch gaps a step by `sgt.` host span, and the longest with the host
events running at their middle; the sum of all against the
wall, and the gaps against `train.idle_share` x wall; the six per-layer
numbers the phase readers give; the dispatches by marker order (k-step
graph or eager step, and whether the phases follow the step's table); and
for each phase its largest device items by name, with the phases that
hold the items named in NAMED. `--out` writes the line to a file too.
"""
from __future__ import annotations

import argparse
import bisect
import json
import sys
import time
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[2]
STEP = ["project", "bin", "composite", "loss", "loss_bwd", "composite_bwd", "segsum",
        "project_bwd", "update"]
NAMED = ("gemmSN_TN", "gemv2N", "gemvx", "CatArrayBatchedCopy", "elementwise_kernel",
         "reduce_kernel", "composite_bwd_kernel", "segsum_kernel", "expand_kernel")
READERS = ("train.project_ms", "train.bin_ms", "train.loss_ms", "train.update_ms",
           "train.inner_gap_ms", "train.dispatch_gap_ms")


def dispatches(markers: List[str]) -> Dict[str, int]:
    """The marker sequence cut after each `between`, repeats collapsed:
    how many dispatches of each kind, "<k>-step graph" (the step's phases k
    times, then `carry`) or "<k>-step eager"; "out of order" is added to
    a kind whose phases do not follow the table."""
    out: Dict[str, int] = {}
    cur: List[str] = []
    for p in markers:
        if not cur or cur[-1] != p:
            cur.append(p)
        if p != "between":
            continue
        body = cur[:-1]
        graph = body[-1:] == ["carry"]
        body = body[:-1] if graph else body
        k = len(body) // len(STEP)
        kind = f"{k}-step {'graph' if graph else 'eager'}"
        if not k or body != STEP * k:
            kind += " out of order"
        out[kind] = out.get(kind, 0) + 1
        cur = []
    if cur:
        out["unfinished"] = 1
    return out


def table(rec: Dict, workload: str) -> Dict:
    from benchmark.common import phases as P
    from benchmark.common.manifest import Cell, load_manifest
    from benchmark.metrics.counts import idle_share

    layer = rec["layer"]
    tr, steps = layer["trace"], layer["steps"]
    s = P.split(tr)
    if s is None:
        return dict(error="no phase marker in the traced window")
    wall_ms = tr.window_s * 1e3 / steps
    per = lambda us: us / steps / 1e3  # noqa: E731
    names: Dict[str, Dict[str, float]] = {}
    for phase, _, dur, name in P.phased(tr.device):
        d = names.setdefault(phase, {})
        d[name] = d.get(name, 0.0) + dur
    top = {ph: [[n[:100], per(v)] for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:8]]
           for ph, d in names.items()}
    named = {}
    for sub in NAMED:
        by = {ph: per(sum(v for n, v in d.items() if sub in n)) for ph, d in names.items()}
        named[sub] = {ph: v for ph, v in sorted(by.items(), key=lambda kv: -kv[1]) if v > 0}
    busy = sum(s.busy_us.values())
    idle = idle_share(rec) / 100 * wall_ms
    cell = Cell(workload, load_manifest(ROOT))
    return dict(
        steps=steps, wall_ms=wall_ms, busy_ms=per(busy),
        phases={ph: dict(busy_ms=per(s.busy_us.get(ph, 0.0)), ops=s.ops.get(ph, 0) / steps,
                         inner_gap_ms=per(s.inner_us.get(ph, 0.0)))
                for ph in STEP + ["carry", "between"]},
        dispatch_gap_ms={k: per(v) for k, v in sorted(s.dispatch_us.items(), key=lambda kv: -kv[1])},
        inner_gap_ms=s.inner_ms(steps), dispatch_gap_ms_total=s.dispatch_ms(steps),
        sum_over_wall=(busy + sum(s.inner_us.values()) + sum(s.dispatch_us.values()))
        / (tr.window_s * 1e6),
        gaps_over_idle=(s.inner_ms(steps) + s.dispatch_ms(steps)) / idle if idle > 0 else None,
        outside_share=s.dispatch_us.get(P.OUTSIDE, 0.0) / max(sum(s.dispatch_us.values()), 1e-9),
        metrics={m: cell.metric_reader(m).read(rec) for m in READERS},
        inner_gap_ms_by_host=inner_by_host(tr, s, steps), clock_shift_us=s.shift_us,
        dispatches=dispatches(s.markers), clock_us=clock(tr), largest_dispatch_gaps=largest(tr, s),
        named_ms=named, top_ms=top)


def largest(tr, s, k: int = 8) -> List[Dict]:
    """The `k` longest dispatch gaps: start and length in microseconds
    (from the first device event), their `sgt.` span, and the innermost
    host events of any kind running at their middle."""
    first = tr.device[0][0]
    out = []
    for a, b, label in sorted(s.dispatch_gaps, key=lambda g: g[0] - g[1])[:k]:
        out.append(dict(start=a - first, us=b - a, span=label,
                        host=host_at(tr, 0.5 * (a + b) + s.shift_us)[:3]))
    return out


def host_at(tr, t: float) -> List[str]:
    """The host events of any kind running at host time `t`, innermost
    first."""
    return [h[2][:60] for h in sorted((h for h in tr.host if h[0] <= t <= h[0] + h[1]),
                                      key=lambda h: -h[0])]


def inner_by_host(tr, s, steps: int, k: int = 8) -> Dict[str, float]:
    """Inner gaps, ms a step, by the innermost host event running at each
    gap's middle (where the host was while the device waited inside a
    dispatch); the `k` largest."""
    starts = [h[0] for h in tr.host]
    out: Dict[str, float] = {}
    for a, b, _ in s.inner_gaps:
        t = 0.5 * (a + b) + s.shift_us
        label, i = "host, outside any traced op", bisect.bisect_right(starts, t)
        for j in range(i - 1, max(-1, i - 400), -1):
            ts, dur, name = tr.host[j]
            if ts + dur >= t:
                label = name[:60]
                break
        out[label] = out.get(label, 0.0) + (b - a) / steps / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1])[:k])


def clock(tr) -> Dict[str, float]:
    """Where the trace's events lie against the window's wall, in
    microseconds from the first device event: the first and last device
    event, `sgt.` span and device synchronize on the host."""
    first = tr.device[0][0]
    spans = [h for h in tr.host if h[2].startswith("sgt.")]
    syncs = [h for h in tr.host if h[2] == "cudaDeviceSynchronize"]
    out = dict(window=tr.window_s * 1e6, last_device_end=max(ts + d for ts, d, _ in tr.device) - first)
    if spans:
        out.update(first_span=spans[0][0] - first,
                   last_span_end=max(ts + d for ts, d, _ in spans) - first)
    if syncs:
        out.update(first_sync_end=syncs[0][0] + syncs[0][1] - first,
                   last_sync_end=syncs[-1][0] + syncs[-1][1] - first)
    return out


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.run import Ctx, cache_env

    cache_env()
    from benchmark.common.manifest import Cell, load_manifest

    import torch

    if not torch.cuda.is_available():
        print("no result: needs a CUDA device", file=sys.stderr)
        return 2
    cell = Cell(args.workload, load_manifest(ROOT))
    ctx = Ctx(cell, args.seed, 1.0, True, "cuda:0", t_start)
    rec = cell.driver().run(ctx)
    out = dict(workload=args.workload, seed=args.seed, device=torch.cuda.get_device_name(0),
               **table(rec, args.workload))
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
