"""The comparisons that decide `correct`: each number beside its limit.

Training: each check step's loss, and quantities kept by leaf (a
gradient, Adam's first moment, the change of the parameters over the check
steps), each taken by the worst leaf as the gap between the program's norm
and the reference's, over the reference's norm of that leaf or of the
median leaf, whichever is larger. Leaves whose first reference gradient is
under a thousandth of the median leaf's move by round-off alone and are
left out.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence, Tuple

Check = Tuple[str, float, float]  # (name, value, limit)
NEGLIGIBLE = 1e-3  # a leaf whose gradient is under this share of the median's


def _finite(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keep: Sequence[str]) -> float:
    med = statistics.median(ref[k] for k in keep)
    return max(_finite(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)) for k in keep)


def training_checks(losses: Sequence[float], leaves: Dict[str, Dict[str, float]], ref: Dict,
                    limits: Dict) -> List[Check]:
    """`leaves` maps a quantity's name to the program's norms by leaf; the
    reference holds its own under `<name>_norms`, and the number compared
    is `<name>_gap`."""
    med = statistics.median(ref["grad_norms"].values())
    keep = [k for k, v in ref["grad_norms"].items() if v >= NEGLIGIBLE * med]
    numbers = dict(
        loss_gap=max(_finite(abs(a - b) / abs(b)) for a, b in zip(losses, ref["losses"])))
    for name, prog in leaves.items():
        numbers[f"{name}_gap"] = leaf_gap(prog, ref[f"{name}_norms"], keep)
    # a cell compares the numbers its limits name (PERF.md says why one is left out)
    return [(k, v, limits[k]) for k, v in numbers.items() if k in limits]


def passed(checks: Sequence[Check]) -> bool:
    return all(math.isfinite(v) and v <= lim for _, v, lim in checks)
