"""Cells cut to sizes a CPU test can hold (the harness's own code paths,
on the program's plain CPU versions of its kernels)."""
from benchmark.common.manifest import HERE, Cell, load_json, load_manifest


def with_held_cells() -> dict:
    """BENCHMARK.json with the entries of the cells held back
    (held_cells.json), whose drivers the tests still run."""
    m, held = load_manifest(), load_json(HERE / "held_cells.json")
    return {k: v + held.get(k, []) if isinstance(v, list) else v for k, v in m.items()}


def tiny_cell(name: str) -> Cell:
    cell = Cell(name, with_held_cells())
    c, w = cell.config, cell.workload
    c["num_gaussians"] = 3000
    if c["law"] == "room":
        c["room"].update(size_m=[3.0, 3.0, 2.0], box_min_m=[0.2, 0.2, 0.2],
                         box_max_m=[0.5, 0.5, 0.5], splat_scale=1.0)
        c["views"] = 8
    else:
        c["views"] = 9
    c.update(width=64, height=48)
    c["train"]["pair_budget"] = None if c["train"]["pair_budget"] is None else 65536
    if "distill" in c:
        c["distill"]["voxel_budget"] = 1500
    if "view" in c:
        c["view"].update(width=64, height=48)
    w.update(call_iters=20, trace_iters=20, warmup_steps=2, trace_steps=4, max_rate=20,
             sample_per_mode=1, trace_seconds=8, run_length=1)
    return cell
