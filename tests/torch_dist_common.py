"""Spawned gloo ranks for the port's multi-device tests.

`run_ranks(fn, world, tmp_path, *args)` runs fn(rank, world, *args) on
`world` CPU processes through parallel.multihost.spawn_ranks, each with one
torch thread and a process group from a `file://` store under `tmp_path`
(no TCP port to collide between test workers), and returns their results
in rank order. Every wait is bounded (the process group's timeout and the
parent's deadline); a child's traceback is raised in the parent, and a
child that hangs or dies fails the test.

Rank functions live in modules that do not import JAX
(tests/torch_parallel_ranks.py), so the children import only torch and the
port. They return numpy arrays and Python values.
"""
import uuid

from semantic_gaussians_torch.parallel.multihost import spawn_ranks

GROUP_TIMEOUT_S = 90.0
RUN_TIMEOUT_S = 300.0


def run_ranks(fn, world, tmp_path, *args, init=True, timeout=RUN_TIMEOUT_S):
    """`init` False: the ranks get the SGTPU_* variables and fn makes the
    process group itself."""
    return spawn_ranks(
        fn, world, *args, timeout=timeout, threads=1,
        init=dict(device="cpu", timeout_s=GROUP_TIMEOUT_S) if init else None,
        coordinator=f"file://{tmp_path / f'store_{uuid.uuid4().hex}'}",
    )
