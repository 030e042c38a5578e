r"""Multi-process runtime: process-group init, (node, rank) meshes,
primary-only I/O.

Port of semantic_gaussians_tpu.parallel.multihost for torch.distributed,
one process per device:

  * `init_distributed()` makes the default process group from explicit
    arguments, the SGTPU_* variables or a launcher's RANK / WORLD_SIZE /
    LOCAL_RANK / MASTER_ADDR / MASTER_PORT (torchrun's), and binds a CUDA
    rank to its card first;
  * `make_data_mesh()`: a 1D mesh over every rank (view-DP);
  * `make_view_band_mesh()`: a 2D (view = node, band = rank in the node)
    mesh: each node trains its own view, whose tile bands are split over
    the node's cards, so the per-pixel traffic stays inside a node and only
    parameter gradients cross nodes, once a step;
  * `is_primary()` / `primary_only` / `primary_print` keep logging and
    PLY / checkpoint writes on rank 0;
  * `spawn_ranks()` runs a function on spawned ranks of this machine and
    returns their results, within a bounded time (tests, rehearsals).
Every rank computes alike; only rank 0 writes.

Launch on two nodes of G cards each (one process a card; LOCAL_WORLD_SIZE
is the ranks a node):
    # every process, with its own SGTPU_PROC_ID = node * G + card
    SGTPU_COORDINATOR=10.0.0.1:8476 SGTPU_NUM_PROCS=<2G> SGTPU_PROC_ID=<id> \
    LOCAL_RANK=<card> LOCAL_WORLD_SIZE=<G> \
    python -m semantic_gaussians_torch.cli.train cfg.yaml pipeline.distributed=true
or with a launcher that sets RANK / WORLD_SIZE / LOCAL_RANK /
LOCAL_WORLD_SIZE / MASTER_ADDR / MASTER_PORT:
    torchrun --nnodes 2 --nproc-per-node G ... -m semantic_gaussians_torch.cli.train \
        cfg.yaml pipeline.distributed=true
`python -m semantic_gaussians_torch.tools.launch_multihost` rehearses the
SGTPU_* path with CPU processes on one machine.
"""
from __future__ import annotations

import datetime
import functools
import multiprocessing
import os
import queue
import tempfile
import time
import traceback
import uuid
from pathlib import Path
from typing import Callable, List, Optional, Union

import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from .collectives import all_gather
from .mesh import Mesh, make_mesh_of

DEFAULT_TIMEOUT_S = 600.0


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v in (None, "") else int(v)


def init_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device: Union[str, torch.device, None] = None,
    backend: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> bool:
    """Make the default process group. Returns True if one was made.

    Sources, in order: the arguments; SGTPU_COORDINATOR ("host:port", or an
    init URL such as file:///path) / SGTPU_NUM_PROCS / SGTPU_PROC_ID; a
    launcher's MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK. With none of
    them it does nothing (one process, every mesh of size 1).

    `device` is resolved as the entry points resolve it (CUDA unless the
    CPU is asked for). A CUDA rank is bound to card LOCAL_RANK (modulo the
    cards it sees) before the group exists, or to `device`'s index if it
    names one. The backend is `backend` if given, else NCCL for CUDA and
    gloo for the CPU. A collective that waits longer than `timeout_s`
    fails."""
    coordinator = coordinator or os.environ.get("SGTPU_COORDINATOR")
    if coordinator is not None:
        if num_processes is None:
            num_processes = _env_int("SGTPU_NUM_PROCS")
        if process_id is None:
            process_id = _env_int("SGTPU_PROC_ID")
    elif os.environ.get("MASTER_ADDR") and os.environ.get("WORLD_SIZE"):
        coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
        num_processes = _env_int("WORLD_SIZE") if num_processes is None else num_processes
        process_id = _env_int("RANK") if process_id is None else process_id
    else:
        return False
    if num_processes is None or process_id is None:
        raise ValueError(f"coordinator {coordinator} needs the process count and this "
                         "process's id (SGTPU_NUM_PROCS / SGTPU_PROC_ID)")
    dev = resolve_device(device)
    if dev.type == "cuda":
        index = dev.index
        if index is None:
            index = _env_int("LOCAL_RANK")
            index = (process_id if index is None else index) % torch.cuda.device_count()
        torch.cuda.set_device(index)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(
        backend, init_method=url, world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return True


def rank_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """The device this rank runs on: the CPU if asked for, else the CUDA
    card init_distributed bound (the current one)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def is_primary() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def primary_only(fn):
    """Run `fn` only on rank 0 (logging, checkpoint, PLY writes)."""

    @functools.wraps(fn)
    def wrapped(*a, **k):
        if is_primary():
            return fn(*a, **k)
        return None

    return wrapped


def primary_print(*a, **k):
    if is_primary():
        print(*a, **k)


def make_data_mesh(axis_name: str = "data") -> Mesh:
    """1D mesh over every rank (view-DP across nodes and cards)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh_of((world,), (axis_name,))


def make_view_band_mesh(
    axis_view: str = "view", axis_band: str = "band", ranks_per_node: Optional[int] = None
) -> Mesh:
    """2D (node, rank in the node) mesh: views across nodes, tile bands
    across a node's ranks. `ranks_per_node` defaults to LOCAL_WORLD_SIZE,
    else the whole world (one node)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    per_node = ranks_per_node or _env_int("LOCAL_WORLD_SIZE") or world
    if world % per_node:
        raise ValueError(f"{world} ranks not divisible by {per_node} ranks a node")
    return make_mesh_of((world // per_node, per_node), (axis_view, axis_band))


def global_batch_from_local(local, mesh: Mesh, axis: str):
    """The global batch from each rank's local share: every tensor of
    `local` (a tensor, or a dict / list / tuple of them; leading dim = this
    rank's share) gathered over `axis` in coordinate order, so the leading
    dim becomes axis size x local. One rank: the tensors as given."""
    if isinstance(local, torch.Tensor):
        return all_gather(local, mesh, axis)
    if isinstance(local, dict):
        return {k: global_batch_from_local(v, mesh, axis) for k, v in local.items()}
    return type(local)(global_batch_from_local(v, mesh, axis) for v in local)


def _rank_main(rank, world, coordinator, fn, args, results, init, local, threads):
    """One rank of spawn_ranks: fn's result, or its traceback, goes to the
    parent; a failure also exits non-zero."""
    if threads:
        torch.set_num_threads(threads)
    try:
        if init is None:  # fn makes the group itself, from the launch variables
            os.environ.update(SGTPU_COORDINATOR=coordinator, SGTPU_NUM_PROCS=str(world),
                              SGTPU_PROC_ID=str(rank), LOCAL_RANK=str(rank % local),
                              LOCAL_WORLD_SIZE=str(local))
        else:
            init_distributed(coordinator, world, rank, **init)
        results.put((rank, "ok", fn(rank, world, *args)))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(
    fn: Callable,
    world: int,
    *args,
    timeout: float,
    init: Optional[dict] = None,
    coordinator: Optional[str] = None,
    local: Optional[int] = None,
    threads: Optional[int] = None,
) -> List:
    """Run fn(rank, world, *args) on `world` spawned processes of this
    machine and return the results in rank order.

    `init` given: each rank first calls init_distributed(coordinator,
    world, rank, **init). `init` None: each rank gets the SGTPU_* launch
    variables, with LOCAL_RANK = rank % local and LOCAL_WORLD_SIZE = local
    (`local` defaults to `world`: one node), and fn makes the group. The
    coordinator defaults to a file:// store in the temporary directory,
    removed at the end. `threads` sets each rank's torch thread count.

    Every wait is bounded: set init's `timeout_s` for the group, and the
    parent waits at most `timeout` seconds for the results. A rank's
    traceback is raised in the parent (RuntimeError), as is a rank that
    exits without a result or non-zero; silence past `timeout` raises
    TimeoutError. Every process is stopped before this returns or raises.
    `fn` and `args` must pickle (fn at a module's top level)."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    store = None
    if coordinator is None:
        store = Path(tempfile.gettempdir()) / f"sgtpu_store_{uuid.uuid4().hex}"
        coordinator = f"file://{store}"
    procs = [ctx.Process(target=_rank_main, args=(r, world, coordinator, fn, args, results,
                                                   init, local or world, threads))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(world)) - set(got))} gave no "
                                   f"result in {timeout} s")
            try:
                rank, status, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got]
                if dead:
                    raise RuntimeError(f"ranks {dead} exited with codes "
                                       f"{[procs[r].exitcode for r in dead]} and no result")
                continue
            if status != "ok":
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            got[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
        if store is not None:
            store.unlink(missing_ok=True)
    bad = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode != 0}
    if bad:
        raise RuntimeError(f"ranks exited with codes {bad}")
    return [got[r] for r in range(world)]
