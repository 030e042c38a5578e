"""Process meshes: named axes of ranks, one process per device.

Port of semantic_gaussians_tpu.parallel.mesh for torch.distributed. A JAX
mesh names axes of the devices that one program drives; here every rank is
a process of its own that runs the same host logic, so a mesh names axes
of ranks. For each axis it holds the process group of the ranks that share
this rank's coordinates on the other axes, this rank's coordinate on it
(its rank in that group) and the axis size. The collectives of
`parallel.collectives` run over an axis's group.

Without an initialized process group (a single process that no launcher
started) the mesh has one rank: every axis has size 1 and no group, and
every collective hands back its input.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from .collectives import broadcast


@dataclasses.dataclass
class Mesh:
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    coords: Tuple[int, ...]  # this rank's coordinate on each axis
    groups: Tuple[Optional[dist.ProcessGroup], ...]  # None: no process group
    # bytes handed to collectives, by operation (parallel.collectives adds
    # each call's tensor sizes; the reader resets it)
    comm_bytes: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    def _at(self, axis: str) -> int:
        if axis not in self.axis_names:
            raise KeyError(f"mesh has axes {self.axis_names}, not {axis!r}")
        return self.axis_names.index(axis)

    def size(self, axis: str) -> int:
        return self.sizes[self._at(axis)]

    def coord(self, axis: str) -> int:
        return self.coords[self._at(axis)]

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        return self.groups[self._at(axis)]

    def count(self, op: str, nbytes: int) -> None:
        self.comm_bytes[op] = self.comm_bytes.get(op, 0) + int(nbytes)


def make_mesh_of(shape: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """A mesh of `shape` over every rank of the world, rank-major in the
    order of the axes (the last axis varies fastest). Every rank must call
    it, in the same order as its other group creations."""
    shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"shape {shape} against axes {axis_names}")
    if not dist.is_initialized():
        if math.prod(shape) != 1:
            raise ValueError(
                f"a {shape} mesh needs {math.prod(shape)} ranks, but no process group is "
                "initialized (parallel.multihost.init_distributed)"
            )
        return Mesh(axis_names, shape, (0,) * len(shape), (None,) * len(shape))
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks; the world has {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(device_type, shape, mesh_dim_names=axis_names)
    groups = tuple(dm.get_group(a) for a in axis_names)
    return Mesh(axis_names, shape, tuple(dist.get_rank(g) for g in groups), groups)


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "data") -> Mesh:
    """A 1D mesh over the world's ranks (`n_devices`, if given, must be the
    world size: every process is one device)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh_of((n_devices or world,), (axis_name,))


def replicate(tensors: Sequence[torch.Tensor], mesh: Mesh) -> list:
    """Every rank's copy of `tensors` made equal to the first rank's (a
    broadcast from the world's rank 0)."""
    return [broadcast(t, mesh) for t in tensors]
