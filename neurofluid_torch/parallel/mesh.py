"""A mesh of process groups over a `torch.distributed` world (port of
neurofluid_tpu/parallel/mesh.py, where the mesh is one of JAX devices).

The caller launches the world (one process per rank, `init_world` or its
own `init_process_group`); `make_mesh` lays the ranks out row-major over
named axes, the last axis fastest, as `np.reshape` lays out JAX's device
array: a 1-D mesh ('rays' or 'particles'), or the 2-D ('particles', 'rays')
grid of the composed step (neurofluid_tpu/parallel/dryrun.py
`run_composed_step`). Each axis gets one process group per line of the
grid; every rank creates every group, in the same order, as
`dist.new_group` requires, and keeps the group of its own line.

On the card the backend is NCCL and each rank drives `cuda:<local rank>`;
gloo on the CPU is taken only when the caller asks for device "cpu". A
failing NCCL raises: nothing falls back to gloo.
"""

from __future__ import annotations

import itertools
import math
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from neurofluid_torch.cuda import resolve_device


def backend_for(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(rank: int, device="cuda") -> torch.device:
    """The device a rank drives: `cuda:<local rank>` (LOCAL_RANK, else the
    rank modulo the visible cards), or the CPU when asked."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
    return torch.device("cuda", local)


def init_world(rank: int, world_size: int, init_method: str,
               device="cuda") -> torch.device:
    """`init_process_group` for this rank on the backend of `device`
    (NCCL for the card, gloo for the CPU); returns the rank's device."""
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(dev), init_method=init_method,
                            rank=rank, world_size=world_size)
    return dev


@dataclass(frozen=True)
class Mesh:
    """This rank's view of the mesh: the axes' names and sizes, its
    coordinate and its process group along each axis, the group of the
    whole mesh, and its device."""

    axis_names: tuple
    shape: tuple
    coords: tuple
    groups: tuple
    world: object
    device: torch.device

    def _axis(self, name: str) -> int:
        if name not in self.axis_names:
            raise KeyError(f"mesh has axes {self.axis_names}, not {name!r}")
        return self.axis_names.index(name)

    def size(self, name: str) -> int:
        return self.shape[self._axis(name)]

    def index(self, name: str) -> int:
        return self.coords[self._axis(name)]

    def group(self, name: str):
        return self.groups[self._axis(name)]


def make_mesh(shape=None, axis_names=("rays",), device="cuda") -> Mesh:
    """The mesh of `shape` (default: the whole world on one axis) over the
    initialised world. `device` must match the world's backend: a CUDA
    device needs NCCL, the CPU gloo."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed "
                           "world (init_world or init_process_group)")
    dev = rank_device(dist.get_rank(), device)
    want, have = backend_for(dev), dist.get_backend()
    if have != want:
        raise RuntimeError(f"device {dev} needs the {want} backend; the "
                           f"world runs {have}")
    axis_names = (axis_names,) if isinstance(axis_names, str) else tuple(
        axis_names)
    world_size = dist.get_world_size()
    shape = (world_size,) if shape is None else (
        (shape,) if isinstance(shape, int) else tuple(shape))
    if len(shape) != len(axis_names):
        raise ValueError(f"shape {shape} does not name axes {axis_names}")
    if math.prod(shape) != world_size:
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks; the "
                         f"world has {world_size}")
    rank = dist.get_rank()
    coords = _unravel(rank, shape)
    groups = []
    for ax in range(len(shape)):
        mine = None
        # one group per line along `ax`, in the same order on every rank
        others = [range(n) for i, n in enumerate(shape) if i != ax]
        for rest in itertools.product(*others):
            ranks = [_ravel(rest[:ax] + (j,) + rest[ax:], shape)
                     for j in range(shape[ax])]
            g = dist.new_group(ranks)
            if rank in ranks:
                mine = g
        groups.append(mine)
    world = groups[0] if len(shape) == 1 else dist.new_group(
        list(range(world_size)))
    return Mesh(axis_names, shape, coords, tuple(groups), world, dev)


def _ravel(coords: tuple, shape: tuple) -> int:
    r = 0
    for c, n in zip(coords, shape):
        r = r * n + c
    return r


def _unravel(rank: int, shape: tuple) -> tuple:
    out = []
    for n in reversed(shape):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))
