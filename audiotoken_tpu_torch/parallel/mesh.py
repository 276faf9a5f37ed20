"""The device mesh: the ranks of a ``torch.distributed`` job laid out as a
grid with named axes.

Counterpart of ``audiotoken_tpu/parallel/mesh.py:make_mesh``. JAX runs one
process over many devices and builds its mesh from ``jax.devices()``;
PyTorch runs one process per device, so the mesh here is built over the
ranks of the default process group, which the caller initialises first
(``torch.distributed.init_process_group``, or a launch through
``torchrun --nproc-per-node N``): NCCL for CUDA devices, gloo for the CPU.
Rank r sits at the row-major position r of the grid, as device r of a JAX
mesh does. Each axis has one process group per line of ranks along it;
every rank holds the group of its own line.
"""

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .hosts import shard_files_for_host  # noqa: F401  (JAX's parallel.mesh has it too)


class Axis:
    """One mesh axis as seen from this rank: its process group (None when
    the axis has one rank, where every collective is the identity), its
    size and this rank's index along it."""

    def __init__(self, name: str, group, size: int, index: int):
        self.name, self.group, self.size, self.index = name, group, size, index

    def __repr__(self):
        return f"Axis({self.name!r}, size={self.size}, index={self.index})"


def single_axis(name: str) -> Axis:
    """An axis of one rank: what a model that is not split runs on."""
    return Axis(name, None, 1, 0)


class Mesh:
    """A grid of ranks with named axes, on ``device`` (this rank's).

    ``shape`` maps each axis name to its size, in axis order, as JAX's
    ``dict(mesh.shape)`` does; ``axis(name)`` gives this rank's
    :class:`Axis`; ``size`` is the number of ranks."""

    def __init__(self, grid_shape: Tuple[int, ...], axis_names: Tuple[str, ...],
                 device: torch.device):
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, grid_shape))
        self.size = int(np.prod(grid_shape))
        self.rank = dist.get_rank()
        self.device = device
        grid = np.arange(self.size).reshape(grid_shape)
        coords = np.unravel_index(self.rank, grid_shape)
        self._axes = {}
        for i, name in enumerate(self.axis_names):
            group = None
            if grid_shape[i] > 1:
                # every rank creates every group, in the same order
                for line in np.moveaxis(grid, i, -1).reshape(-1, grid_shape[i]):
                    g = dist.new_group([int(r) for r in line])
                    if self.rank in line:
                        group = g
            self._axes[name] = Axis(name, group, grid_shape[i], int(coords[i]))

    def axis(self, name: str) -> Axis:
        """This rank's view of axis ``name``; an axis the mesh lacks is a
        single rank (as JAX's ``dict(mesh.shape).get(name, 1)``)."""
        return self._axes.get(name) or single_axis(name)

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank}, device={self.device})"


def _local_device(device) -> torch.device:
    """The caller's device for this rank: a CUDA device without an index is
    the card of the rank's local index (``LOCAL_RANK``, which torchrun sets,
    else the rank modulo the cards of the host). A CUDA device becomes the
    process's current one: NCCL's object collectives and barrier use it."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: device 'cuda' requested but CUDA is not available; "
                           "pass device='cpu' for a gloo mesh on the CPU")
    if device.index is None:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
        device = torch.device("cuda", local)
    torch.cuda.set_device(device)
    return device


def make_mesh(axis_names: Tuple[str, ...] = ("dp", "tp"),
              shape: Optional[Tuple[int, ...]] = None, device="cuda") -> Mesh:
    """A :class:`Mesh` over every rank of the initialised default process
    group.

    Without ``shape`` the ranks are factored as JAX's ``make_mesh`` factors
    devices: with one axis, all of them; else the largest power of two that
    divides the world size, capped at 4, goes to the second axis ("tp") and
    the rest to the first. A shape whose product is not the world size is a
    ValueError. Raises when no process group is initialised: the mesh never
    starts one and never stands in for a world of one."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh: no torch.distributed process group is initialised; call "
            "torch.distributed.init_process_group(backend, ...) first (nccl for CUDA, gloo "
            "for the CPU), or launch with torchrun --nproc-per-node N")
    shape = mesh_shape(dist.get_world_size(), axis_names, shape)
    return Mesh(shape, tuple(axis_names), _local_device(device))


def mesh_shape(n: int, axis_names: Tuple[str, ...], shape: Optional[Tuple[int, ...]] = None
               ) -> Tuple[int, ...]:
    """:func:`make_mesh`'s grid for ``n`` ranks: ``shape`` checked, or the
    default factoring."""
    if shape is None:
        if len(axis_names) == 1:
            shape = (n,)
        else:
            tp = 1
            while tp < 4 and n % (tp * 2) == 0:
                tp *= 2
            shape = (n // tp, tp) + (1,) * (len(axis_names) - 2)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not name {len(axis_names)} axes {axis_names}")
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    return shape


def check_mesh(mesh) -> None:
    """Refuse a ``mesh`` that is not a :class:`Mesh`, with the exception
    type the JAX package raises for it (AttributeError: its code reads
    ``mesh.size`` and ``mesh.shape``)."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise AttributeError(f"mesh must be a parallel.mesh.Mesh (make_mesh), "
                             f"got {type(mesh).__name__}")
