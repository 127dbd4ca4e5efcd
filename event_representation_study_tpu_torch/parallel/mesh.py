"""A named-axis mesh over the processes of a run, and batch placement (the
JAX package's ``parallel/mesh.py``).

JAX lays one process's chips out as a ``jax.sharding.Mesh`` and lets XLA
insert the collectives. Here each process drives one device, so the mesh
lays the RANKS out: ``make_mesh(axis_names=("data", "event"), shape=(2,
2))`` puts the ranks of a world of 4 on a 2 x 2 grid in row-major order,
and each axis gets one process group per line of the grid (the ranks that
share every other coordinate; the world's own group where one line holds
every rank). Collectives over an axis go to
``mesh.group(axis)``; a run without a process group has a mesh of size 1
whose groups are all ``None``, and the collectives of ``parallel/dist.py``
then do nothing.

``data_sharding`` / ``replicated`` keep JAX's names as the partition
specs (tuples of axis names, as ``tensor_parallel.tp_spec_for``'s) of a
leading-axis split and of a copy on every rank. :func:`shard_batch` takes
this rank's rows of a global batch, and :func:`device_prefetch` moves the
loader's batches to the device one item ahead of the consumer (pinned host
memory, non-blocking copies on the current stream).
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..utils.profiling import span
from .train_step import Batch, _map_batch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of a run on a named grid; this process's place on it."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    coords: Tuple[int, ...]  # this rank's index along each axis
    groups: Dict[str, Optional[object]]  # axis -> process group (None: no group)
    device: torch.device

    def size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def index(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str):
        return self.groups[axis]


def make_mesh(n_devices: Optional[int] = None, axis_names: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None, device="cuda") -> Mesh:
    """A mesh over the run's ranks. ``shape`` defaults to JAX's
    ``(n, 1, ..., 1)``; ``n_devices`` (default: the world) must be the
    world, since every rank drives one device. Every rank of the run must
    call this with the same arguments: each axis's groups are made
    collectively. ``device`` is the device this process computes on."""
    axis_names = tuple(axis_names)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices in a world of {world} processes: "
                         "each process drives one device")
    shape = tuple(shape) if shape is not None else (world,) + (1,) * (len(axis_names) - 1)
    if len(shape) != len(axis_names) or math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} over axes {axis_names} for a world of {world}")
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    rank = dist.get_rank() if dist.is_initialized() else 0
    grid = np.arange(world).reshape(shape)
    coords = tuple(int(c) for c in np.unravel_index(rank, shape))
    groups = {}
    for a, name in enumerate(axis_names):
        groups[name] = None
        if not dist.is_initialized():
            continue
        if shape[a] == world:  # one line holds every rank
            groups[name] = dist.group.WORLD
            continue
        lines = np.moveaxis(grid, a, -1).reshape(-1, shape[a])
        for line in lines:  # every rank makes every group, in one order
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[name] = g
    return Mesh(axis_names, shape, coords, groups, device)


def data_sharding(mesh: Mesh) -> Tuple[str, ...]:
    """JAX's ``P("data")``: the leading axis split over "data" (as
    :func:`shard_batch` splits it)."""
    return ("data",)


def replicated(mesh: Mesh) -> Tuple[str, ...]:
    """JAX's ``P()``: a copy on every rank."""
    return ()


def shard_batch(mesh: Mesh, batch: Batch) -> Batch:
    """This rank's rows of a global batch (every leaf's leading axis split
    in contiguous blocks over "data", as JAX's ``P("data")``), on the
    mesh's device. A strong-augmentation plan's partner rows must lie in
    the same block: plan per rank, as the Trainer's loaders do."""
    n, i = mesh.size("data"), mesh.index("data")

    def rows(x):
        if x.shape[0] % n:
            raise ValueError(f"leading dim {x.shape[0]} does not split over {n} ranks")
        k = x.shape[0] // n
        return _to_device(x[i * k:(i + 1) * k], mesh.device)

    return _map_batch(rows, batch)


def _to_device(x, device: torch.device) -> torch.Tensor:
    t = torch.as_tensor(x)
    if device.type == "cuda" and t.device.type == "cpu":
        # a non-blocking copy from pinned memory does not wait for the card
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def device_prefetch(iterator, mesh: Mesh, size: int = 2):
    """Double-buffered host-to-device staging: every array leaf of each
    Batch is on ``mesh.device`` when it is yielded, the next ``size - 1``
    items' copies already issued (the flax ``prefetch_to_device`` pattern
    of the JAX package). ``(batch, extra)`` pairs, as the loaders yield
    them, keep ``extra`` (index arrays) on the host. Dtypes are kept: the
    step's ``batch_on_device`` upcasts on the device."""
    def put(item):  # pin every leaf and start its copy
        with span("h2d/stage"):
            if isinstance(item, Batch):
                return _map_batch(lambda x: _to_device(x, mesh.device), item)
            batch, extra = item
            return _map_batch(lambda x: _to_device(x, mesh.device), batch), extra

    queue = collections.deque()
    for item in iterator:
        queue.append(put(item))  # the copy is issued now
        if len(queue) >= size:
            yield queue.popleft()
    while queue:
        yield queue.popleft()
