"""Process-group initialization and the collectives of the parallel layer
(the JAX package's ``parallel/dist.py``; the reference's
``dist.init_process_group("nccl"|"gloo", init_method="env://")``,
ev-YOLOv6/tools/train.py:244-253).

One process drives one device. The torch launcher's variables name the run:

    RANK / WORLD_SIZE / LOCAL_RANK + MASTER_ADDR:MASTER_PORT (torchrun)
    or COORDINATOR_ADDRESS="host:port" (the JAX package's name)

Each process then feeds its own stripe of the data (``rank`` / ``world``
are the loaders' ``shard_id`` / ``num_shards``, the DistributedSampler
replacement of data_load.py:115-117). The JAX package's TPU-pod
auto-detection (``TPU_WORKER_HOSTNAMES``, ``MEGASCALE_COORDINATOR_ADDRESS``)
has no counterpart here: a GPU launcher always sets the variables above.

The helpers at the bottom take ``group=None`` for "no process group" and
then return their input: a single-process run calls the same code.
"""
from __future__ import annotations

import datetime
import os
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
    backend: Optional[str] = None,
    timeout: Optional[datetime.timedelta] = None,
) -> Tuple[int, int]:
    """Join the process group and return ``(rank, world)``.

    The arguments resolve as in the JAX package: explicit arguments first,
    then ``RANK`` / ``WORLD_SIZE`` with ``COORDINATOR_ADDRESS`` or
    ``MASTER_ADDR:MASTER_PORT``. Without an address and a world size the
    run is single-process and no group is made: ``(0, 1)``. With them the
    group is made whatever the world size (a world of one, as ``torchrun
    --nproc-per-node 1`` gives, runs the collectives on one rank). An
    address given as an argument or as ``COORDINATOR_ADDRESS`` is reached
    by ``tcp://``; the ``MASTER_*`` pair by ``env://``.

    The backend is ``nccl`` when ``device`` is a CUDA device and ``gloo``
    on the CPU, unless ``backend`` says otherwise (gloo on the card lets
    several ranks share one card). On the card each process takes the card
    ``LOCAL_RANK`` (else its rank modulo the card count). A group that
    already exists is returned as it is. A rank whose peers never join
    fails at the group's ``timeout``; it does not go on alone."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    explicit = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    address = explicit or _env_master()
    world = num_processes or _env_int("WORLD_SIZE")
    rank = process_id if process_id is not None else _env_int("RANK")
    if not (address and world):
        return 0, 1
    rank = rank or 0
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device(local if local is not None else rank % torch.cuda.device_count())
    kwargs = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(
        backend, init_method=f"tcp://{address}" if explicit else "env://",
        rank=rank, world_size=world, **kwargs)
    return dist.get_rank(), dist.get_world_size()


def _env_master() -> Optional[str]:
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    return f"{addr}:{port}" if addr and port else None


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``x`` reduced over ``group`` (``"sum"`` or ``"max"``; ``psum`` /
    ``pmax``), in place; ``x`` itself without a group. Not differentiable:
    reduce only what carries no gradient."""
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX,
                        group=group)
    return x


def global_sum(x: torch.Tensor, group) -> torch.Tensor:
    """A detached copy of ``x`` summed over ``group``: a batch statistic
    (a count, a normaliser) of the global batch from each rank's share."""
    return x if group is None else all_reduce(x.detach().clone(), group)


def all_gather(x: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``x`` (one shape on every rank), in rank order."""
    if group is None:
        return [x]
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x.contiguous(), group=group)
    return out
