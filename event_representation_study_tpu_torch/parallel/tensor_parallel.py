"""Tensor parallelism for the detector: output-channel sharding over a
``"model"`` mesh axis (the JAX package's ``parallel/tensor_parallel.py``).

The rule is JAX's: a weight of rank >= 2 whose OUTPUT-channel dimension
divides by the axis size is split along it; vectors and scalars are
replicated. In torch that dimension is dim 0 (a convolution's OIHW
weight, a Linear's (out, in)), where Flax's HWIO / (in, out) kernels carry
it last. JAX places the leaves and lets XLA insert the collectives; here
:func:`shard_state_tp` replaces each such ``nn.Conv2d`` (ungrouped) and
``nn.Linear`` by a column-parallel module holding its rows of the weight
and bias. The module computes its channel slice of the output from the
full input and all-gathers the full activation (:class:`_GatherChannels`,
whose backward keeps the rank's slice of the gradient), and its input's
gradient is summed over the axis (:class:`_SumGrad`), since each rank
computes only its channels' part of it. Everything else runs replicated,
so every rank computes the same loss. Grouped convolutions and transposed
convolutions stay replicated. The optimizer's momentum (and accumulator)
and the EMA follow the parameters leaf for leaf, so the update and the EMA
blend run on the shards; a data-parallel step over the mesh's "data" axis
then gives dp x tp.

DTensor cannot stand in: its convolution rules take a replicated weight
only. The JAX package's own note (NOTES.md) expects dp x tp to lose to
pure data parallelism for this CNN: this is a port for completeness, not a
speed path.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .dist import all_gather, all_reduce


def tp_spec_for(shape, tp: int, axis: str = "model") -> Tuple:
    """The output-channel rule: ``(axis, None, ...)`` (dim 0 split over
    ``axis``) for a leaf of rank >= 2 whose dim 0 divides by ``tp``, else
    ``()`` (replicated), as JAX's ``PartitionSpec``."""
    if len(shape) >= 2 and shape[0] % tp == 0 and shape[0] >= tp:
        return (axis,) + (None,) * (len(shape) - 1)
    return ()


class _SumGrad(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _GatherChannels(torch.autograd.Function):
    """Every rank's channel slice concatenated along ``dim``; the backward
    keeps this rank's slice of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, y, group, dim):
        ctx.dim, ctx.rank, ctx.width = dim, dist.get_rank(group), y.shape[dim]
        return torch.cat(all_gather(y, group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.width, ctx.width), None, None


class ColumnParallelConv2d(nn.Conv2d):
    """An ungrouped ``nn.Conv2d`` holding this rank's output channels."""

    group = None

    def forward(self, x):
        y = self._conv_forward(_SumGrad.apply(x, self.group), self.weight, self.bias)
        return _GatherChannels.apply(y, self.group, 1)


class ColumnParallelLinear(nn.Linear):
    """An ``nn.Linear`` holding this rank's output features."""

    group = None

    def forward(self, x):
        y = F.linear(_SumGrad.apply(x, self.group), self.weight, self.bias)
        return _GatherChannels.apply(y, self.group, -1)


def _column_parallel(child: nn.Module, tp: int, rank: int, group):
    """The column-parallel twin of ``child`` with its rows, or None where
    the rule keeps it replicated."""
    conv = type(child) is nn.Conv2d and child.groups == 1
    if not (conv or type(child) is nn.Linear):
        return None
    w = child.weight
    if not tp_spec_for(tuple(w.shape), tp):
        return None
    k = w.shape[0] // tp
    rows = slice(rank * k, (rank + 1) * k)
    if conv:
        new = ColumnParallelConv2d(child.in_channels, k, child.kernel_size, child.stride,
                                   child.padding, child.dilation, 1, child.bias is not None,
                                   child.padding_mode, device="meta")
    else:
        new = ColumnParallelLinear(child.in_features, k, child.bias is not None, device="meta")
    new.weight = nn.Parameter(w.detach()[rows].clone(), requires_grad=w.requires_grad)
    if child.bias is not None:
        new.bias = nn.Parameter(child.bias.detach()[rows].clone(),
                                requires_grad=child.bias.requires_grad)
    new.group = group
    new.train(child.training)
    return new


def shard_state_tp(state: Any, mesh, axis: str = "model") -> Any:
    """Shard a port ``TrainState`` over ``mesh``'s ``axis`` in place: every
    convolution and Linear that :func:`tp_spec_for` splits becomes a
    column-parallel module with this rank's rows, and the optimizer's
    momentum (and gradient accumulator) and the EMA entries of its weight
    and bias keep the same rows. Names stay as they were. Every sharded
    tensor is tagged ``tp_axis`` (:func:`count_tp_sharded`). Returns
    ``state``; a mesh axis of size 1 leaves it as it is."""
    tp, rank, group = mesh.size(axis), mesh.index(axis), mesh.group(axis)
    if tp == 1:
        return state
    model = state.model
    rows = {}  # parameter name -> the rows this rank keeps
    for prefix, parent in list(model.named_modules()):
        for name, child in list(parent.named_children()):
            new = _column_parallel(child, tp, rank, group)
            if new is None:
                continue
            setattr(parent, name, new)
            k = new.weight.shape[0]
            for leaf in ("weight", "bias"):
                if getattr(new, leaf) is not None:
                    rows[f"{prefix}.{name}.{leaf}".lstrip(".")] = slice(rank * k, (rank + 1) * k)
    params = dict(model.named_parameters())
    opt = state.opt_state
    inner = getattr(opt, "inner", opt)  # train/optim.py: MultiSteps wraps FusedSGD
    inner.params = params
    buffers = [inner.momentum, getattr(opt, "acc", None), state.ema.variables]
    for n, r in rows.items():
        params[n].tp_axis = axis
        for d in buffers:
            if d is not None and n in d:
                d[n] = d[n][r].clone()
                d[n].tp_axis = axis
    return state


def count_tp_sharded(obj: Any, axis: str = "model") -> int:
    """The number of tensors sharded over ``axis`` in a module's parameters,
    an optimizer's state (momentum, accumulator), a dict of tensors (an
    EMA) or a whole ``TrainState``."""
    if hasattr(obj, "opt_state") and hasattr(obj, "model"):
        return sum(count_tp_sharded(o, axis) for o in (obj.model, obj.opt_state,
                                                         obj.ema.variables))
    if isinstance(obj, nn.Module):
        leaves = list(obj.parameters())
    elif isinstance(obj, dict):
        leaves = list(obj.values())
    else:
        inner = getattr(obj, "inner", obj)
        leaves = [*inner.momentum.values(), *getattr(obj, "acc", {}).values()]
    return sum(getattr(t, "tp_axis", None) == axis for t in leaves)
