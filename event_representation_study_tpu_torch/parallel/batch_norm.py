"""Train-mode BatchNorm over the GLOBAL batch of a data-parallel step.

JAX's sharded jit normalises each channel with the mean and variance of the
whole batch across the data mesh, and its running statistics follow them.
Here each rank holds its share of the batch, so :class:`GlobalBatchNorm2d`
all-reduces each channel's count and sum, then its centred sum of squares
(two passes, as a one-device batch norm; a sum of squares minus the squared
sum would lose the variance of a channel with a large mean), and in the
backward the two sums of the input gradient's formula. Its running
statistics take the biased global variance, as the port's
``models/layers.py::BatchNorm2d`` (Flax's rule); eval mode is that class's.

``torch.nn.SyncBatchNorm`` does not serve: it refuses CPU tensors (the
gloo tests) and keeps torch's unbiased running variance. This is plain
torch and collectives; the same code runs on the card and on the CPU.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from ..models.layers import BatchNorm2d


class _GlobalBatchNorm(torch.autograd.Function):
    """y = (x - mean) / sqrt(var + eps) * weight + bias with the global
    batch's per-channel mean and biased variance. Returns (y, mean, var);
    the statistics carry no gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        xf = x.float()
        dims = (0, 2, 3)
        stats = torch.cat([xf.sum(dims), xf.new_full((1,), xf.numel() / x.shape[1])])
        dist.all_reduce(stats, group=group)
        n = stats[-1]
        mean = stats[:-1] / n
        d = xf - mean[None, :, None, None]
        var = (d * d).sum(dims)
        dist.all_reduce(var, group=group)
        var = var / n
        invstd = torch.rsqrt(var + eps)
        xhat = d * invstd[None, :, None, None]
        ctx.save_for_backward(xhat, weight, invstd, n)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        y = xhat * weight[None, :, None, None] + bias[None, :, None, None]
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        xhat, weight, invstd, n = ctx.saved_tensors
        g = gy.float()
        dims = (0, 2, 3)
        g_sum, gx_sum = g.sum(dims), (g * xhat).sum(dims)
        # the parameters' gradients are this rank's share: the step's
        # gradient all-reduce adds them up
        sums = torch.cat([g_sum, gx_sum])
        dist.all_reduce(sums, group=ctx.group)
        c = g_sum.shape[0]
        mean_g = (sums[:c] / n)[None, :, None, None]
        mean_gx = (sums[c:] / n)[None, :, None, None]
        dx = (g - mean_g - xhat * mean_gx) * (weight * invstd)[None, :, None, None]
        return dx.to(gy.dtype), gx_sum, g_sum, None, None


class GlobalBatchNorm2d(BatchNorm2d):
    """The port's BatchNorm2d whose train mode normalises by the statistics
    of the batch over every rank of ``group``."""

    group = None

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        y, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias, self.eps, self.group)
        if self.track_running_stats:
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
        return y


def convert_global_batch_norm(model: nn.Module, group) -> nn.Module:
    """Replace every BatchNorm2d of ``model`` in place by a
    :class:`GlobalBatchNorm2d` over ``group`` that shares its parameters
    and statistics (the same tensors: an optimizer, an EMA and a checkpoint
    see no change). Idempotent; returns ``model``."""
    for parent in list(model.modules()):
        for name, child in list(parent.named_children()):
            if isinstance(child, GlobalBatchNorm2d):
                child.group = group
            elif isinstance(child, BatchNorm2d):
                bn = GlobalBatchNorm2d(child.num_features, child.eps, child.momentum,
                                       child.affine, child.track_running_stats,
                                       device="meta")
                for k in ("weight", "bias"):
                    setattr(bn, k, getattr(child, k))
                for k in ("running_mean", "running_var", "num_batches_tracked"):
                    bn.register_buffer(k, getattr(child, k))
                bn.train(child.training)
                bn.group = group
                setattr(parent, name, bn)
    return model
