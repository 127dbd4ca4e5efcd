"""Learned event representation, EST-style trainable quantization (the JAX
package's ``models/learned_repr.py``; ev-YOLOv6/yolov6/models/learned_repr.py).

:class:`ValueLayer`: an MLP (1 -> 100 -> 100 -> 1, LeakyReLU 0.1) kernel over
normalised time deltas, which :func:`pretrain_value_layer` can fit to the
trilinear kernel (:func:`trilinear_kernel`). :class:`QuantizationLayer`: for
each bin i, ``t * value_layer(t - i / (C - 1))`` of every event summed at
(polarity, bin, y, x), a (2 C)-channel trainable voxel grid that the
detector computes before its backbone when the representation is learned
(``models/yolo.py``).

The scatter is a plain ``index_add_`` over ``pol*C*H*W + bin*H*W + y*W + x``
(padding events go to a dropped slot), differentiable through torch's own
autograd, so the value layer trains with the detector. The JAX package
computes it with ``jax.ops.segment_sum``, outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..events.core import EventBlock


class ValueLayer(nn.Module):
    """Submodules ``mlp_0`` ... ``mlp_k`` carry the Flax names."""

    def __init__(self, hidden: Sequence[int] = (100, 100), negative_slope: float = 0.1):
        super().__init__()
        self.negative_slope = negative_slope
        dims = (1, *hidden, 1)
        self.n = len(dims) - 1
        for i in range(self.n):
            self.add_module(f"mlp_{i}", nn.Linear(dims[i], dims[i + 1]))

    def forward(self, x):  # x: (...,) normalised time deltas
        h = x[..., None]
        for i in range(self.n):
            h = getattr(self, f"mlp_{i}")(h)
            if i < self.n - 1:
                h = F.leaky_relu(h, self.negative_slope)
        return h[..., 0]


def trilinear_kernel(ts: torch.Tensor, num_channels: int) -> torch.Tensor:
    """The value layer's init target."""
    v = torch.where(ts > 0, 1 - (num_channels - 1) * ts, (num_channels - 1) * ts + 1)
    return torch.where(ts.abs() > 1.0 / (num_channels - 1), 0.0, v)


def pretrain_value_layer(generator: torch.Generator, num_channels: int = 12,
                         steps: int = 1000, lr: float = 1e-2,
                         layer: Optional[ValueLayer] = None) -> ValueLayer:
    """Fit a :class:`ValueLayer` (``layer``, else a new one initialised from
    ``generator`` by Flax's rules) to the trilinear kernel with Adam, on
    2000 times a step drawn uniformly from [-1, 1) by ``generator``; the
    layer lives on the generator's device. Returns the fitted layer."""
    from .yolo import init_weights_

    device = generator.device
    if layer is None:
        layer = init_weights_(ValueLayer().to(device), generator)
    opt = torch.optim.Adam(layer.parameters(), lr=lr)
    for _ in range(steps):
        ts = torch.rand(2000, generator=generator, device=device) * 2.0 - 1.0
        loss = ((layer(ts) - trilinear_kernel(ts, num_channels)) ** 2).sum()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    return layer


class QuantizationLayer(nn.Module):
    """Trainable (2 C)-channel voxelisation of raw event blocks:
    ``EventBlock`` (B, N) -> (B, H, W, 2 C), channel ``pol * C + bin``
    (polarity 0 for p <= 0), in the value layer's dtype. Times are
    normalised by the largest valid time of each window."""

    def __init__(self, num_bins: int = 12, height: int = 240, width: int = 304):
        super().__init__()
        self.num_bins, self.height, self.width = num_bins, height, width
        self.value_layer = ValueLayer()

    def forward(self, blocks: EventBlock) -> torch.Tensor:
        C, H, W = self.num_bins, self.height, self.width
        b = blocks.x.shape[0]
        mask = blocks.mask
        t = blocks.t.to(self.value_layer.mlp_0.weight.dtype)
        t_max = torch.where(mask, t, 0.0).amax(dim=1, keepdim=True)
        t_n = t / t_max.clamp_min(1e-9)
        base = ((blocks.p > 0).to(torch.int64) * (C * H * W)
                + blocks.y.to(torch.int64) * W + blocks.x.to(torch.int64))
        nseg = 2 * C * H * W
        bins = torch.arange(C, device=t.device)
        # (B, N, C): every event through the value layer once a bin
        values = t_n[..., None] * self.value_layer(t_n[..., None] - bins / (C - 1))
        seg = torch.where(mask[..., None], base[..., None] + bins * (H * W), nseg)
        seg = seg + (torch.arange(b, device=t.device) * (nseg + 1))[:, None, None]
        out = torch.zeros(b * (nseg + 1), dtype=values.dtype, device=values.device)
        out = out.index_add(0, seg.reshape(-1),
                            torch.where(mask[..., None], values, 0.0).reshape(-1))
        return out.view(b, nseg + 1)[:, :nseg].reshape(b, 2 * C, H, W).permute(0, 2, 3, 1)
