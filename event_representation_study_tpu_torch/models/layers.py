"""Detector blocks on the ``conv_silu`` graph, as ``nn.Module``s over NCHW
tensors (the JAX package's ``models/layers.py``, which is Flax over NHWC).

Submodules carry the Flax names (``conv``, ``bn``, ``cv1``, ``m``,
``block_0``, ``upsample``, ...), so a flattened Flax tree maps key for key
onto ``state_dict()`` (:mod:`..utils.convert`). Torch needs input widths at
construction where Flax infers them, hence the extra ``in_channels``.
BatchNorm: Flax ``momentum=0.9`` is torch ``momentum=0.1``; eps 1e-5.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

_ACTS = {"silu": F.silu, "relu": F.relu}


class ConvBNAct(nn.Module):
    """Conv(k, s, pad k//2, no bias) + BatchNorm + SiLU or ReLU."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, act: str = "silu"):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride,
                              kernel_size // 2, bias=False)
        self.bn = nn.BatchNorm2d(out_channels, eps=1e-5, momentum=0.1)
        self.act = act

    def forward(self, x):
        return _ACTS[self.act](self.bn(self.conv(x)))


def get_basic_block(mode: str):
    """training_mode -> stem/downsample block constructor
    ``(in, out, k=3, s=1)``."""
    if mode in ("conv_silu", "silu"):
        act = "silu"
    elif mode in ("conv_relu", "relu"):
        act = "relu"
    else:
        raise NotImplementedError(
            f"training_mode {mode!r} is not ported (ROADMAP M14: RepVGG family)"
        )
    return lambda cin, cout, k=3, s=1: ConvBNAct(cin, cout, k, s, act)


class Transpose(nn.Module):
    """2x ConvTranspose upsampling."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.upsample = nn.ConvTranspose2d(in_channels, out_channels, 2, 2, bias=True)

    def forward(self, x):
        return self.upsample(x)


def _maxpool_same(x, k):
    return F.max_pool2d(x, k, stride=1, padding=k // 2)


class SPPF(nn.Module):
    """Spatial pyramid pooling - fast: 1x1 -> 3 cascaded k x k maxpools ->
    concat -> 1x1."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 5,
                 act: str = "silu"):
        super().__init__()
        c_ = in_channels // 2
        self.cv1 = ConvBNAct(in_channels, c_, 1, 1, act)
        self.cv2 = ConvBNAct(4 * c_, out_channels, 1, 1, act)
        self.kernel_size = kernel_size

    def forward(self, x):
        x = self.cv1(x)
        y1 = _maxpool_same(x, self.kernel_size)
        y2 = _maxpool_same(y1, self.kernel_size)
        y3 = _maxpool_same(y2, self.kernel_size)
        return self.cv2(torch.cat([x, y1, y2, y3], dim=1))


class BottleRep(nn.Module):
    """Two basic blocks with a learnable residual scale ``alpha`` (1,) when
    the widths allow a residual."""

    def __init__(self, in_channels: int, out_channels: int,
                 basic_mode: str = "conv_silu"):
        super().__init__()
        blk = get_basic_block(basic_mode)
        self.conv1 = blk(in_channels, out_channels)
        self.conv2 = blk(out_channels, out_channels)
        self.alpha = nn.Parameter(torch.ones(1)) if in_channels == out_channels else None

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return y if self.alpha is None else y + self.alpha * x


class RepBlock(nn.Module):
    """BottleRep stage: 1 + max(n//2 - 1, 0) BottleReps (``conv1``,
    ``block_0``, ``block_1``, ...)."""

    def __init__(self, in_channels: int, out_channels: int, n: int = 1,
                 basic_mode: str = "conv_silu"):
        super().__init__()
        self.conv1 = BottleRep(in_channels, out_channels, basic_mode)
        self.n_blocks = max(n // 2 - 1, 0)
        for i in range(self.n_blocks):
            self.add_module(f"block_{i}", BottleRep(out_channels, out_channels, basic_mode))

    def forward(self, x):
        x = self.conv1(x)
        for i in range(self.n_blocks):
            x = getattr(self, f"block_{i}")(x)
        return x


class BepC3(nn.Module):
    """CSPStackRep: two 1x1 branches, a BottleRep stack on one, concat, 1x1
    out. With conv_silu the 1x1s are SiLU, else ReLU."""

    def __init__(self, in_channels: int, out_channels: int, n: int = 1,
                 e: float = 0.5, basic_mode: str = "conv_silu"):
        super().__init__()
        c_ = int(out_channels * e)
        act = "silu" if basic_mode == "conv_silu" else "relu"
        self.cv1 = ConvBNAct(in_channels, c_, 1, 1, act)
        self.m = RepBlock(c_, c_, n, basic_mode)
        self.cv2 = ConvBNAct(in_channels, c_, 1, 1, act)
        self.cv3 = ConvBNAct(2 * c_, out_channels, 1, 1, act)

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], dim=1))


class BiFusion(nn.Module):
    """3-way feature fusion: transpose-conv upsampled current level + 1x1
    same-level skip + downsampled lower-level skip, all ConvBNReLU."""

    def __init__(self, cur_channels: int, skip0_channels: int,
                 skip1_channels: int, out_channels: int):
        super().__init__()
        self.upsample = Transpose(cur_channels, out_channels)
        self.cv1 = ConvBNAct(skip0_channels, out_channels, 1, 1, "relu")
        self.cv2 = ConvBNAct(skip1_channels, out_channels, 1, 1, "relu")
        self.downsample = ConvBNAct(out_channels, out_channels, 3, 2, "relu")
        self.cv3 = ConvBNAct(3 * out_channels, out_channels, 1, 1, "relu")

    def forward(self, cur, skip0, skip1):
        x0 = self.upsample(cur)
        x1 = self.cv1(skip0)
        x2 = self.downsample(self.cv2(skip1))
        return self.cv3(torch.cat([x0, x1, x2], dim=1))
