"""Detector blocks as ``nn.Module``s over NCHW tensors (the JAX package's
``models/layers.py``, which is Flax over NHWC).

Submodules carry the Flax names (``conv``, ``bn``, ``cv1``, ``m``,
``block_0``, ``upsample``, ``rbr_dense_conv``, ...), so a flattened Flax
tree maps key for key onto ``state_dict()`` (:mod:`..utils.convert`). Torch
needs input widths at construction where Flax infers them, hence the extra
``in_channels``.
BatchNorm: Flax ``momentum=0.9`` is torch ``momentum=0.1``; eps 1e-5; in
train mode ``running_var`` tracks the biased batch variance, as Flax's does
(:class:`BatchNorm2d`).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

_ACTS = {"silu": F.silu, "relu": F.relu, "hardswish": F.hardswish, None: lambda x: x}


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode update of ``running_var`` uses the
    biased batch variance (Flax) instead of the unbiased one (torch).

    Torch's update gives v1 = (1 - m) * v0 + m * var * n / (n - 1) over n
    values a channel; v1 - (v1 - (1 - m) * v0) / n = (1 - m) * v0 + m * var,
    with no second pass over the input. The update runs on a copy, since
    autograd keeps the tensor the batch-norm call was given. The
    normalisation and the eval path are torch's own."""

    def forward(self, x):
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        self.num_batches_tracked.add_(1)
        v1 = self.running_var.clone()
        out = F.batch_norm(x, self.running_mean, v1, self.weight, self.bias, True,
                           self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_var.copy_(v1 - (v1 - (1.0 - self.momentum) * self.running_var) / n)
        return out


def bn2d(channels: int) -> BatchNorm2d:
    """The detector's BatchNorm: Flax momentum 0.9, eps 1e-5."""
    return BatchNorm2d(channels, eps=1e-5, momentum=0.1)


class ConvBNAct(nn.Module):
    """Conv(k, s, pad k//2, no bias, ``groups``) + BatchNorm + SiLU, ReLU,
    hard-swish or nothing."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, act: Optional[str] = "silu", groups: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride,
                              kernel_size // 2, groups=groups, bias=False)
        self.bn = bn2d(out_channels)
        self.act = act

    def forward(self, x):
        return _ACTS[self.act](self.bn(self.conv(x)))


def ConvBN(in_channels, out_channels, kernel_size=3, stride=1, groups=1):
    """Conv + BN, no activation (the same parameters as :class:`ConvBNAct`)."""
    return ConvBNAct(in_channels, out_channels, kernel_size, stride, None, groups)


def ConvBNHS(in_channels, out_channels, kernel_size=3, stride=1, groups=1):
    """Conv + BN + hard-swish."""
    return ConvBNAct(in_channels, out_channels, kernel_size, stride, "hardswish", groups)


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


class CSPSPPF(nn.Module):
    """CSP variant of SPPF: a 1x1-3x3-1x1 branch pooled three times beside
    a 1x1 skip."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 5,
                 e: float = 0.5, act: str = "silu"):
        super().__init__()
        c_ = int(out_channels * e)
        self.cv1 = ConvBNAct(in_channels, c_, 1, 1, act)
        self.cv3 = ConvBNAct(c_, c_, 3, 1, act)
        self.cv4 = ConvBNAct(c_, c_, 1, 1, act)
        self.cv2 = ConvBNAct(in_channels, c_, 1, 1, act)
        self.cv5 = ConvBNAct(4 * c_, c_, 1, 1, act)
        self.cv6 = ConvBNAct(c_, c_, 3, 1, act)
        self.cv7 = ConvBNAct(2 * c_, out_channels, 1, 1, act)
        self.kernel_size = kernel_size

    def forward(self, x):
        x1 = self.cv4(self.cv3(self.cv1(x)))
        y0 = self.cv2(x)
        y1 = _maxpool_same(x1, self.kernel_size)
        y2 = _maxpool_same(y1, self.kernel_size)
        y3 = _maxpool_same(y2, self.kernel_size)
        y = self.cv6(self.cv5(torch.cat([x1, y1, y2, y3], dim=1)))
        return self.cv7(torch.cat([y0, y], dim=1))


def _subsample(x, stride: int):
    """The input of a strided 1x1 conv branch: a 1x1 conv at stride s is a
    1x1 conv of every s-th row and column. Written so because the CPU's
    strided 1x1 weight gradient aborts the process on a 12-channel
    channels-last input (the stem's NHWC view)."""
    return x if stride == 1 else x[:, :, ::stride, ::stride]


class RepVGGBlock(nn.Module):
    """Train-time RepVGG block: 3x3 conv-BN + 1x1 conv-BN + (identity BN
    when the shape allows), summed, then ReLU. :mod:`..utils.reparam` folds
    it into one 3x3 conv for deployment."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1):
        super().__init__()
        self.rbr_dense_conv = nn.Conv2d(in_channels, out_channels, 3, stride, 1, bias=False)
        self.rbr_dense_bn = bn2d(out_channels)
        self.rbr_1x1_conv = nn.Conv2d(in_channels, out_channels, 1, bias=False)
        self.rbr_1x1_bn = bn2d(out_channels)
        self.rbr_identity = (bn2d(out_channels)
                             if in_channels == out_channels and stride == 1 else None)
        self.stride = stride

    def forward(self, x):
        one = self.rbr_1x1_bn(self.rbr_1x1_conv(_subsample(x, self.stride)))
        out = self.rbr_dense_bn(self.rbr_dense_conv(x)) + one
        if self.rbr_identity is not None:
            out = out + self.rbr_identity(x)
        return F.relu(out)


class QARepVGGBlock(nn.Module):
    """Quantization-aware RepVGG: [3x3 conv-BN + 1x1 conv (no BN) +
    identity (+ a 3x3 average pool in v2)] -> BN -> ReLU."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, avg_branch: bool = False):
        super().__init__()
        self.rbr_dense_conv = nn.Conv2d(in_channels, out_channels, 3, stride, 1, bias=False)
        self.rbr_dense_bn = bn2d(out_channels)
        self.rbr_1x1 = nn.Conv2d(in_channels, out_channels, 1, bias=False)
        self.bn = bn2d(out_channels)
        self.identity = in_channels == out_channels and stride == 1
        self.avg_branch = avg_branch
        self.stride = stride

    def forward(self, x):
        out = self.rbr_dense_bn(self.rbr_dense_conv(x)) + self.rbr_1x1(_subsample(x, self.stride))
        if self.identity:
            out = out + x
            if self.avg_branch:
                out = out + F.avg_pool2d(x, 3, 1, 1)
        return F.relu(self.bn(out))


def QARepVGGBlockV2(in_channels, out_channels, kernel_size=3, stride=1):
    """QARepVGG v2: v1 plus a 3x3 average-pool branch when shapes allow."""
    return QARepVGGBlock(in_channels, out_channels, kernel_size, stride, avg_branch=True)


def get_basic_block(mode: str):
    """training_mode -> stem/downsample block constructor
    ``(in, out, k=3, s=1)``."""
    if mode in ("conv_silu", "silu"):
        return lambda cin, cout, k=3, s=1: ConvBNAct(cin, cout, k, s, "silu")
    if mode in ("conv_relu", "relu"):
        return lambda cin, cout, k=3, s=1: ConvBNAct(cin, cout, k, s, "relu")
    if mode in ("repvgg", "rep"):
        return RepVGGBlock
    if mode in ("qarepvgg", "qarep"):
        return QARepVGGBlock
    if mode in ("qarepvggv2", "qarepv2"):
        return QARepVGGBlockV2
    raise ValueError(f"unknown training_mode: {mode}")


class BottleRep(nn.Module):
    """``depth`` basic blocks (conv1, conv2[, conv3]) with a learnable
    residual scale ``alpha`` (1,) when the widths allow a residual."""

    def __init__(self, in_channels: int, out_channels: int,
                 basic_mode: str = "conv_silu", depth: int = 2):
        super().__init__()
        blk = get_basic_block(basic_mode)
        self.depth = depth
        for i in range(depth):
            self.add_module(f"conv{i + 1}", blk(in_channels if i == 0 else out_channels,
                                                out_channels))
        self.alpha = nn.Parameter(torch.ones(1)) if in_channels == out_channels else None

    def forward(self, x):
        y = x
        for i in range(self.depth):
            y = getattr(self, f"conv{i + 1}")(y)
        return y if self.alpha is None else y + self.alpha * x


def BottleRep3(in_channels, out_channels, basic_mode="conv_silu"):
    """Three basic blocks + the weighted residual."""
    return BottleRep(in_channels, out_channels, basic_mode, depth=3)


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


class MBLABlock(nn.Module):
    """Multi-branch layer aggregation: a widened 1x1 split into branches of
    0, 1 (or 0, 2^k, n) BottleRep3s, every intermediate concatenated, 1x1
    out."""

    def __init__(self, in_channels: int, out_channels: int, n: int = 1,
                 e: float = 0.5, basic_mode: str = "conv_silu"):
        super().__init__()
        n = max(n // 2, 1)
        if n == 1:
            n_list = [0, 1]
        else:
            extra = 1
            while extra * 2 < n:
                extra *= 2
            n_list = [0, extra, n]
        self.n_list = n_list
        self.c_ = c_ = int(out_channels * e)
        act = "silu" if basic_mode == "conv_silu" else "relu"
        self.cv1 = ConvBNAct(in_channels, len(n_list) * c_, 1, 1, act)
        for b, depth in enumerate(n_list[1:]):
            for j in range(depth):
                self.add_module(f"m_{b}_{j}", BottleRep3(c_, c_, basic_mode))
        n_out = len(n_list) + sum(n_list)
        self.cv2 = ConvBNAct(n_out * c_, out_channels, 1, 1, act)

    def forward(self, x):
        splits = self.cv1(x).split(self.c_, dim=1)
        all_y = [splits[0]]
        for b, depth in enumerate(self.n_list[1:]):
            all_y.append(splits[b + 1])
            for j in range(depth):
                all_y.append(getattr(self, f"m_{b}_{j}")(all_y[-1]))
        return self.cv2(torch.cat(all_y, dim=1))


# -- the Lite family: hard-swish depthwise blocks ----------------------------


class SEBlock(nn.Module):
    """Squeeze-excite with a hard-sigmoid gate."""

    def __init__(self, channels: int, reduction: int = 4):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, channels // reduction, 1, bias=True)
        self.conv2 = nn.Conv2d(channels // reduction, channels, 1, bias=True)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        return x * F.hardsigmoid(self.conv2(F.relu(self.conv1(s))))


def channel_shuffle(x, groups: int):
    """NCHW channel shuffle in torch's interleave order: output channel
    j * groups + i is input channel i * (C // groups) + j."""
    b, c, h, w = x.shape
    return x.reshape(b, groups, c // groups, h, w).transpose(1, 2).reshape(b, c, h, w)


class Lite_EffiBlockS1(nn.Module):
    """Stride-1 shuffle block: half the channels pass, the other half goes
    1x1 -> depthwise 3x3 -> SE -> 1x1; concat and shuffle."""

    def __init__(self, in_channels: int, mid_channels: int, out_channels: int):
        super().__init__()
        self.half = in_channels // 2
        self.conv_pw_1 = ConvBNHS(in_channels - self.half, mid_channels, 1, 1)
        self.conv_dw_1 = ConvBN(mid_channels, mid_channels, 3, 1, groups=mid_channels)
        self.se = SEBlock(mid_channels)
        self.conv_1 = ConvBNHS(mid_channels, out_channels // 2, 1, 1)

    def forward(self, x):
        x1, x2 = x[:, : self.half], x[:, self.half:]
        y = self.conv_1(self.se(self.conv_dw_1(self.conv_pw_1(x2))))
        return channel_shuffle(torch.cat([x1, y], dim=1), 2)


class Lite_EffiBlockS2(nn.Module):
    """Stride-2 two-branch block, then a depthwise 3x3 and a 1x1."""

    def __init__(self, in_channels: int, mid_channels: int, out_channels: int,
                 stride: int = 2):
        super().__init__()
        self.conv_dw_1 = ConvBN(in_channels, in_channels, 3, stride, groups=in_channels)
        self.conv_1 = ConvBNHS(in_channels, out_channels // 2, 1, 1)
        self.conv_pw_2 = ConvBNHS(in_channels, mid_channels // 2, 1, 1)
        self.conv_dw_2 = ConvBN(mid_channels // 2, mid_channels // 2, 3, stride,
                                groups=mid_channels // 2)
        self.se = SEBlock(mid_channels // 2)
        self.conv_2 = ConvBNHS(mid_channels // 2, out_channels // 2, 1, 1)
        self.conv_dw_3 = ConvBNHS(2 * (out_channels // 2), out_channels, 3, 1,
                                  groups=out_channels)
        self.conv_pw_3 = ConvBNHS(out_channels, out_channels, 1, 1)

    def forward(self, x):
        b1 = self.conv_1(self.conv_dw_1(x))
        b2 = self.conv_2(self.se(self.conv_dw_2(self.conv_pw_2(x))))
        return self.conv_pw_3(self.conv_dw_3(torch.cat([b1, b2], dim=1)))


class DPBlock(nn.Module):
    """Depthwise k x k (with bias) + BN + hard-swish, then 1x1 (with bias)
    + BN + hard-swish."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1):
        super().__init__()
        p = (kernel_size - 1) // 2
        self.conv_dw_1 = nn.Conv2d(in_channels, out_channels, kernel_size, stride, p,
                                   groups=out_channels, bias=True)
        self.bn_1 = bn2d(out_channels)
        self.conv_pw_1 = nn.Conv2d(out_channels, out_channels, 1, bias=True)
        self.bn_2 = bn2d(out_channels)

    def forward(self, x):
        y = F.hardswish(self.bn_1(self.conv_dw_1(x)))
        return F.hardswish(self.bn_2(self.conv_pw_1(y)))


class DarknetBlock(nn.Module):
    """1x1 squeeze + DPBlock."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 expansion: float = 0.5):
        super().__init__()
        hidden = int(out_channels * expansion)
        self.conv_1 = ConvBNHS(in_channels, hidden, 1, 1)
        self.conv_2 = DPBlock(hidden, out_channels, kernel_size, 1)

    def forward(self, x):
        return self.conv_2(self.conv_1(x))


class CSPBlock(nn.Module):
    """CSP over a DarknetBlock."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 expand_ratio: float = 0.5):
        super().__init__()
        mid = int(out_channels * expand_ratio)
        self.conv_1 = ConvBNHS(in_channels, mid, 1, 1)
        self.blocks = DarknetBlock(mid, mid, kernel_size, 1.0)
        self.conv_2 = ConvBNHS(in_channels, mid, 1, 1)
        self.conv_3 = ConvBNHS(2 * mid, out_channels, 1, 1)

    def forward(self, x):
        return self.conv_3(torch.cat([self.blocks(self.conv_1(x)), self.conv_2(x)], dim=1))


# -- CBAM, DropBlock, adaptive pooling (the ResNet and Swin backbones) ------


class CBAM(nn.Module):
    """Convolutional block attention: channel attention (a shared MLP over
    the average and max pools), then spatial attention (a k x k conv over
    the channel-wise max and mean). Returns the attended features, as the
    JAX package does (the reference's ``forward`` returns None)."""

    def __init__(self, channels: int, reduction_ratio: int = 1, kernel_size: int = 3):
        super().__init__()
        hidden = int(channels / reduction_ratio)
        self.mlp_1 = nn.Linear(channels, hidden)
        self.mlp_2 = nn.Linear(hidden, channels)
        self.spatial_conv = nn.Conv2d(2, 1, kernel_size, 1, kernel_size // 2, bias=True)

    def forward(self, x):
        def mlp(v):
            return self.mlp_2(F.relu(self.mlp_1(v)))

        att = torch.sigmoid(mlp(x.mean(dim=(2, 3))) + mlp(x.amax(dim=(2, 3))))
        x = x * att[:, :, None, None]
        sp = torch.cat([x.amax(dim=1, keepdim=True), x.mean(dim=1, keepdim=True)], dim=1)
        return x * torch.sigmoid(self.spatial_conv(sp))


def drop_block_2d(x, drop_prob: float, block_size: int = 5,
                  generator: Optional[torch.Generator] = None):
    """DropBlock: zero the block_size x block_size regions around seeds
    drawn with probability drop_prob / block_size^2 from ``generator``, and
    rescale by the kept share."""
    if drop_prob == 0.0:
        return x
    gamma = drop_prob / (block_size ** 2)
    seeds = (torch.rand(x.shape, generator=generator, device=x.device) < gamma).to(x.dtype)
    block_mask = F.max_pool2d(seeds, block_size, 1, block_size // 2)
    keep = 1.0 - block_mask
    return x * keep / keep.mean().clamp(min=1e-6)


def adaptive_avg_pool_chw(x, out_c: int, out_h: int, out_w: int):
    """AdaptiveAvgPool3d over (C, H, W) of an NCHW tensor: the channels are
    pooled too, and each axis is upsampled where it is shorter than its
    target (window i = [floor(i*n/m), ceil((i+1)*n/m)))."""
    return F.adaptive_avg_pool3d(x[:, None], (out_c, out_h, out_w))[:, 0]


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
