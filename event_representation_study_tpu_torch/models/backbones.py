"""Detector backbones (the JAX package's ``models/backbones.py``).

``CSPBackboneP6`` is the reference's production backbone, which its configs
call "SwinTransformerV2" although it is a 6-stage convolutional CSP network
(stem + 5x [stride-2 conv + BepC3 stage], SPPF at the end). ``EfficientRep``
/ ``EfficientRep6`` stack RepVGG stages, ``ResNet50Backbone`` and
``Lite_EffiBackbone`` are the ablation backbones; the genuine Swin-V2 ViT
is :mod:`.swin_vit`.

Every backbone takes its input width and names its output widths in
``out_channels``, from which the neck is built: ResNet and Swin emit a fixed
128/256/512/1024 whatever the config's ``channels_list`` says, and the Lite
backbone forces its stem to 24.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .layers import (
    CBAM,
    CSPSPPF,
    SPPF,
    BepC3,
    ConvBNHS,
    Lite_EffiBlockS1,
    Lite_EffiBlockS2,
    RepVGGBlock,
    adaptive_avg_pool_chw,
    bn2d,
    drop_block_2d,
    get_basic_block,
)

# the (C, H, W) grid the ResNet and Swin outputs are pooled to (the
# reference's AdaptiveAvgPool3d targets): strides 8..64 at 576²
FIXED_GRID = ((128, 72, 72), (256, 36, 36), (512, 18, 18), (1024, 9, 9))


def space_to_depth(x):
    """(B, C, H, W) -> (B, 4C, H/2, W/2), channels ordered dy, dx, c with c
    fastest: the JAX package's NHWC reshape-transpose, not
    ``F.pixel_unshuffle``'s c, dy, dx."""
    b, c, h, w = x.shape
    return (x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
            .reshape(b, 4 * c, h // 2, w // 2))


@contextlib.contextmanager
def _buffers_kept(module: nn.Module):
    """Restore ``module``'s buffers (BatchNorm statistics and counters) on
    exit: a checkpointed stage's recompute in backward must not update them
    a second time, as ``nn.remat``'s does not."""
    saved = [b.clone() for b in module.buffers()]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, s in zip(module.buffers(), saved):
                b.copy_(s)


class CSPBackboneP6(nn.Module):
    """Outputs the stride (4, 8, 16, 32, 64) features, with
    ``channels_list[1:6]`` channels.

    ``space_to_depth`` folds the stem's stride 2 into a 2x2 pixel unshuffle
    (:func:`space_to_depth`) before a stride-1 stem. ``remat`` recomputes each BepC3 stage in the
    backward pass (``torch.utils.checkpoint``), with its BatchNorm
    statistics updated once."""

    def __init__(self, in_channels: int, channels_list: Sequence[int],
                 num_repeats: Sequence[int], basic_mode: str = "conv_silu",
                 csp_e: float = 0.5, remat: bool = False, space_to_depth: bool = False):
        super().__init__()
        ch = list(channels_list)
        blk = get_basic_block(basic_mode)
        self.remat = remat
        self.space_to_depth = space_to_depth
        if space_to_depth:
            self.stem = blk(4 * in_channels, ch[0], 3, 1)
        else:
            self.stem = blk(in_channels, ch[0], 3, 2)
        for i in range(1, 6):
            self.add_module(f"down_{i}", blk(ch[i - 1], ch[i], 3, 2))
            self.add_module(
                f"stage_{i}",
                BepC3(ch[i], ch[i], n=num_repeats[i], e=csp_e, basic_mode=basic_mode),
            )
        act = "silu" if basic_mode == "conv_silu" else "relu"
        self.sppf = SPPF(ch[5], ch[5], 5, act=act)
        self.out_channels = tuple(ch[1:6])

    def _stage(self, i: int, x):
        stage = getattr(self, f"stage_{i}")
        if not (self.remat and self.training and torch.is_grad_enabled()):
            return stage(x)
        return checkpoint(stage, x, use_reentrant=False,
                          context_fn=lambda: (contextlib.nullcontext(), _buffers_kept(stage)))

    def forward(self, x):
        x = self.stem(space_to_depth(x) if self.space_to_depth else x)
        outputs = []
        for i in range(1, 6):
            x = self._stage(i, getattr(self, f"down_{i}")(x))
            if i == 5:
                x = self.sppf(x)
            outputs.append(x)
        return tuple(outputs)


class RepStage(nn.Module):
    """Plain RepVGG stage: ``conv1`` then ``block_0`` .. ``block_{n-2}``."""

    def __init__(self, in_channels: int, out_channels: int, n: int = 1):
        super().__init__()
        self.conv1 = RepVGGBlock(in_channels, out_channels)
        self.n_blocks = n - 1
        for i in range(self.n_blocks):
            self.add_module(f"block_{i}", RepVGGBlock(out_channels, out_channels))

    def forward(self, x):
        x = self.conv1(x)
        for i in range(self.n_blocks):
            x = getattr(self, f"block_{i}")(x)
        return x


class EfficientRep(nn.Module):
    """RepVGG backbone of ``stages`` stride-2 stages (4: EfficientRep,
    strides 8/16/32 plus 4 with ``fuse_P2``; 5: EfficientRep6, strides
    8..64 plus 4 with ``fuse_P2``), SPPF with ReLU at the end."""

    def __init__(self, in_channels: int, channels_list: Sequence[int],
                 num_repeats: Sequence[int], fuse_P2: bool = True, cspsppf: bool = False,
                 stages: int = 4):
        super().__init__()
        ch = list(channels_list)
        self.stages = stages
        self.stem = RepVGGBlock(in_channels, ch[0], 3, 2)
        for i in range(1, stages + 1):
            self.add_module(f"down_{i}", RepVGGBlock(ch[i - 1], ch[i], 3, 2))
            self.add_module(f"stage_{i}", RepStage(ch[i], ch[i], num_repeats[i]))
        self.sppf = (CSPSPPF if cspsppf else SPPF)(ch[stages], ch[stages], 5, act="relu")
        self.first_out = 1 if fuse_P2 else 2
        self.out_channels = tuple(ch[self.first_out:stages + 1])

    def forward(self, x):
        x = self.stem(x)
        outputs = []
        for i in range(1, self.stages + 1):
            x = getattr(self, f"stage_{i}")(getattr(self, f"down_{i}")(x))
            if i == self.stages:
                x = self.sppf(x)
            if i >= self.first_out:
                outputs.append(x)
        return tuple(outputs)


def EfficientRep6(in_channels, channels_list, num_repeats, fuse_P2=True, cspsppf=False):
    """The 6-stage variant: strides (4,) 8, 16, 32, 64."""
    return EfficientRep(in_channels, channels_list, num_repeats, fuse_P2, cspsppf, stages=5)


class ResNetBottleneck(nn.Module):
    """ResNet bottleneck (1x1, 3x3 with the stride, 1x1 to 4 x planes) with
    an optional CBAM and a 1x1 projection shortcut when the shape changes."""

    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 use_cbam: bool = False):
        super().__init__()
        out_ch = planes * 4
        self.conv1 = nn.Conv2d(in_channels, planes, 1, bias=False)
        self.bn1 = bn2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = bn2d(planes)
        self.conv3 = nn.Conv2d(planes, out_ch, 1, bias=False)
        self.bn3 = bn2d(out_ch)
        self.cbam = CBAM(out_ch) if use_cbam else None
        if stride != 1 or in_channels != out_ch:
            self.downsample_conv = nn.Conv2d(in_channels, out_ch, 1, stride, bias=False)
            self.downsample_bn = bn2d(out_ch)
        else:
            self.downsample_conv = None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.cbam is not None:
            y = self.cbam(y)
        residual = x if self.downsample_conv is None else self.downsample_bn(
            self.downsample_conv(x))
        return F.relu(y + residual)


class ResNet50Backbone(nn.Module):
    """Detection ResNet-50: 7x7/2 stem + maxpool, bottleneck stages
    ``layers``, each stage's output pooled to :data:`FIXED_GRID`
    (AdaptiveAvgPool3d semantics, channels included). DropBlock
    (``drop_prob`` > 0, from ``generator``) regularises stages 1-2 in train
    mode.

    ``freeze_bn`` (the reference's default) keeps every BatchNorm on its
    running statistics in train mode too: :meth:`train` leaves them in eval
    mode, while the backbone itself (DropBlock) follows the mode."""

    def __init__(self, in_channels: int, layers: Sequence[int] = (3, 4, 6, 3),
                 cbam: bool = False, drop_prob: float = 0.0, freeze_bn: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = bn2d(64)
        self.layers = tuple(layers)
        self.drop_prob = drop_prob
        self.freeze_bn = freeze_bn
        self.generator = generator
        cin = 64
        for s, (n, p) in enumerate(zip(self.layers, (64, 128, 256, 512))):
            use_cbam = cbam and s >= 1  # the reference: layers 2-4 only
            for i in range(n):
                stride = 2 if s > 0 and i == 0 else 1
                self.add_module(f"layer{s + 1}_{i}", ResNetBottleneck(cin, p, stride, use_cbam))
                cin = p * 4
        self.out_channels = tuple(c for c, _, _ in FIXED_GRID)
        self.train()

    def train(self, mode: bool = True):
        super().train(mode)
        if self.freeze_bn:
            for m in self.modules():
                if isinstance(m, nn.BatchNorm2d):
                    m.eval()
        return self

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        feats = []
        for s, n in enumerate(self.layers):
            for i in range(n):
                x = getattr(self, f"layer{s + 1}_{i}")(x)
            if self.training and self.drop_prob > 0 and s < 2:
                x = drop_block_2d(x, self.drop_prob, 5, self.generator)
            feats.append(x)
        return tuple(adaptive_avg_pool_chw(f, *g) for f, g in zip(feats, FIXED_GRID))


class Lite_EffiBackbone(nn.Module):
    """Lightweight shuffle backbone: hard-swish stem (forced to 24 channels)
    + 4 stages of one Lite_EffiBlockS2 and ``num_repeat[s] - 1``
    Lite_EffiBlockS1; outputs the last 3 stages (strides 8, 16, 32)."""

    def __init__(self, in_channels: int, out_channels: Sequence[int],
                 mid_channels: Sequence[int], num_repeat: Sequence[int] = (1, 3, 7, 3)):
        super().__init__()
        ch = list(out_channels)
        ch[0] = 24
        self.num_repeat = tuple(num_repeat)
        self.conv_0 = ConvBNHS(in_channels, ch[0], 3, 2)
        for s in range(4):
            self.add_module(f"stage{s + 1}_0",
                            Lite_EffiBlockS2(ch[s], mid_channels[s + 1], ch[s + 1]))
            for i in range(1, self.num_repeat[s]):
                self.add_module(f"stage{s + 1}_{i}",
                                Lite_EffiBlockS1(ch[s + 1], mid_channels[s + 1], ch[s + 1]))
        self.out_channels = tuple(ch[2:5])

    def forward(self, x):
        x = self.conv_0(x)
        outputs = []
        for s in range(4):
            for i in range(self.num_repeat[s]):
                x = getattr(self, f"stage{s + 1}_{i}")(x)
            if s >= 1:
                outputs.append(x)
        return tuple(outputs)
