"""Detector necks (the JAX package's ``models/necks.py``): the bidirectional
FPN/PAN family with BiFusion top-down fusion (``CSPRepBiFPANNeck_P6`` over 5
backbone features, ``CSPRepBiFPANNeck`` over 4), the transpose-upsample +
concat PAN family (``PANNeckUpcat``, 3 or 4 levels) and the Lite neck.

Stages are BepC3 (``bepc3``), plain RepVGG stacks (``rep``) or MBLA blocks
(``mbla``). ``channels_list`` is the config's [backbone | neck] list;
``in_channels`` are the widths of the features the backbone actually emits
(strides ascending), which Flax infers and torch needs at construction.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .backbones import RepStage
from .layers import BepC3, BiFusion, ConvBNAct, ConvBNHS, CSPBlock, DPBlock, MBLABlock, Transpose


def _make_stage(kind: str, csp_e: float, basic_mode: str):
    """``stage(in, out, n)`` of the given kind."""

    def stage(cin, cout, n):
        if kind == "bepc3":
            return BepC3(cin, cout, n=n, e=csp_e, basic_mode=basic_mode)
        if kind == "mbla":
            return MBLABlock(cin, cout, n=n, e=csp_e, basic_mode=basic_mode)
        return RepStage(cin, cout, n)

    return stage


def _relu_conv(cin, cout, k=1, s=1):
    return ConvBNAct(cin, cout, k, s, "relu")


class CSPRepBiFPANNeck_P6(nn.Module):
    """5 features (strides 4..64) -> 4 outputs (strides 8..64);
    ``channels_list`` has 12 entries, the neck's at 6..11."""

    def __init__(self, in_channels: Sequence[int], channels_list: Sequence[int],
                 num_repeats: Sequence[int], basic_mode: str = "conv_silu",
                 csp_e: float = 0.5, stage_type: str = "bepc3"):
        super().__init__()
        c4, c3, c2, c1, c0 = in_channels
        ch, nr = list(channels_list), list(num_repeats)
        stage = _make_stage(stage_type, csp_e, basic_mode)
        self.reduce_layer0 = _relu_conv(c0, ch[6])
        self.Bifusion0 = BiFusion(ch[6], c1, c2, ch[6])
        self.Rep_p5 = stage(ch[6], ch[6], nr[6])
        self.reduce_layer1 = _relu_conv(ch[6], ch[7])
        self.Bifusion1 = BiFusion(ch[7], c2, c3, ch[7])
        self.Rep_p4 = stage(ch[7], ch[7], nr[7])
        self.reduce_layer2 = _relu_conv(ch[7], ch[8])
        self.Bifusion2 = BiFusion(ch[8], c3, c4, ch[8])
        self.Rep_p3 = stage(ch[8], ch[8], nr[8])
        self.downsample2 = _relu_conv(ch[8], ch[8], 3, 2)
        self.Rep_n4 = stage(2 * ch[8], ch[9], nr[9])
        self.downsample1 = _relu_conv(ch[9], ch[9], 3, 2)
        self.Rep_n5 = stage(ch[9] + ch[7], ch[10], nr[10])
        self.downsample0 = _relu_conv(ch[10], ch[10], 3, 2)
        self.Rep_n6 = stage(ch[10] + ch[6], ch[11], nr[11])
        self.out_channels = (ch[8], ch[9], ch[10], ch[11])

    def forward(self, feats):
        x4, x3, x2, x1, x0 = feats  # strides 4, 8, 16, 32, 64
        fpn_out0 = self.reduce_layer0(x0)
        f_out0 = self.Rep_p5(self.Bifusion0(fpn_out0, x1, x2))
        fpn_out1 = self.reduce_layer1(f_out0)
        f_out1 = self.Rep_p4(self.Bifusion1(fpn_out1, x2, x3))
        fpn_out2 = self.reduce_layer2(f_out1)
        pan_out3 = self.Rep_p3(self.Bifusion2(fpn_out2, x3, x4))  # P3 @8
        pan_out2 = self.Rep_n4(torch.cat([self.downsample2(pan_out3), fpn_out2], dim=1))
        pan_out1 = self.Rep_n5(torch.cat([self.downsample1(pan_out2), fpn_out1], dim=1))
        pan_out0 = self.Rep_n6(torch.cat([self.downsample0(pan_out1), fpn_out0], dim=1))
        return [pan_out3, pan_out2, pan_out1, pan_out0]


class CSPRepBiFPANNeck(nn.Module):
    """4 features (strides 4, 8, 16, 32 of a ``fuse_P2`` backbone; the
    fixed 72/36/18/9 grid of ResNet and Swin) -> 3 outputs;
    ``channels_list`` has 10 entries, the neck's at 5..9."""

    def __init__(self, in_channels: Sequence[int], channels_list: Sequence[int],
                 num_repeats: Sequence[int], basic_mode: str = "conv_silu",
                 csp_e: float = 0.5, stage_type: str = "bepc3"):
        super().__init__()
        c3, c2, c1, c0 = in_channels
        ch, nr = list(channels_list), list(num_repeats)
        stage = _make_stage(stage_type, csp_e, basic_mode)
        self.reduce_layer0 = _relu_conv(c0, ch[5])
        self.Bifusion0 = BiFusion(ch[5], c1, c2, ch[5])
        self.Rep_p4 = stage(ch[5], ch[5], nr[5])
        self.reduce_layer1 = _relu_conv(ch[5], ch[6])
        self.Bifusion1 = BiFusion(ch[6], c2, c3, ch[6])
        self.Rep_p3 = stage(ch[6], ch[6], nr[6])
        self.downsample1 = _relu_conv(ch[6], ch[7], 3, 2)
        self.Rep_n3 = stage(ch[7] + ch[6], ch[8], nr[7])
        self.downsample0 = _relu_conv(ch[8], ch[8], 3, 2)
        self.Rep_n4 = stage(ch[8] + ch[5], ch[9], nr[8])
        self.out_channels = (ch[6], ch[8], ch[9])

    def forward(self, feats):
        x3, x2, x1, x0 = feats
        fpn_out0 = self.reduce_layer0(x0)
        f_out0 = self.Rep_p4(self.Bifusion0(fpn_out0, x1, x2))
        fpn_out1 = self.reduce_layer1(f_out0)
        pan_out2 = self.Rep_p3(self.Bifusion1(fpn_out1, x2, x3))  # P3
        pan_out1 = self.Rep_n3(torch.cat([self.downsample1(pan_out2), fpn_out1], dim=1))
        pan_out0 = self.Rep_n4(torch.cat([self.downsample0(pan_out1), fpn_out0], dim=1))
        return [pan_out2, pan_out1, pan_out0]


class PANNeckUpcat(nn.Module):
    """The transpose-upsample + concat PAN (RepPANNeck, CSPRepPANNeck:
    ``levels=3`` over the last 3 features; RepPANNeck6, CSPRepPANNeck_P6:
    ``levels=4`` over the last 4). The neck's entries of ``channels_list``
    start at ``backbone_entries``: levels 3 [p4, p3, down2, n3, down1, n4],
    levels 4 [p5, p4, p3, n4, n5, n6]."""

    def __init__(self, in_channels: Sequence[int], channels_list: Sequence[int],
                 num_repeats: Sequence[int], levels: int = 3, backbone_entries: int = 5,
                 basic_mode: str = "conv_silu", csp_e: float = 0.5, stage_type: str = "rep"):
        super().__init__()
        c = list(channels_list[backbone_entries:])
        n = list(num_repeats[backbone_entries:])
        stage = _make_stage(stage_type, csp_e, basic_mode)
        self.levels = levels
        if levels == 3:
            x2, x1, x0 = in_channels[-3:]
            self.reduce_layer0 = _relu_conv(x0, c[0])
            self.upsample0 = Transpose(c[0], c[0])
            self.Rep_p4 = stage(c[0] + x1, c[0], n[0])
            self.reduce_layer1 = _relu_conv(c[0], c[1])
            self.upsample1 = Transpose(c[1], c[1])
            self.Rep_p3 = stage(c[1] + x2, c[1], n[1])
            self.downsample2 = _relu_conv(c[1], c[2], 3, 2)
            self.Rep_n3 = stage(c[2] + c[1], c[3], n[2])
            self.downsample1 = _relu_conv(c[3], c[4], 3, 2)
            self.Rep_n4 = stage(c[4] + c[0], c[5], n[3])
            self.out_channels = (c[1], c[3], c[5])
            return
        x3, x2, x1, x0 = in_channels[-4:]
        self.reduce_layer0 = _relu_conv(x0, c[0])
        self.upsample0 = Transpose(c[0], c[0])
        self.Rep_p5 = stage(c[0] + x1, c[0], n[0])
        self.reduce_layer1 = _relu_conv(c[0], c[1])
        self.upsample1 = Transpose(c[1], c[1])
        self.Rep_p4 = stage(c[1] + x2, c[1], n[1])
        self.reduce_layer2 = _relu_conv(c[1], c[2])
        self.upsample2 = Transpose(c[2], c[2])
        self.Rep_p3 = stage(c[2] + x3, c[2], n[2])
        self.downsample2 = _relu_conv(c[2], c[2], 3, 2)
        self.Rep_n4 = stage(2 * c[2], c[3], n[3])
        self.downsample1 = _relu_conv(c[3], c[3], 3, 2)
        self.Rep_n5 = stage(c[3] + c[1], c[4], n[4])
        self.downsample0 = _relu_conv(c[4], c[4], 3, 2)
        self.Rep_n6 = stage(c[4] + c[0], c[5], n[5])
        self.out_channels = (c[2], c[3], c[4], c[5])

    def forward(self, feats):
        if self.levels == 3:
            x2, x1, x0 = feats[-3:]  # strides 8, 16, 32
            fpn_out0 = self.reduce_layer0(x0)
            f_out0 = self.Rep_p4(torch.cat([self.upsample0(fpn_out0), x1], dim=1))
            fpn_out1 = self.reduce_layer1(f_out0)
            pan_out2 = self.Rep_p3(torch.cat([self.upsample1(fpn_out1), x2], dim=1))
            pan_out1 = self.Rep_n3(torch.cat([self.downsample2(pan_out2), fpn_out1], dim=1))
            pan_out0 = self.Rep_n4(torch.cat([self.downsample1(pan_out1), fpn_out0], dim=1))
            return [pan_out2, pan_out1, pan_out0]
        x3, x2, x1, x0 = feats[-4:]  # strides 8, 16, 32, 64
        fpn_out0 = self.reduce_layer0(x0)
        f_out0 = self.Rep_p5(torch.cat([self.upsample0(fpn_out0), x1], dim=1))
        fpn_out1 = self.reduce_layer1(f_out0)
        f_out1 = self.Rep_p4(torch.cat([self.upsample1(fpn_out1), x2], dim=1))
        fpn_out2 = self.reduce_layer2(f_out1)
        pan_out3 = self.Rep_p3(torch.cat([self.upsample2(fpn_out2), x3], dim=1))
        pan_out2 = self.Rep_n4(torch.cat([self.downsample2(pan_out3), fpn_out2], dim=1))
        pan_out1 = self.Rep_n5(torch.cat([self.downsample1(pan_out2), fpn_out1], dim=1))
        pan_out0 = self.Rep_n6(torch.cat([self.downsample0(pan_out1), fpn_out0], dim=1))
        return [pan_out3, pan_out2, pan_out1, pan_out0]


def _up2x(t):
    """Nearest 2x upsampling."""
    return t.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class Lite_EffiNeck(nn.Module):
    """Lightweight PAN with ``unified_channels`` everywhere, nearest
    upsampling, CSPBlocks and a P6 branch: 3 features (strides 8, 16, 32)
    -> 4 outputs (strides 8..64)."""

    def __init__(self, in_channels: Sequence[int], unified_channels: int = 96):
        super().__init__()
        x2, x1, x0 = in_channels[-3:]
        u = unified_channels
        self.reduce_layer0 = ConvBNHS(x0, u, 1, 1)
        self.reduce_layer1 = ConvBNHS(x1, u, 1, 1)
        self.reduce_layer2 = ConvBNHS(x2, u, 1, 1)
        self.Csp_p4 = CSPBlock(2 * u, u, 5)
        self.Csp_p3 = CSPBlock(2 * u, u, 5)
        self.downsample2 = DPBlock(u, u, 5, 2)
        self.Csp_n3 = CSPBlock(2 * u, u, 5)
        self.downsample1 = DPBlock(u, u, 5, 2)
        self.Csp_n4 = CSPBlock(2 * u, u, 5)
        self.p6_conv_1 = DPBlock(u, u, 5, 2)
        self.p6_conv_2 = DPBlock(u, u, 5, 2)
        self.out_channels = (u,) * 4

    def forward(self, feats):
        x2, x1, x0 = feats[-3:]
        fpn_out0 = self.reduce_layer0(x0)
        x1 = self.reduce_layer1(x1)
        x2 = self.reduce_layer2(x2)
        f_out1 = self.Csp_p4(torch.cat([_up2x(fpn_out0), x1], dim=1))
        pan_out3 = self.Csp_p3(torch.cat([_up2x(f_out1), x2], dim=1))
        pan_out2 = self.Csp_n3(torch.cat([self.downsample2(pan_out3), f_out1], dim=1))
        pan_out1 = self.Csp_n4(torch.cat([self.downsample1(pan_out2), fpn_out0], dim=1))
        pan_out0 = self.p6_conv_1(fpn_out0) + self.p6_conv_2(pan_out1)
        return [pan_out3, pan_out2, pan_out1, pan_out0]
