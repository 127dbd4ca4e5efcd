"""Detector neck ``CSPRepBiFPANNeck_P6`` with BepC3 stages (the JAX
package's ``models/necks.py``): a bidirectional FPN/PAN over the 5 backbone
features (strides 4..64) producing 4 outputs (strides 8..64).

``channels_list`` is the 12-entry [backbone(6) | neck(6)] list."""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .layers import BepC3, BiFusion, ConvBNAct


class CSPRepBiFPANNeck_P6(nn.Module):
    def __init__(self, channels_list: Sequence[int], num_repeats: Sequence[int],
                 basic_mode: str = "conv_silu", csp_e: float = 0.5):
        super().__init__()
        ch, nr = list(channels_list), list(num_repeats)

        def stage(cin, cout, n):
            return BepC3(cin, cout, n=n, e=csp_e, basic_mode=basic_mode)

        self.reduce_layer0 = ConvBNAct(ch[5], ch[6], 1, 1, "relu")
        self.Bifusion0 = BiFusion(ch[6], ch[4], ch[3], ch[6])
        self.Rep_p5 = stage(ch[6], ch[6], nr[6])
        self.reduce_layer1 = ConvBNAct(ch[6], ch[7], 1, 1, "relu")
        self.Bifusion1 = BiFusion(ch[7], ch[3], ch[2], ch[7])
        self.Rep_p4 = stage(ch[7], ch[7], nr[7])
        self.reduce_layer2 = ConvBNAct(ch[7], ch[8], 1, 1, "relu")
        self.Bifusion2 = BiFusion(ch[8], ch[2], ch[1], ch[8])
        self.Rep_p3 = stage(ch[8], ch[8], nr[8])
        self.downsample2 = ConvBNAct(ch[8], ch[8], 3, 2, "relu")
        self.Rep_n4 = stage(2 * ch[8], ch[9], nr[9])
        self.downsample1 = ConvBNAct(ch[9], ch[9], 3, 2, "relu")
        self.Rep_n5 = stage(ch[9] + ch[7], ch[10], nr[10])
        self.downsample0 = ConvBNAct(ch[10], ch[10], 3, 2, "relu")
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
        pan_out2 = self.Rep_n4(
            torch.cat([self.downsample2(pan_out3), fpn_out2], dim=1)
        )  # P4 @16
        pan_out1 = self.Rep_n5(
            torch.cat([self.downsample1(pan_out2), fpn_out1], dim=1)
        )  # P5 @32
        pan_out0 = self.Rep_n6(
            torch.cat([self.downsample0(pan_out1), fpn_out0], dim=1)
        )  # P6 @64
        return [pan_out3, pan_out2, pan_out1, pan_out0]
