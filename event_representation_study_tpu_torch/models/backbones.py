"""Detector backbone ``CSPBackboneP6`` (the JAX package's
``models/backbones.py``): the reference's production backbone, which its
configs call "SwinTransformerV2" although it is a 6-stage convolutional CSP
network (stem + 5x [stride-2 conv + BepC3 stage], SPPF at the end)."""
from __future__ import annotations

from typing import Sequence

from torch import nn

from .layers import SPPF, BepC3, get_basic_block


class CSPBackboneP6(nn.Module):
    """Outputs the stride (4, 8, 16, 32, 64) features, with
    ``channels_list[1:6]`` channels."""

    def __init__(self, in_channels: int, channels_list: Sequence[int],
                 num_repeats: Sequence[int], basic_mode: str = "conv_silu",
                 csp_e: float = 0.5):
        super().__init__()
        ch = list(channels_list)
        blk = get_basic_block(basic_mode)
        self.stem = blk(in_channels, ch[0], 3, 2)
        for i in range(1, 6):
            self.add_module(f"down_{i}", blk(ch[i - 1], ch[i], 3, 2))
            self.add_module(
                f"stage_{i}",
                BepC3(ch[i], ch[i], n=num_repeats[i], e=csp_e, basic_mode=basic_mode),
            )
        act = "silu" if basic_mode == "conv_silu" else "relu"
        self.sppf = SPPF(ch[5], ch[5], 5, act=act)

    def forward(self, x):
        x = self.stem(x)
        outputs = []
        for i in range(1, 6):
            x = getattr(self, f"stage_{i}")(getattr(self, f"down_{i}")(x))
            if i == 5:
                x = self.sppf(x)
            outputs.append(x)
        return tuple(outputs)
