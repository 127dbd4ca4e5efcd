"""Classification ResNets with the event-study stem swap, as ``nn.Module``s
over NCHW tensors (the JAX package's ``models/resnet.py``, the equivalent
of n_imagenet/real_cnn_model/models/model_container.py: torchvision ResNets
with ``conv1 = Conv2d(channels, 64, kernel_size)``, :60-68; the study
config uses channels=12, kernel=14, ResNet34).

Submodules carry the Flax names (``conv1``, ``bn1``, ``BasicBlock_3``,
``Conv_1``, ``BatchNorm_2``, ``fc``), so ``utils/convert.py::flax_to_torch``
carries the weights across. Where torch's defaults differ from Flax's, the
Flax behaviour is kept:
- a stem kernel k pads k // 2 on both sides, also for an even k (14: a
  113x113 stem output at 224²); max pooling pads with -inf;
- the JAX module's BatchNorms keep Flax's defaults: momentum 0.99 (torch
  0.01), eps 1e-5, running variance from the biased batch variance
  (``models/layers.py::BatchNorm2d``);
- the head is the mean over H, W, then ``fc``;
- :func:`init_weights_` draws Flax's default initialisation.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm2d

BN_MOMENTUM = 0.01  # Flax's default momentum 0.99


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    # Flax: 3x3 convs pass padding=1; the 1x1 convs' SAME padding is 0
    return nn.Conv2d(cin, cout, k, stride, k // 2, bias=False)


def _bn(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, eps=1e-5, momentum=BN_MOMENTUM)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_channels: int, filters: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = _conv(in_channels, filters, 3, stride)
        self.BatchNorm_0 = _bn(filters)
        self.Conv_1 = _conv(filters, filters, 3)
        self.BatchNorm_1 = _bn(filters)
        self.project = in_channels != filters or stride != 1
        if self.project:
            self.Conv_2 = _conv(in_channels, filters, 1, stride)
            self.BatchNorm_2 = _bn(filters)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        if self.project:
            x = self.BatchNorm_2(self.Conv_2(x))
        return F.relu(y + x)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_channels: int, filters: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = _conv(in_channels, filters, 1)
        self.BatchNorm_0 = _bn(filters)
        self.Conv_1 = _conv(filters, filters, 3, stride)
        self.BatchNorm_1 = _bn(filters)
        self.Conv_2 = _conv(filters, filters * 4, 1)
        self.BatchNorm_2 = _bn(filters * 4)
        self.project = in_channels != filters * 4 or stride != 1
        if self.project:
            self.Conv_3 = _conv(in_channels, filters * 4, 1, stride)
            self.BatchNorm_3 = _bn(filters * 4)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        if self.project:
            x = self.BatchNorm_3(self.Conv_3(x))
        return F.relu(y + x)


_CONFIGS = {
    "ResNet18": (BasicBlock, (2, 2, 2, 2)),
    "ResNet34": (BasicBlock, (3, 4, 6, 3)),
    "ResNet50": (Bottleneck, (3, 4, 6, 3)),
    "ResNet101": (Bottleneck, (3, 4, 23, 3)),
    "ResNet152": (Bottleneck, (3, 8, 36, 3)),
}


class EventResNet(nn.Module):
    """ResNet with an event-representation stem: conv1 takes ``in_channels``
    (12 for the study reps) with ``stem_kernel`` (14 in the study config).
    Input (B, C, H, W) float32, output (B, num_classes) logits."""

    def __init__(self, num_classes: int = 100, arch: str = "ResNet34", stem_kernel: int = 14,
                 in_channels: int = 12):
        super().__init__()
        if arch not in _CONFIGS:
            raise ValueError(f"unknown arch {arch!r}; one of {sorted(_CONFIGS)}")
        block, stages = _CONFIGS[arch]
        self.arch = arch
        self.conv1 = nn.Conv2d(in_channels, 64, stem_kernel, 2, stem_kernel // 2, bias=False)
        self.bn1 = _bn(64)
        width, k = 64, 0
        for i, n in enumerate(stages):
            for j in range(n):
                filters = 64 * 2**i
                self.add_module(f"{block.__name__}_{k}",
                                block(width, filters, 2 if (i > 0 and j == 0) else 1))
                width, k = filters * block.expansion, k + 1
        self.num_blocks = k
        self.block_name = block.__name__
        self.fc = nn.Linear(width, num_classes)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)  # pads with -inf, as Flax's max_pool
        for k in range(self.num_blocks):
            x = getattr(self, f"{self.block_name}_{k}")(x)
        return self.fc(x.mean(dim=(2, 3)))


def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Flax's default initialisation from ``generator``: conv and dense
    kernels lecun-normal (truncated normal, std sqrt(1/fan_in)/0.8796),
    biases 0, BatchNorm scale 1 / bias 0 / mean 0 / var 1."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                std = math.sqrt(1.0 / mod.weight[0].numel()) / 0.87962566103423978
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.BatchNorm2d):
                mod.reset_parameters()
    return model
