"""Structural re-parameterisation (the JAX package's ``utils/reparam.py``):
fold a RepVGGBlock's train-time branches (3x3 conv-BN + 1x1 conv-BN +
identity BN) into one 3x3 conv with bias for deployment, and fold every
conv-BN pair of a model.

Weights are OIHW; the BatchNorms use their running statistics, so a folded
block reproduces the block's eval output to rounding.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import RepVGGBlock


def fuse_conv_bn(weight: torch.Tensor, bn: nn.BatchNorm2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """conv (no bias) + BN -> (weight, bias) of one conv."""
    std = torch.sqrt(bn.running_var + bn.eps)
    return (weight * (bn.weight / std)[:, None, None, None],
            bn.bias - bn.running_mean * bn.weight / std)


@torch.no_grad()
def fuse_repvgg_block(block: RepVGGBlock) -> Tuple[torch.Tensor, torch.Tensor]:
    """One RepVGGBlock -> (weight (O, I, 3, 3), bias (O,)) of the 3x3 conv
    that, followed by ReLU, computes the block in eval mode."""
    w3, b3 = fuse_conv_bn(block.rbr_dense_conv.weight, block.rbr_dense_bn)
    w1, b1 = fuse_conv_bn(F.pad(block.rbr_1x1_conv.weight, (1, 1, 1, 1)), block.rbr_1x1_bn)
    weight, bias = w3 + w1, b3 + b1
    if block.rbr_identity is not None:
        c = weight.shape[1]
        ident = torch.zeros_like(weight)
        ident[torch.arange(c), torch.arange(c), 1, 1] = 1.0
        wi, bi = fuse_conv_bn(ident, block.rbr_identity)
        weight, bias = weight + wi, bias + bi
    return weight, bias


@torch.no_grad()
def fuse_conv_bn_tree(model: nn.Module) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Every module with a ``conv`` and a ``bn`` child (``ConvBNAct``) ->
    its folded (weight, bias), keyed by the module's name."""
    return {name: fuse_conv_bn(mod.conv.weight, mod.bn)
            for name, mod in model.named_modules()
            if isinstance(getattr(mod, "conv", None), nn.Conv2d)
            and isinstance(getattr(mod, "bn", None), nn.BatchNorm2d)}
