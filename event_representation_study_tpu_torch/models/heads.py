"""Efficient Decoupled Head (anchor-free, DFL) — the JAX package's
``models/heads.py::EffiDeHead``.

Per level: 1x1 stem -> (3x3 cls conv -> 1x1 cls pred) and
(3x3 reg conv -> 1x1 reg pred with 4*(reg_max+1) outputs).
Train output: per-level stem features (NCHW) + concatenated (B, A, nc)
sigmoid class scores + (B, A, 4*(reg_max+1)) reg distributions.
Eval output: DFL softmax-projection + dist2bbox decode, stride-scaled,
concat [bbox(4) | ones | cls] -> (B, A, 5+nc).

The config's ``use_dfl=False`` variant is not ported (ROADMAP M14).
Anchors run level by level and row-major within a level, as in the NHWC
reference, so every per-level map is flattened from (B, H, W, C).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ..ops.boxes import dist2bbox
from ..train.anchors import generate_anchors_eval
from .layers import ConvBNAct

PRIOR_PROB = 1e-2


def _flat_nhwc(x):
    """(B, C, H, W) -> (B, H*W, C)."""
    b, c = x.shape[:2]
    return x.permute(0, 2, 3, 1).reshape(b, -1, c)


class EffiDeHead(nn.Module):
    def __init__(self, num_classes: int, in_channels: Sequence[int],
                 feat_channels: Sequence[int], strides=(8, 16, 32, 64),
                 reg_max: int = 16):
        super().__init__()
        self.num_classes = num_classes
        self.strides = tuple(strides)
        self.reg_max = reg_max
        self.nl = len(in_channels)
        n_reg = 4 * (reg_max + 1)
        for i, (c, cin) in enumerate(zip(in_channels, feat_channels)):
            self.add_module(f"stem_{i}", ConvBNAct(cin, c, 1, 1, "silu"))
            self.add_module(f"cls_conv_{i}", ConvBNAct(c, c, 3, 1, "silu"))
            self.add_module(f"cls_pred_{i}", nn.Conv2d(c, num_classes, 1, bias=True))
            self.add_module(f"reg_conv_{i}", ConvBNAct(c, c, 3, 1, "silu"))
            self.add_module(f"reg_pred_{i}", nn.Conv2d(c, n_reg, 1, bias=True))
        self.reset_pred_parameters()

    def reset_pred_parameters(self):
        """Pred convs start at zero weights, class bias -log((1-p)/p) with
        p=0.01, reg bias 1.0."""
        with torch.no_grad():
            for i in range(self.nl):
                cls_pred = getattr(self, f"cls_pred_{i}")
                reg_pred = getattr(self, f"reg_pred_{i}")
                cls_pred.weight.zero_()
                cls_pred.bias.fill_(-math.log((1 - PRIOR_PROB) / PRIOR_PROB))
                reg_pred.weight.zero_()
                reg_pred.bias.fill_(1.0)

    def forward(self, feats):
        assert len(feats) == self.nl
        cls_list, reg_list, stem_feats = [], [], []
        for i in range(self.nl):
            x = getattr(self, f"stem_{i}")(feats[i])
            stem_feats.append(x)
            cls_list.append(getattr(self, f"cls_pred_{i}")(getattr(self, f"cls_conv_{i}")(x)))
            reg_list.append(getattr(self, f"reg_pred_{i}")(getattr(self, f"reg_conv_{i}")(x)))

        b = feats[0].shape[0]
        cls_scores = torch.cat([_flat_nhwc(torch.sigmoid(c)) for c in cls_list], dim=1)
        if self.training:
            reg_distri = torch.cat([_flat_nhwc(r) for r in reg_list], dim=1)
            return stem_feats, cls_scores, reg_distri

        proj = torch.arange(self.reg_max + 1, dtype=torch.float32, device=cls_scores.device)
        reg_dist = torch.cat(
            [
                torch.softmax(_flat_nhwc(r).reshape(b, -1, 4, self.reg_max + 1), dim=-1) @ proj
                for r in reg_list
            ],
            dim=1,
        )  # (B, A, 4): DFL expectation over reg_max + 1 bins

        feat_shapes = [tuple(f.shape[2:]) for f in feats]
        anchor_points, stride_tensor = generate_anchors_eval(
            feat_shapes, self.strides, device=cls_scores.device
        )
        boxes = dist2bbox(reg_dist, anchor_points[None], box_format="xywh")
        boxes = boxes * stride_tensor[None]
        ones = torch.ones((b, boxes.shape[1], 1), dtype=boxes.dtype, device=boxes.device)
        return torch.cat([boxes, ones, cls_scores], dim=-1)
