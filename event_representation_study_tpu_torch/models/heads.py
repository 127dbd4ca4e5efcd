"""Efficient Decoupled Heads (the JAX package's ``models/heads.py``):
:class:`EffiDeHead` (anchor-free, DFL), :class:`EffiDeHeadFuseAB` (plus the
train-time anchor-base branch) and :class:`EffiDeHeadDistillNS` (plus the
distribution branch that the nano/small distillation loss reads).

Per level: 1x1 stem -> (3x3 cls conv -> 1x1 cls pred) and
(3x3 reg conv -> 1x1 reg pred with 4*(reg_max+1) outputs).
Train output: per-level stem features (NCHW) + concatenated (B, A, nc)
sigmoid class scores + (B, A, 4*(reg_max+1)) reg distributions.
Eval output: DFL softmax-projection + dist2bbox decode, stride-scaled,
concat [bbox(4) | ones | cls] -> (B, A, 5+nc); with ``use_dfl=False`` the
reg pred's channels are read as ltrb distances directly, as the JAX head
reads them.
Anchors run level by level and row-major within a level, as in the NHWC
reference, so every per-level map is flattened from (B, H, W, C).

Under a bfloat16 model (``Detector(dtype=torch.bfloat16)``, autocast) the
decode keeps the JAX package's type promotion: the softmax runs on the
bf16 logits, its product with the float32 ``proj`` and the boxes in
float32; the sigmoid scores are bf16, widened by the concatenation. What
reaches NMS is float32.
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
                 reg_max: int = 16, use_dfl: bool = True):
        super().__init__()
        self.num_classes = num_classes
        self.strides = tuple(strides)
        self.reg_max = reg_max
        self.use_dfl = use_dfl
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
        """Every pred conv (the anchor-base and distribution ones too)
        starts at zero weights, a class pred's bias at -log((1-p)/p) with
        p=0.01, a reg pred's at 1.0."""
        with torch.no_grad():
            for name, conv in self.named_children():
                if "_pred_" in name:
                    conv.weight.zero_()
                    conv.bias.fill_(-math.log((1 - PRIOR_PROB) / PRIOR_PROB)
                                    if name.startswith("cls") else 1.0)

    def _level(self, feats, i):
        """Level ``i``'s stem features and its class and box branches."""
        x = getattr(self, f"stem_{i}")(feats[i])
        return x, getattr(self, f"cls_conv_{i}")(x), getattr(self, f"reg_conv_{i}")(x)

    def forward(self, feats):
        assert len(feats) == self.nl
        cls_list, reg_list, stem_feats = [], [], []
        for i in range(self.nl):
            x, cls_f, reg_f = self._level(feats, i)
            stem_feats.append(x)
            cls_list.append(getattr(self, f"cls_pred_{i}")(cls_f))
            reg_list.append(getattr(self, f"reg_pred_{i}")(reg_f))

        cls_scores = torch.cat([_flat_nhwc(torch.sigmoid(c)) for c in cls_list], dim=1)
        if self.training:
            reg_distri = torch.cat([_flat_nhwc(r) for r in reg_list], dim=1)
            return stem_feats, cls_scores, reg_distri

        with torch.autocast(cls_scores.device.type, enabled=False):
            return self._decode(feats, cls_scores, reg_list)

    def _decode(self, feats, cls_scores, reg_list, use_dfl=None):
        b = cls_scores.shape[0]
        if self.use_dfl if use_dfl is None else use_dfl:  # the DFL expectation over reg_max + 1 bins
            proj = torch.arange(self.reg_max + 1, dtype=torch.float32, device=cls_scores.device)
            reg_dist = torch.cat(
                [torch.softmax(_flat_nhwc(r).reshape(b, -1, 4, self.reg_max + 1), dim=-1)
                 .to(torch.float32) @ proj for r in reg_list],
                dim=1,
            )
        else:
            reg_dist = torch.cat([_flat_nhwc(r).reshape(b, -1, 4) for r in reg_list],
                                 dim=1).to(torch.float32)
        feat_shapes = [tuple(f.shape[2:]) for f in feats]
        anchor_points, stride_tensor = generate_anchors_eval(
            feat_shapes, self.strides, device=cls_scores.device
        )
        boxes = dist2bbox(reg_dist, anchor_points[None], box_format="xywh")
        boxes = boxes * stride_tensor[None]
        ones = torch.ones((b, boxes.shape[1], 1), dtype=boxes.dtype, device=boxes.device)
        return torch.cat([boxes, ones, cls_scores.to(boxes.dtype)], dim=-1)


class EffiDeHeadFuseAB(EffiDeHead):
    """The fuse-anchor-base head: :class:`EffiDeHead` plus per-level
    anchor-base pred convs on the shared class and box branches
    (``cls_pred_ab_i``: na * nc channels, ``reg_pred_ab_i``: na * 4). Train
    returns both branches, ``(stem_feats, cls_ab, reg_ab, cls_af,
    reg_af)``; eval is the anchor-free decode of :class:`EffiDeHead`.

    ``anchors``: per level the flattened (w, h) pairs of its na priors in
    pixels. An ab conv's channel ``a * nc + c`` is anchor ``a``'s class
    ``c``, so its output (B, na * nc, H, W) flattens to (B, na * H * W, nc)
    with the anchor slowest, as the JAX head's NHWC reshape does. The box
    branch gives (x, y) offsets in grid units as they are and
    wh = (2 sigmoid)^2 * anchor / stride."""

    def __init__(self, num_classes: int, in_channels: Sequence[int],
                 feat_channels: Sequence[int], anchors: Sequence[Sequence[float]],
                 strides=(8, 16, 32), reg_max: int = 16, use_dfl: bool = True):
        super().__init__(num_classes, in_channels, feat_channels, strides, reg_max, use_dfl)
        self.na = len(anchors[0]) // 2
        for i, c in enumerate(in_channels):
            self.add_module(f"cls_pred_ab_{i}", nn.Conv2d(c, self.na * num_classes, 1))
            self.add_module(f"reg_pred_ab_{i}", nn.Conv2d(c, self.na * 4, 1))
            self.register_buffer(
                f"anchors_{i}",
                torch.tensor(anchors[i], dtype=torch.float32).reshape(self.na, 2) / strides[i],
                persistent=False)
        self.reset_pred_parameters()

    def forward(self, feats):
        assert len(feats) == self.nl
        cls_af, reg_af, cls_ab, reg_ab, stem_feats = [], [], [], [], []
        for i in range(self.nl):
            x, cls_f, reg_f = self._level(feats, i)
            stem_feats.append(x)
            cls_af.append(getattr(self, f"cls_pred_{i}")(cls_f))
            reg_af.append(getattr(self, f"reg_pred_{i}")(reg_f))
            if self.training:
                b, _, h, w = cls_f.shape
                co = getattr(self, f"cls_pred_ab_{i}")(cls_f)
                co = torch.sigmoid(co).view(b, self.na, self.num_classes, h, w)
                cls_ab.append(co.permute(0, 1, 3, 4, 2).reshape(b, -1, self.num_classes))
                ro = getattr(self, f"reg_pred_ab_{i}")(reg_f).view(b, self.na, 4, h, w)
                ro = ro.permute(0, 1, 3, 4, 2)
                anc = getattr(self, f"anchors_{i}")[None, :, None, None, :]
                wh = (torch.sigmoid(ro[..., 2:4]) * 2) ** 2 * anc
                reg_ab.append(torch.cat([ro[..., :2], wh], -1).reshape(b, -1, 4))
        cls_scores = torch.cat([_flat_nhwc(torch.sigmoid(c)) for c in cls_af], dim=1)
        if self.training:
            reg_distri = torch.cat([_flat_nhwc(r) for r in reg_af], dim=1)
            return (stem_feats, torch.cat(cls_ab, 1), torch.cat(reg_ab, 1), cls_scores,
                    reg_distri)
        with torch.autocast(cls_scores.device.type, enabled=False):
            return self._decode(feats, cls_scores, reg_af)


class EffiDeHeadDistillNS(EffiDeHead):
    """The cost-free distillation head of the nano/small models: the box
    branch has a 4-channel ltrb pred (``reg_pred_i``), which the deployed
    decode reads, and a 4 * (reg_max + 1) distribution pred
    (``reg_pred_dist_i``), which only the distillation loss reads. Train
    returns ``(stem_feats, cls_scores, reg_lrtb, reg_dist)``."""

    def __init__(self, num_classes: int, in_channels: Sequence[int],
                 feat_channels: Sequence[int], strides=(8, 16, 32), reg_max: int = 16):
        super().__init__(num_classes, in_channels, feat_channels, strides, reg_max, True)
        for i, c in enumerate(in_channels):
            self.add_module(f"reg_pred_{i}", nn.Conv2d(c, 4, 1))
            self.add_module(f"reg_pred_dist_{i}", nn.Conv2d(c, 4 * (reg_max + 1), 1))
        self.reset_pred_parameters()

    def forward(self, feats):
        assert len(feats) == self.nl
        cls_list, reg_list, dist_list, stem_feats = [], [], [], []
        for i in range(self.nl):
            x, cls_f, reg_f = self._level(feats, i)
            stem_feats.append(x)
            cls_list.append(getattr(self, f"cls_pred_{i}")(cls_f))
            reg_list.append(getattr(self, f"reg_pred_{i}")(reg_f))
            dist_list.append(getattr(self, f"reg_pred_dist_{i}")(reg_f))
        cls_scores = torch.cat([_flat_nhwc(torch.sigmoid(c)) for c in cls_list], dim=1)
        if self.training:
            return (stem_feats, cls_scores, torch.cat([_flat_nhwc(r) for r in reg_list], 1),
                    torch.cat([_flat_nhwc(r) for r in dist_list], 1))
        with torch.autocast(cls_scores.device.type, enabled=False):
            return self._decode(feats, cls_scores, reg_list, use_dfl=False)
