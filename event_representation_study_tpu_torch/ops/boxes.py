"""Box geometry ops over (..., 4) tensors (the JAX package's ``ops/boxes.py``)."""
from __future__ import annotations

import math

import torch


def dist2bbox(distance, anchor_points, box_format: str = "xyxy"):
    """ltrb distances + anchor points -> boxes."""
    lt, rb = distance.chunk(2, dim=-1)
    x1y1 = anchor_points - lt
    x2y2 = anchor_points + rb
    if box_format == "xyxy":
        return torch.cat([x1y1, x2y2], dim=-1)
    return torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], dim=-1)


def bbox2dist(anchor_points, bbox, reg_max: int):
    """xyxy boxes -> ltrb distances clipped to [0, reg_max - 0.01]."""
    x1y1, x2y2 = bbox.chunk(2, dim=-1)
    return torch.cat([anchor_points - x1y1, x2y2 - anchor_points], dim=-1).clamp(0, reg_max - 0.01)


def xywh2xyxy(b):
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


def xyxy2xywh(b):
    x1, y1, x2, y2 = b.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], dim=-1)


def box_iou_pairwise(a, b, eps: float = 1e-7):
    """IoU matrix between (..., N, 4) and (..., M, 4) xyxy boxes."""
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter + eps)


def iou_loss(box1, box2, iou_type: str = "giou", eps: float = 1e-9):
    """Elementwise IoU family (iou, giou, diou, ciou, siou) of aligned
    (..., 4) xyxy boxes: the value, not 1 - value."""
    b1x1, b1y1, b1x2, b1y2 = box1.unbind(-1)
    b2x1, b2y1, b2x2, b2y2 = box2.unbind(-1)
    iw = (torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1)).clamp(min=0)
    ih = (torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1)).clamp(min=0)
    inter = iw * ih
    w1, h1 = b1x2 - b1x1, b1y2 - b1y1
    w2, h2 = b2x2 - b2x1, b2y2 - b2y1
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    if iou_type == "iou":
        return iou
    cw = torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)
    ch = torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)
    if iou_type == "giou":
        c_area = cw * ch + eps
        return iou - (c_area - union) / c_area
    if iou_type in ("diou", "ciou"):
        c2 = cw**2 + ch**2 + eps
        rho2 = ((b2x1 + b2x2 - b1x1 - b1x2) ** 2 + (b2y1 + b2y2 - b1y1 - b1y2) ** 2) / 4
        if iou_type == "diou":
            return iou - rho2 / c2
        v = (4 / math.pi**2) * (torch.atan(w2 / (h2 + eps)) - torch.atan(w1 / (h1 + eps))) ** 2
        alpha = v / (v - iou + (1 + eps))
        return iou - (rho2 / c2 + v * alpha)
    if iou_type == "siou":  # SCYLLA-IoU: angle, distance and shape costs
        s_cw = (b2x1 + b2x2 - b1x1 - b1x2) * 0.5
        s_ch = (b2y1 + b2y2 - b1y1 - b1y2) * 0.5
        sigma = torch.sqrt(s_cw**2 + s_ch**2) + eps
        sin_a = s_cw.abs() / sigma
        sin_b = s_ch.abs() / sigma
        sin_a = torch.where(sin_a > math.sin(math.pi / 4), sin_b, sin_a)
        angle_cost = torch.cos(torch.asin(sin_a) * 2 - math.pi / 2)
        gamma = angle_cost - 2
        distance_cost = (2 - torch.exp(gamma * (s_cw / (cw + eps)) ** 2)
                         - torch.exp(gamma * (s_ch / (ch + eps)) ** 2))
        omiga_w = (w1 - w2).abs() / torch.maximum(w1, w2)
        omiga_h = (h1 - h2).abs() / torch.maximum(h1, h2)
        shape_cost = (1 - torch.exp(-omiga_w)) ** 4 + (1 - torch.exp(-omiga_h)) ** 4
        return iou - 0.5 * (distance_cost + shape_cost)
    raise ValueError(f"unknown iou_type: {iou_type}")
