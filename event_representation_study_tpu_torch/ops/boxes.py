"""Box geometry ops over (..., 4) tensors (the JAX package's ``ops/boxes.py``:
the parts the serving and training paths use)."""
from __future__ import annotations

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
    """Elementwise IoU or GIoU of aligned (..., 4) xyxy boxes (the value,
    not 1 - value). The other IoU variants belong to ROADMAP M14."""
    if iou_type not in ("iou", "giou"):
        raise NotImplementedError(f"iou_type {iou_type!r} is not ported (ROADMAP M14)")
    b1x1, b1y1, b1x2, b1y2 = box1.unbind(-1)
    b2x1, b2y1, b2x2, b2y2 = box2.unbind(-1)
    iw = (torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1)).clamp(min=0)
    ih = (torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1)).clamp(min=0)
    inter = iw * ih
    union = (b1x2 - b1x1) * (b1y2 - b1y1) + (b2x2 - b2x1) * (b2y2 - b2y1) - inter + eps
    iou = inter / union
    if iou_type == "iou":
        return iou
    cw = torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)
    ch = torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)
    c_area = cw * ch + eps
    return iou - (c_area - union) / c_area
