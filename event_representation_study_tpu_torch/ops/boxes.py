"""Box geometry ops over (..., 4) tensors (the JAX package's ``ops/boxes.py``:
the parts the serving path uses)."""
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


def xywh2xyxy(b):
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


def box_iou_pairwise(a, b, eps: float = 1e-7):
    """IoU matrix between (..., N, 4) and (..., M, 4) xyxy boxes."""
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter + eps)
