"""Anchor generation for the anchor-free head (the JAX package's
``train/anchors.py``: the eval-mode part the serving path uses)."""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

GRID_CELL_OFFSET = 0.5


def generate_anchors_eval(
    feat_shapes: Sequence[Tuple[int, int]],
    strides: Sequence[int],
    device=None,
):
    """Eval-mode anchors: cell-centre points in grid units (A, 2) and the
    per-anchor stride (A, 1), levels in order, row-major within a level."""
    points, stride_list = [], []
    for (h, w), s in zip(feat_shapes, strides):
        sx = torch.arange(w, dtype=torch.float32, device=device) + GRID_CELL_OFFSET
        sy = torch.arange(h, dtype=torch.float32, device=device) + GRID_CELL_OFFSET
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        points.append(torch.stack([gx, gy], dim=-1).reshape(-1, 2))
        stride_list.append(torch.full((h * w, 1), float(s), device=device))
    return torch.cat(points), torch.cat(stride_list)
