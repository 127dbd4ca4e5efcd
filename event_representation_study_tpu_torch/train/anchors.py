"""Anchor generation for the anchor-free head (the JAX package's
``train/anchors.py``)."""
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


def generate_anchors_train(
    feat_shapes: Sequence[Tuple[int, int]],
    strides: Sequence[int],
    grid_cell_size: float = 5.0,
    device=None,
):
    """Train-mode anchors in image units: ATSS cell boxes (A, 4), centre
    points (A, 2), per-level counts, and the per-anchor stride (A, 1)."""
    anchors, points, stride_list, num_list = [], [], [], []
    for (h, w), s in zip(feat_shapes, strides):
        half = grid_cell_size * s * 0.5
        sx = (torch.arange(w, dtype=torch.float32, device=device) + GRID_CELL_OFFSET) * s
        sy = (torch.arange(h, dtype=torch.float32, device=device) + GRID_CELL_OFFSET) * s
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        anchors.append(torch.stack([gx - half, gy - half, gx + half, gy + half], -1).reshape(-1, 4))
        points.append(torch.stack([gx, gy], dim=-1).reshape(-1, 2))
        num_list.append(h * w)
        stride_list.append(torch.full((h * w, 1), float(s), device=device))
    return torch.cat(anchors), torch.cat(points), num_list, torch.cat(stride_list)
