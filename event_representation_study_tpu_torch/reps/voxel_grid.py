"""Bilinear-in-time voxel grid (tonic ``ToVoxelGrid`` semantics; port of
the JAX package's ``reps/voxel_grid.py``).

Timestamps are normalized to ``[0, n_bins]``; each event's polarity is split
between the two straddling bins with weights ``(1-dt, dt)``. An event in the
open last-bin boundary (``ti == n_bins``, the final event) adds nothing, as
tonic's two validity filters drop both of its halves.
"""
from __future__ import annotations

import torch

from ..events.core import EventBlock
from ..ops import scatter


def voxel_grid(block: EventBlock, height: int, width: int, n_time_bins: int = 12) -> torch.Tensor:
    """(H, W, n_time_bins) float32 signed bilinear voxel grid."""
    mask = block.mask
    t = block.t.to(torch.float32)
    t_last = t[torch.clamp(block.num - 1, min=0)]
    t_first = t[0]
    span = torch.clamp(t_last - t_first, min=1e-9)
    ts = n_time_bins * (t - t_first) / span  # in [0, n_bins]
    ti = torch.floor(ts).to(torch.int32)
    dt = ts - ti.to(torch.float32)
    pol = torch.where(block.p > 0, 1.0, -1.0)  # tonic: pols[pols == 0] = -1

    pix = scatter.flat_pixel_index(block.x, block.y, width)
    hw = height * width
    nseg = n_time_bins * hw
    grid = scatter.segment_sum(pol * (1.0 - dt), ti * hw + pix, mask & (ti < n_time_bins), nseg)
    grid = grid + scatter.segment_sum(pol * dt, (ti + 1) * hw + pix,
                                      mask & (ti + 1 < n_time_bins), nseg)
    # (n_bins, H, W) -> (H, W, n_bins), as gen1_transforms.py:24-25
    return grid.reshape(n_time_bins, height, width).permute(1, 2, 0)
