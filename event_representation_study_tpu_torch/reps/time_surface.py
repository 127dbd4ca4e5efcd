"""HOTS-style exponential-decay time surface (port of the JAX package's
``reps/time_surface.py``).

The reference scans the events keeping a ``(2, H, W)`` last-timestamp memory
initialized to ``-(3*tau + 1)``; at each of 6 query event indices (the
``searchsorted`` of the 6 equal time fractions) it emits
``exp((memory - t_q) / tau)``, the query event included. A query index that
repeats (an empty time-sixth) stalls the reference's cursor, and every
surface from there on stays zero: an aliveness mask reproduces that. The scan
becomes 6 masked segment-max queries ("last event time at or before index
i_q"), exact because the stream is time-sorted.
"""
from __future__ import annotations

import torch

from ..events.core import EventBlock
from ..ops import scatter

TAU_DEFAULT = 50000.0
N_SLICES = 6


def query_indices(block: EventBlock, n_slices: int = N_SLICES) -> torch.Tensor:
    """int32 ``(..., n_slices)``: ``searchsorted(t_norm, 1..n_slices)`` with
    ``t_norm = (t - t0) / (tN - t0) * n_slices``, for leaves ``(N,)`` or
    ``(B, N)``."""
    t = block.t.to(torch.float32)
    last = torch.clamp(block.num - 1, min=0).to(torch.int64)[..., None]
    t0 = t[..., :1]
    span = torch.clamp(t.gather(-1, last) - t0, min=1e-30)
    t_norm = (t - t0) / span * n_slices
    # padding must not participate: force it above every query value
    t_norm = torch.where(block.mask, t_norm, float(n_slices + 1))
    targets = torch.arange(1, n_slices + 1, dtype=torch.float32, device=t.device)
    targets = targets.expand(*t.shape[:-1], n_slices).contiguous()
    return torch.searchsorted(t_norm.contiguous(), targets, side="left").to(torch.int32)


def alive_queries(idx: torch.Tensor) -> torch.Tensor:
    """bool like ``idx``: query j is live only if the indices strictly
    increase up to j (the reference's cursor, time_surface.py:65-74)."""
    inc = torch.ones_like(idx, dtype=torch.bool)
    inc[..., 1:] = idx[..., 1:] > idx[..., :-1]
    return torch.cumprod(inc.to(torch.int32), dim=-1).to(torch.bool)


def time_surface(block: EventBlock, height: int, width: int, tau: float = TAU_DEFAULT,
                 n_slices: int = N_SLICES) -> torch.Tensor:
    """(H, W, 2*n_slices) float32; channels slice-major, polarity {0=neg,
    1=pos} minor (gen1_transforms.py:84-86)."""
    idx = query_indices(block, n_slices)
    alive = alive_queries(idx)
    pix = scatter.flat_pixel_index(block.x, block.y, width)
    seg = (block.p > 0).to(torch.int32) * (height * width) + pix  # (2, H, W) flattened
    nseg = 2 * height * width
    order = block.index()
    t = block.t.to(torch.float32)
    init = -(3.0 * tau + 1.0)
    # an index past the block (a full block with zero time span) reads its
    # last event, as JAX's clamped gather does
    t_q = t[torch.clamp(idx, max=t.shape[0] - 1).to(torch.int64)]

    surfaces = []
    for q in range(n_slices):
        m = block.mask & (order <= idx[q])
        mem = scatter.segment_max(t, seg, m, nseg, zero_empty=False)
        mem = torch.where(torch.isneginf(mem), init, mem)
        surf = torch.exp((mem - t_q[q]) / tau)
        surfaces.append(torch.where(alive[q], surf, 0.0))
    return torch.stack(surfaces).reshape(n_slices * 2, height, width).permute(1, 2, 0)
