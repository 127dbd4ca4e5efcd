"""Batched histogram, voxel grid, event stack and time surface on the fused
segment reduce (``ops/fused_scatter.py``; port of the JAX package's
``reps/fused_reps.py``): one launch a batch, K2 (sums only) or K1 (sums and
maxes) on CUDA tensors, their plain version on CPU tensors.

- histogram: 2 count sum columns (K2, Ks=2).
- voxel grid: 12 sum columns; column j collects pol*(1-dt) where ti == j
  plus pol*dt where ti == j-1, the bilinear split without a bins x pixels
  segment space (K2, Ks=12).
- event stack: 12 max columns over an order/polarity encoding
  ``enc = 2*pos + [p>0]``, decoded to the last event's polarity per suffix
  window (K1, Ks=1 unused, Km=12).
- time surface: segments are polarity x pixels (2*H*W), 6 max columns of t
  masked by "position <= query index", then the exponential decay (K1, Ks=1
  unused, Km=6).

TORE has no fused form: ``tore.py`` runs one segmented top-k for the batch.
"""
from __future__ import annotations

import torch

from ..events.core import EventBlock
from ..ops.fused_scatter import NEG_INF, fused_segment_reduce
from .event_stack import STACK_SIZE, suffix_starts
from .time_surface import N_SLICES, TAU_DEFAULT, alive_queries, query_indices

# 2*pos + 1 is exact in float32 below 2^24; the JAX package states 2^22
MAX_EVENT_STACK_EVENTS = 2**22


def _base(blocks: EventBlock, width: int):
    """(B, N, num, valid, flat pixel ids) of a batched block."""
    B, N = blocks.x.shape
    num = blocks.num.to(torch.int32)
    valid = blocks.mask
    pix = blocks.y.to(torch.int32) * width + blocks.x.to(torch.int32)
    return B, N, num, valid, pix


def _seg(valid, ids, num_segments: int):
    return torch.where(valid, ids, num_segments).to(torch.int32)


def histogram_fused_batched(blocks: EventBlock, height: int, width: int) -> torch.Tensor:
    """(B, H, W, 2) counts, channel 0 p<=0, channel 1 p>0."""
    B, N, num, valid, pix = _base(blocks, width)
    S = height * width

    def columns(pos_s, p_s):
        vs = torch.stack([(p_s <= 0).to(torch.float32), (p_s > 0).to(torch.float32)], dim=1)
        return vs, None  # sum only: K2

    sums, _ = fused_segment_reduce(_seg(valid, pix, S), (blocks.p.to(torch.int32),), columns, S)
    return sums.reshape(B, height, width, 2)


def voxel_grid_fused_batched(blocks: EventBlock, height: int, width: int,
                             n_time_bins: int = 12) -> torch.Tensor:
    """(B, H, W, n_time_bins) signed bilinear voxel grid."""
    B, N, num, valid, pix = _base(blocks, width)
    S = height * width
    t = blocks.t.to(torch.float32)
    t0 = t[:, 0]
    t_last = t.gather(1, torch.clamp(num - 1, min=0).to(torch.int64)[:, None])[:, 0]
    span = torch.clamp(t_last - t0, min=1e-9)

    def columns(pos_s, t_s, p_s):
        # JAX's float32 operation order, term by term
        ts = n_time_bins * (t_s - t0[:, None]) / span[:, None]
        ti = torch.floor(ts).to(torch.int32)
        dt = ts - ti.to(torch.float32)
        pol = torch.where(p_s > 0, 1.0, -1.0)
        v_valid = pos_s < num[:, None]
        left = pol * (1.0 - dt) * v_valid * (ti < n_time_bins)
        right = pol * dt * v_valid * (ti + 1 < n_time_bins)
        vs = torch.stack([left * (ti == j) + right * (ti == j - 1) for j in range(n_time_bins)],
                         dim=1)
        return vs, None  # sum only: K2

    sums, _ = fused_segment_reduce(_seg(valid, pix, S), (t, blocks.p.to(torch.int32)),
                                   columns, S)
    return sums.reshape(B, height, width, n_time_bins)


def event_stack_fused_batched(blocks: EventBlock, height: int, width: int,
                              stack_size: int = STACK_SIZE) -> torch.Tensor:
    """(B, H, W, stack_size) polarity in {-1, 0, +1} of the last event of
    each pixel within each suffix window."""
    B, N, num, valid, pix = _base(blocks, width)
    if N > MAX_EVENT_STACK_EVENTS:
        raise ValueError(f"event stack encodes 2*pos + [p>0] in float32: N={N} is above "
                         f"{MAX_EVENT_STACK_EVENTS}")
    S = height * width
    starts = suffix_starts(num, stack_size)  # (B, stack_size)

    def columns(pos_s, p_s):
        v_valid = pos_s < num[:, None]
        enc = 2.0 * pos_s.to(torch.float32) + (p_s > 0).to(torch.float32)
        vm = torch.stack([torch.where(v_valid & (pos_s >= starts[:, s, None]), enc, NEG_INF)
                          for s in range(stack_size)], dim=1)
        return torch.zeros((B, 1, N), device=enc.device), vm

    _, maxes = fused_segment_reduce(_seg(valid, pix, S), (blocks.p.to(torch.int32),), columns, S)
    pol = 2.0 * torch.remainder(maxes, 2.0) - 1.0
    out = torch.where(maxes <= NEG_INF / 2, 0.0, pol)
    return out.reshape(B, height, width, stack_size)


def time_surface_fused_batched(blocks: EventBlock, height: int, width: int,
                               tau: float = TAU_DEFAULT, n_slices: int = N_SLICES) -> torch.Tensor:
    """(B, H, W, 2*n_slices) time surface, slice-major, polarity minor."""
    B, N, num, valid, pix = _base(blocks, width)
    hw = height * width
    S2 = 2 * hw
    seg = _seg(valid, (blocks.p > 0).to(torch.int32) * hw + pix, S2)
    t = blocks.t.to(torch.float32)
    idx = query_indices(blocks, n_slices)  # (B, n_slices)
    alive = alive_queries(idx)
    t_q = t.gather(1, torch.clamp(idx, max=N - 1).to(torch.int64))  # JAX clamps too
    init = -(3.0 * tau + 1.0)

    def columns(pos_s, t_s):
        v_valid = pos_s < num[:, None]
        vm = torch.stack([torch.where(v_valid & (pos_s <= idx[:, q, None]), t_s, NEG_INF)
                          for q in range(n_slices)], dim=1)
        return torch.zeros((B, 1, N), device=t_s.device), vm

    _, maxes = fused_segment_reduce(seg, (t,), columns, S2)  # (B, 2*H*W, n_slices)
    mem = torch.where(maxes <= NEG_INF / 2, init, maxes)
    surf = torch.exp((mem - t_q[:, None, :]) / tau)
    surf = torch.where(alive[:, None, :], surf, 0.0)
    # (B, 2, H, W, n) -> (B, H, W, n, 2) -> (B, H, W, 2n)
    surf = surf.reshape(B, 2, height, width, n_slices).permute(0, 2, 3, 4, 1)
    return surf.reshape(B, height, width, n_slices * 2)
