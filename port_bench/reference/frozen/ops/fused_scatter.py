"""Frozen plain copy of the port's ``ops/fused_scatter.py``: the sort glue
and the plain segment reduction (``index_add_`` for the sums,
``scatter_reduce_("amax")`` for the maxes), with no CUDA kernel. Ids >=
``num_segments`` are dropped; empty segments give sum 0 and max NEG_INF."""
from __future__ import annotations

import torch

NEG_INF = -3.4e38


def sort_columns(seg, carry, columns_fn):
    """One stable sort by segment id, the carry streams gathered along it,
    and the value columns ``columns_fn(sorted_pos, *sorted_carry)``."""
    seg_s, order = torch.sort(seg, dim=1, stable=True)
    carry_s = [torch.gather(c, 1, order) for c in carry]
    vs, vm = columns_fn(order.to(torch.int32), *carry_s)
    return seg_s, vs.contiguous(), None if vm is None else vm.contiguous()


def fused_segment_reduce(seg, carry, columns_fn, num_segments: int):
    """``(sums (B, S, Ks), maxes (B, S, Km) or None)``."""
    return segment_reduce_sorted_plain(*sort_columns(seg, carry, columns_fn), num_segments)


def segment_reduce_sorted_plain(seg_s, vs, vm, num_segments: int):
    B, ks, n = vs.shape
    S = num_segments
    rows = torch.arange(B, device=vs.device)[:, None] * (S + 1)
    idx = (seg_s.to(torch.int64).clamp_max(S) + rows).reshape(-1)
    sums = torch.zeros((B * (S + 1), ks), dtype=torch.float32, device=vs.device)
    sums.index_add_(0, idx, vs.transpose(1, 2).reshape(B * n, ks))
    sums = sums.view(B, S + 1, ks)[:, :S].contiguous()
    if vm is None:
        return sums, None
    km = vm.shape[1]
    maxes = torch.full((B * (S + 1), km), NEG_INF, dtype=torch.float32, device=vs.device)
    maxes.scatter_reduce_(
        0, idx[:, None].expand(-1, km), vm.transpose(1, 2).reshape(B * n, km),
        "amax", include_self=True,
    )
    return sums, maxes.view(B, S + 1, km)[:, :S].contiguous()
