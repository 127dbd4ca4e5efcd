"""Masked segment reductions over the pixel grid: the per-sample primitive of
every representation (port of the JAX package's ``ops/scatter.py``).

Each reduction routes invalid events to a trash row at ``num_segments`` and
runs one ``index_add_`` or ``scatter_reduce`` (``include_self=False``) over
a flattened ``y*W + x`` index. Semantics (torch_scatter 2.x, as the
reference uses it):
- empty bins give 0 for every reduction (sum, mean, max, min, var);
- ``mean`` divides by the true bin count;
- ``max``/``min`` of a non-empty bin is the true extremum (it may be
  negative; the zero fill applies only to empty bins);
- ``var`` is the biased E[x^2] - E[x]^2.

All functions take ``values (N,)``, ``seg (N,)`` flat pixel ids, ``mask
(N,)`` bool and ``num_segments``; they return ``(num_segments,)`` float32.
This module is also the independent oracle of the plain K1/K2 version in
``ops/fused_scatter.py``.
"""
from __future__ import annotations

import torch

INT32_MAX = 2**31 - 1


def _masked_ids(seg, mask, num_segments: int) -> torch.Tensor:
    """int64 ids, invalid events routed to the trash segment ``num_segments``."""
    return torch.where(mask, seg.to(torch.int64), num_segments)


def segment_sum(values, seg, mask, num_segments: int):
    ids = _masked_ids(seg, mask, num_segments)
    out = torch.zeros(num_segments + 1, dtype=torch.float32, device=values.device)
    out.index_add_(0, ids, values.to(torch.float32))
    return out[:num_segments]


def segment_count(seg, mask, num_segments: int):
    return segment_sum(mask.to(torch.float32), seg, mask, num_segments)


def segment_mean(values, seg, mask, num_segments: int):
    s = segment_sum(values, seg, mask, num_segments)
    c = segment_count(seg, mask, num_segments)
    return s / torch.clamp(c, min=1.0)


def _segment_extremum(values, seg, mask, num_segments: int, reduce: str, empty: float):
    ids = _masked_ids(seg, mask, num_segments)
    out = torch.full((num_segments + 1,), empty, dtype=torch.float32, device=values.device)
    out.scatter_reduce_(0, ids, values.to(torch.float32), reduce, include_self=False)
    return out[:num_segments]


def segment_max(values, seg, mask, num_segments: int, *, zero_empty: bool = True):
    """Per-bin max; empty bins 0 (or -inf with ``zero_empty=False``)."""
    return _segment_extremum(values, seg, mask, num_segments, "amax",
                             0.0 if zero_empty else -float("inf"))


def segment_min(values, seg, mask, num_segments: int, *, zero_empty: bool = True):
    """Per-bin min; empty bins 0 (or +inf with ``zero_empty=False``)."""
    return _segment_extremum(values, seg, mask, num_segments, "amin",
                             0.0 if zero_empty else float("inf"))


def segment_var(values, seg, mask, num_segments: int):
    """Biased variance per bin: E[x^2] - E[x]^2."""
    m = segment_mean(values, seg, mask, num_segments)
    m2 = segment_mean(values * values, seg, mask, num_segments)
    return m2 - m * m


def segment_last_pos(seg, mask, num_segments: int):
    """int32 position of the last valid event of each bin, -1 for empty
    bins. Event streams are time-sorted, so "last in event order" is "most
    recent": this is the reference's last-write-wins ``np.put`` and the time
    surface's last-timestamp memory."""
    ids = _masked_ids(seg, mask, num_segments)
    order = torch.arange(seg.shape[0], dtype=torch.int64, device=seg.device)
    out = torch.full((num_segments + 1,), -1, dtype=torch.int64, device=seg.device)
    out.scatter_reduce_(0, ids, order, "amax", include_self=False)
    return out[:num_segments].to(torch.int32)


def scatter_last(values, seg, mask, num_segments: int):
    """Last-write-wins scatter in event order: the value of the last valid
    event of each bin; 0 for empty bins."""
    pos = segment_last_pos(seg, mask, num_segments)
    out = values.to(torch.float32)[torch.clamp(pos, min=0).to(torch.int64)]
    return torch.where(pos >= 0, out, 0.0)


def flat_pixel_index(x, y, width: int):
    """Flattened grid index ``y*W + x``, int32."""
    return (y.to(torch.int32) * width + x.to(torch.int32)).to(torch.int32)


def _sort_by_segment_then_recent(order_key, seg, mask, num_segments: int):
    """Stable sort by (segment, -key): JAX's two-key ``lax.sort`` as one
    stable sort on an int64 composite key. Returns (sorted ids, permutation,
    rank of each sorted event within its segment)."""
    ids = _masked_ids(seg, mask, num_segments)
    neg_key = torch.where(mask, -order_key.to(torch.int64), INT32_MAX)
    key = ids * 2**32 + (neg_key + 2**31)  # both parts fit 32 bits
    _, perm = torch.sort(key, stable=True)
    sorted_ids = ids[perm]
    i = torch.arange(ids.shape[0], dtype=torch.int64, device=ids.device)
    is_start = torch.ones_like(sorted_ids, dtype=torch.bool)
    is_start[1:] = sorted_ids[1:] != sorted_ids[:-1]
    seg_start = torch.cummax(torch.where(is_start, i, -1), dim=0).values
    return sorted_ids, perm, i - seg_start


def _scatter_topk(sorted_ids, rank, payload, num_segments: int, k: int, fill):
    """(num_segments, k) slots: the first ``k`` of each segment's sorted
    events; the rest go to a dropped trash slot."""
    take = (rank < k) & (sorted_ids < num_segments)
    flat = torch.where(take, sorted_ids * k + torch.clamp(rank, max=k - 1), num_segments * k)
    out = torch.full((num_segments * k + 1,), fill, dtype=payload.dtype, device=payload.device)
    out[flat] = payload  # unique slots for every kept event
    return out[: num_segments * k].reshape(num_segments, k)


def segment_topk_recent(order_key, seg, mask, num_segments: int, k: int):
    """For every segment, the positions of the ``k`` valid events with the
    largest ``order_key`` (e.g. the k most recent events of a pixel), ranked
    descending: int32 ``(num_segments, k)``, -1 where a segment has fewer
    than k events. The core of TORE."""
    sorted_ids, perm, rank = _sort_by_segment_then_recent(order_key, seg, mask, num_segments)
    return _scatter_topk(sorted_ids, rank, perm.to(torch.int32), num_segments, k, -1)


def segment_topk_recent_values(order_key, seg, mask, values, num_segments: int, k: int,
                               fill: float):
    """As :func:`segment_topk_recent`, with a float payload (``values`` of
    the chosen events) in the slots, ``fill`` where there is none."""
    sorted_ids, perm, rank = _sort_by_segment_then_recent(order_key, seg, mask, num_segments)
    return _scatter_topk(sorted_ids, rank, values.to(torch.float32)[perm], num_segments, k, fill)
