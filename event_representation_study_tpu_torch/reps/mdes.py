"""MixedDensityEventStack (MDES), the 12-channel representation search
space, per sample (port of the JAX package's ``reps/mdes.py``; the batched
form on K1/K2 is ``fused_mdes.py``).

- Measurements {timestamp, polarity, count, timestamp_pos, timestamp_neg,
  count_pos, count_neg}, aggregations {mean, max, sum, variance} with
  variance = E[x^2] - E[x]^2. ``*_neg`` selects ``p == -1`` and falls back
  to ``p == 0`` when the window has no negative event. Empty bins are 0.
- Timestamps are min-shifted and normalized ``t_s = t / (t_max - t_min)``
  before windowing. SBN windows: [0] all events, [1..3] thirds by index,
  [4..6] halving suffixes. SBT windows: [1..3] thirds by normalized time,
  [4..7] prefixes t <= 1/2, 1/4, 1/8, 1/16.
- A channel whose window is empty, or whose global time span is zero, is all
  zeros (the reference's try/except).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..events.core import EventBlock
from ..ops import scatter

FUNCTIONS = (
    "timestamp",
    "polarity",
    "count",
    "timestamp_pos",
    "timestamp_neg",
    "count_pos",
    "count_neg",
)
AGGREGATIONS = ("mean", "max", "sum", "variance")


def sbn_window_mask(block: EventBlock, window: int) -> torch.Tensor:
    """Boolean event mask of SBN window ``window`` (0..6)."""
    num = block.num.to(torch.int32)
    order = block.index()
    m = block.mask
    if window == 0:
        return m
    if 1 <= window <= 3:
        third = num // 3
        i = window - 1
        return m & (order >= i * third) & (order < (i + 1) * third)
    start = num // 2  # suffix windows 4..6: drop num/2, then num/4, then num/8
    if window >= 5:
        start = start + num // 4
    if window >= 6:
        start = start + num // 8
    return m & (order >= start)


def sbt_window_mask(block: EventBlock, window: int, t_s: torch.Tensor) -> torch.Tensor:
    """Boolean event mask of SBT window ``window`` (0..7) over normalized
    time ``t_s`` in [0, 1]."""
    m = block.mask
    if window == 0:
        return m
    if 1 <= window <= 3:
        # bounds rounded to float32, as JAX compares them with float32 times
        lo, hi = np.float32((window - 1) / 3.0), np.float32(window / 3.0)
        return m & (t_s >= float(lo)) & (t_s <= float(hi))
    return m & (t_s <= 0.5 ** (window - 3))  # windows 4..7 -> 1/2 .. 1/16


def measurement(block: EventBlock, t_s: torch.Tensor, func: str) -> Tuple[torch.Tensor, object]:
    """Per-event (value, selector mask or None) of one measurement; the
    ``*_neg`` selector and its fallback are resolved per window."""
    ones = torch.ones_like(t_s)
    p = block.p
    if func == "timestamp":
        return t_s, None
    if func == "polarity":
        return p.to(torch.float32), None
    if func == "count":
        return ones, None
    if func == "timestamp_pos":
        return t_s, p == 1
    if func == "timestamp_neg":
        return t_s, None
    if func == "count_pos":
        return ones, p == 1
    if func == "count_neg":
        return ones, None
    raise ValueError(f"unknown measurement function: {func}")


def _neg_selector(block: EventBlock, window_mask: torch.Tensor) -> torch.Tensor:
    """p == -1 within the window, or p == 0 when it has no negative event."""
    neg = (block.p == -1) & window_mask
    return torch.where(neg.any(), neg, (block.p == 0) & window_mask)


def aggregate(values, seg, mask, nseg: int, agg: str) -> torch.Tensor:
    if agg == "sum":
        return scatter.segment_sum(values, seg, mask, nseg)
    if agg == "mean":
        return scatter.segment_mean(values, seg, mask, nseg)
    if agg == "max":
        return scatter.segment_max(values, seg, mask, nseg)
    if agg == "variance":
        return scatter.segment_var(values, seg, mask, nseg)
    raise ValueError(f"unknown aggregation: {agg}")


def normalized_times(block: EventBlock) -> torch.Tensor:
    """Globally normalized timestamps t_s in [0, 1]."""
    t = block.t.to(torch.float32)
    t0 = t[0]
    span = t[torch.clamp(block.num - 1, min=0)] - t0
    return (t - t0) / torch.clamp(span, min=1.0)


def mixed_density_event_stack(
    block: EventBlock,
    height: int,
    width: int,
    window_indexes: Sequence[int],
    functions: Sequence[str],
    aggregations: Sequence[str],
    stacking_type: str = "SBN",
) -> torch.Tensor:
    """(H, W, C) float32 MDES stack of the (window, function, aggregation)
    triples of one block (leaves ``(N,)``)."""
    if not len(window_indexes) == len(functions) == len(aggregations):
        raise ValueError("window_indexes, functions and aggregations differ in length")
    t_s = normalized_times(block)
    t = block.t.to(torch.float32)
    span_ok = (t[torch.clamp(block.num - 1, min=0)] - t[0]) > 0
    seg = scatter.flat_pixel_index(block.x, block.y, width)
    nseg = height * width

    channels = []
    for w, f, a in zip(window_indexes, functions, aggregations):
        if stacking_type == "SBN":
            wmask = sbn_window_mask(block, int(w))
        elif stacking_type == "SBT":
            wmask = sbt_window_mask(block, int(w), t_s)
        else:
            raise ValueError(f"unknown stacking_type: {stacking_type}")
        values, selector = measurement(block, t_s, f)
        if f in ("timestamp_neg", "count_neg"):
            emask = _neg_selector(block, wmask) & wmask
        elif selector is not None:
            emask = wmask & selector
        else:
            emask = wmask
        ch = aggregate(values, seg, emask, nseg, a)
        ch = torch.where(span_ok & emask.any(), ch, 0.0)
        channels.append(ch.reshape(height, width))
    return torch.stack(channels, dim=-1)
