"""Batched MDES / ERGO-12 on the fused segment-reduce kernel.

Compiles a MixedDensityEventStack channel table (window, function,
aggregation) into a deduplicated set of sum- and max-columns, reduces them
all over one sort (:func:`..ops.fused_scatter.fused_segment_reduce`: one
kernel launch, or one a column group where a table needs more than the
kernel's 32 sum or 16 max columns), then combines channels elementwise:

- sum      -> 1 column
- mean     -> value + count columns (mean of ones == nonempty indicator)
- variance -> value + value^2 + count columns (E[x^2] - E[x]^2)
- max      -> 1 max column (empty bins -> 0, torch_scatter convention)

Window membership and polarity selectors are recomputed from sorted event
positions/polarities, so only (t, p) ride the sort. Port of the JAX
package's ``reps/fused_mdes.py``. :func:`mdes_partials` reduces a slice of
a stream whose first event sits at ``pos_offset``: window membership and
validity are judged against global positions, so summing the slices' sums
and taking the max of their maxes gives the whole stream's columns (the
event-axis sharding of ``parallel/event_shard.py``).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..events.core import EventBlock
from ..ops.fused_scatter import NEG_INF, fused_segment_reduce
from .ergo12 import AGGREGATIONS as E12_AGGS
from .ergo12 import FUNCTIONS as E12_FUNCS
from .ergo12 import WINDOW_INDEXES as E12_WINDOWS


def _plan(windows, funcs, aggs):
    """Static column plan: unique (kind, func, window) sum columns, unique
    (func, window) max columns and a per-channel recipe."""
    sum_cols, max_cols = [], []
    recipes = []

    def sum_col(key):
        if key not in sum_cols:
            sum_cols.append(key)
        return sum_cols.index(key)

    def max_col(key):
        if key not in max_cols:
            max_cols.append(key)
        return max_cols.index(key)

    for w, f, a in zip(windows, funcs, aggs):
        w = int(w)
        if a == "max":
            recipes.append(("max", max_col((f, w))))
        elif a == "sum":
            recipes.append(("sum", sum_col(("val", f, w))))
        elif a == "mean":
            recipes.append(("mean", sum_col(("val", f, w)), sum_col(("cnt", f, w))))
        elif a == "variance":
            recipes.append(
                ("var", sum_col(("val", f, w)), sum_col(("sq", f, w)),
                 sum_col(("cnt", f, w)))
            )
        else:
            raise ValueError(a)
    return tuple(sum_cols), tuple(max_cols), tuple(recipes)


def _f32(v: float) -> float:
    """A bound rounded to float32, so comparing it with float32 times gives
    the same answer in any precision."""
    return float(np.float32(v))


def _window_mask(w, pos, num, t_s, stacking):
    """Window membership for sorted or unsorted event positions.

    SBN: positional thirds + suffixes. SBT: normalized-time thirds
    (inclusive bounds) + prefixes t <= 1/2, 1/4, 1/8, 1/16 (8 windows).
    ``num`` is the per-sample count (B,) or a per-event count shaped like
    ``pos``."""
    numc = num[:, None] if num.dim() < pos.dim() else num
    valid = pos < numc
    if w == 0:
        return valid
    if stacking == "SBT":
        if 1 <= w <= 3:
            lo, hi = _f32((w - 1) / 3.0), _f32(w / 3.0)
            return valid & (t_s >= lo) & (t_s <= hi)
        return valid & (t_s <= 0.5 ** (w - 3))
    if 1 <= w <= 3:
        third = numc // 3
        return valid & (pos >= (w - 1) * third) & (pos < w * third)
    start = numc // 2
    if w >= 5:
        start = start + numc // 4
    if w >= 6:
        start = start + numc // 8
    return valid & (pos >= start)


def _mdes_columns(plan, num, t0, span, any_neg, stacking, pos_offset: int = 0):
    """The ``columns_fn`` of :func:`fused_segment_reduce` for a plan.
    ``pos_offset`` maps the sorted local positions to global stream
    positions (0 for a whole stream)."""
    sum_cols, max_cols, _ = plan

    def selector(f, w, p, wmask):
        if f in ("timestamp_pos", "count_pos"):
            return wmask & (p == 1)
        if f in ("timestamp_neg", "count_neg"):
            neg = torch.where(any_neg[:, w, None], p == -1, p == 0)
            return wmask & neg
        return wmask

    def value(f, t_s, p):
        if f.startswith("timestamp"):
            return t_s
        if f == "polarity":
            return p.to(torch.float32)
        return torch.ones_like(t_s)

    def columns_fn(pos_s, t_sorted, p_sorted):
        t_s = (t_sorted - t0[:, None]) / torch.clamp(span[:, None], min=1.0)
        p_i = p_sorted.to(torch.int32)
        wmasks = {}

        gpos = pos_s + pos_offset if pos_offset else pos_s

        def wm(w):
            if w not in wmasks:
                wmasks[w] = _window_mask(w, gpos, num, t_s, stacking)
            return wmasks[w]

        vs = []
        for kind, f, w in sum_cols:
            m = selector(f, w, p_i, wm(w)).to(torch.float32)
            if kind == "cnt":
                vs.append(m)
            elif kind == "val":
                vs.append(value(f, t_s, p_i) * m)
            else:  # sq
                v = value(f, t_s, p_i)
                vs.append(v * v * m)
        if not vs:
            # a table of maxes only (the JAX package raises here): K1 needs
            # a sum column, which no channel reads
            vs.append(torch.zeros_like(t_s))
        vm = []
        for f, w in max_cols:
            m = selector(f, w, p_i, wm(w))
            vm.append(torch.where(m, value(f, t_s, p_i), NEG_INF))
        if not vm:
            return torch.stack(vs, dim=1), None  # sum-only kernel K2
        return torch.stack(vs, dim=1), torch.stack(vm, dim=1)

    return columns_fn


def mdes_partials(x, y, t, p, num, height: int, width: int, plan, stacking: str,
                  t0, span, any_neg, pos_offset: int = 0):
    """(sums (B, S, Ks), maxes (B, S, Km) | None) from one fused reduction.

    The (B, N) leaves may be a slice of each stream whose first event has
    global position ``pos_offset``; ``num``, ``t0``, ``span`` and
    ``any_neg`` are the whole stream's. Summing the sums and taking the max
    of the maxes over the slices of a stream gives its unsliced result."""
    B, N = x.shape
    S = height * width
    pos = torch.arange(N, dtype=torch.int32, device=x.device).expand(B, N)
    valid = (pos + pos_offset if pos_offset else pos) < num[:, None]
    seg = torch.where(valid, y.to(torch.int32) * width + x.to(torch.int32), S)
    columns_fn = _mdes_columns(plan, num, t0, span, any_neg, stacking, pos_offset)
    return fused_segment_reduce(
        seg.to(torch.int32), (t.to(torch.float32), p.to(torch.int32)),
        columns_fn, S,
    )


def mdes_window_any_neg(p, pos, num, t_s, stacking: str):
    """(B, n_windows) bool: the window holds a p == -1 event — the input of
    the p == 0 fallback selector. ``pos`` are global positions; over the
    slices of a stream, OR the flags."""
    n_windows = 8 if stacking == "SBT" else 7
    p_i = p.to(torch.int32)
    return torch.stack(
        [
            ((p_i == -1) & _window_mask(w, pos, num, t_s, stacking)).any(dim=1)
            for w in range(n_windows)
        ],
        dim=1,
    )


def mdes_combine(sums, maxes, plan, span_ok, height: int, width: int):
    """Channel combination from the reduced columns -> (B, H, W, C)."""
    _, _, recipes = plan
    channels = []
    for r in recipes:
        if r[0] == "sum":
            ch = sums[..., r[1]]
        elif r[0] == "mean":
            ch = sums[..., r[1]] / torch.clamp(sums[..., r[2]], min=1.0)
        elif r[0] == "var":
            cnt = torch.clamp(sums[..., r[3]], min=1.0)
            m = sums[..., r[1]] / cnt
            m2 = sums[..., r[2]] / cnt
            ch = m2 - m * m
        else:  # max
            mx = maxes[..., r[1]]
            ch = torch.where(mx <= NEG_INF / 2, 0.0, mx)
        ch = torch.where(span_ok[:, None], ch, 0.0)
        channels.append(ch)
    out = torch.stack(channels, dim=-1)  # (B, S, C)
    return out.reshape(out.shape[0], height, width, len(recipes))


def mdes_fused_batched(
    blocks: EventBlock,  # batched (B, N) leaves
    height: int,
    width: int,
    windows: Tuple[int, ...],
    funcs: Tuple[str, ...],
    aggs: Tuple[str, ...],
    stacking: str = "SBN",
) -> torch.Tensor:
    """(B, H, W, C) float32, all channels from one fused reduction."""
    B, N = blocks.x.shape
    num = blocks.num.to(torch.int32)
    pos = torch.arange(N, dtype=torch.int32, device=blocks.x.device).expand(B, N)

    t = blocks.t.to(torch.float32)  # cast BEFORE t - t0, as the reference
    t0 = t[:, 0]
    t_last = t.gather(1, torch.clamp(num - 1, min=0).to(torch.int64)[:, None])[:, 0]
    span = t_last - t0
    span_ok = span > 0

    plan = _plan(windows, funcs, aggs)
    # per-(sample, window) "has negative events" on the UNSORTED positions
    t_s_unsorted = (t - t0[:, None]) / torch.clamp(span[:, None], min=1.0)
    any_neg = mdes_window_any_neg(blocks.p, pos, num, t_s_unsorted, stacking)

    sums, maxes = mdes_partials(
        blocks.x, blocks.y, t, blocks.p, num, height, width, plan, stacking,
        t0, span, any_neg,
    )
    return mdes_combine(sums, maxes, plan, span_ok, height, width)


def ergo12_fused_batched(blocks: EventBlock, height: int, width: int) -> torch.Tensor:
    return mdes_fused_batched(
        blocks, height, width, tuple(E12_WINDOWS), tuple(E12_FUNCS),
        tuple(E12_AGGS), "SBN",
    )
