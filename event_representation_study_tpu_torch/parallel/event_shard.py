"""Event-axis (sequence-parallel) representation building (the JAX
package's ``parallel/event_shard.py``).

Every representation is a commutative, associative reduction over the
events of each pixel, so the event axis of a window splits over the ranks
of a mesh's ``"event"`` axis: each rank reduces ITS contiguous slice of the
stream on the fused segment reduce (K1 where a table has max columns, K2
where it has sums only), and one collective combines the partials:
``all_reduce(SUM)`` for sums and counts, ``all_reduce(MAX)`` for max
columns (the JAX package's ``psum`` / ``pmax``), ``all_gather`` of each
rank's top-k candidates for TORE. The only other cross-rank values are the
stream's metadata (the first and last timestamps, the MDES windows' "has a
negative event" flags, the time surface's query indices and times), each a
SUM of per-rank contributions that only one rank (or each, for counts)
makes.

The blocks are padded so that the capacity divides by the number of event
shards (:func:`place_event_sharded` checks it); padding sits at the global
tail, so a slice's validity is ``offset + local_index < num`` with
``offset = event_index * n_local``. Each function takes this rank's slice
(B_local, n_local) and returns its rows' full representation, the same on
every rank of the event axis. With a mesh of one rank the collectives do
nothing and the result is the unsharded one.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from ..events.core import EventBlock
from ..ops import scatter
from ..ops.fused_scatter import NEG_INF, fused_segment_reduce
from ..reps.ergo12 import AGGREGATIONS, FUNCTIONS, WINDOW_INDEXES
from ..reps.fused_mdes import _plan, mdes_combine, mdes_partials, mdes_window_any_neg
from ..reps.time_surface import N_SLICES, TAU_DEFAULT, alive_queries
from ..reps.tore import K_DEFAULT, MAX_TIME, MIN_TIME
from .dist import all_gather, all_reduce
from .mesh import Mesh, _to_device

AXIS = "event"


def place_event_sharded(blocks: EventBlock, mesh: Mesh) -> EventBlock:
    """This rank's part of a global (B, N) block on the mesh's device: its
    contiguous column slice over ``"event"`` and, where the mesh has a
    ``"data"`` axis, its rows over it (``num`` split by rows only)."""
    E, e = mesh.size(AXIS), mesh.index(AXIS)
    B, N = blocks.x.shape
    if N % E:
        raise ValueError(f"capacity {N} does not divide by {E} event shards: pad the blocks "
                         f"to a multiple of {E}")
    D, d = ((mesh.size("data"), mesh.index("data")) if "data" in mesh.axis_names else (1, 0))
    if B % D:
        raise ValueError(f"batch {B} does not divide by {D} data shards")
    rows, cols = slice(d * B // D, (d + 1) * B // D), slice(e * N // E, (e + 1) * N // E)

    def part(a):
        a = torch.as_tensor(a)
        return _to_device(a[rows, cols] if a.dim() == 2 else a[rows], mesh.device)

    return EventBlock(*(part(getattr(blocks, f.name)) for f in dataclasses.fields(blocks)))


def _slice_info(blocks: EventBlock, mesh: Mesh):
    """(the block in int32, group, offset, global positions (B, n), valid
    (B, n), num)."""
    blocks = blocks.as_int32()
    e = mesh.index(AXIS)
    B, n = blocks.x.shape
    offset = e * n
    pos = offset + torch.arange(n, dtype=torch.int32, device=blocks.x.device).expand(B, n)
    num = blocks.num.to(torch.int32)
    return blocks, mesh.group(AXIS), offset, pos, pos < num[:, None], num


def _stream_ends(t, num, offset: int, group):
    """The whole stream's (t at position 0, t at position num - 1), each a
    SUM of the one rank's contribution (zeros elsewhere): exact."""
    B, n = t.shape
    tgt = torch.clamp(num - 1, min=0).to(torch.int64)
    has_last = (tgt >= offset) & (tgt < offset + n)
    last = t.gather(1, torch.clamp(tgt - offset, 0, n - 1)[:, None])[:, 0]
    zero = torch.zeros_like(last)
    ends = torch.stack([t[:, 0] if offset == 0 else zero,
                        torch.where(has_last, last, zero)], dim=1)
    all_reduce(ends, group)
    return ends[:, 0], ends[:, 1]


def _pixels(blocks: EventBlock, width: int):
    return blocks.y.to(torch.int32) * width + blocks.x.to(torch.int32)


def sharded_histogram(blocks: EventBlock, height: int, width: int, mesh: Mesh) -> torch.Tensor:
    """Event-sharded ToImage: per-rank counts on K2, one SUM. (B, H, W, 2)."""
    blocks, group, _, _, valid, _ = _slice_info(blocks, mesh)
    B = blocks.x.shape[0]
    S = height * width
    seg = torch.where(valid, _pixels(blocks, width), S).to(torch.int32)

    def columns(pos_s, p_s):
        return torch.stack([(p_s <= 0).to(torch.float32), (p_s > 0).to(torch.float32)],
                           dim=1), None  # sum only: K2

    sums, _ = fused_segment_reduce(seg, (blocks.p.to(torch.int32),), columns, S)
    return all_reduce(sums, group).reshape(B, height, width, 2)


def sharded_voxel_grid(blocks: EventBlock, height: int, width: int, mesh: Mesh,
                       n_time_bins: int = 12) -> torch.Tensor:
    """Event-sharded bilinear voxel grid: the global (t_first, t_last), the
    per-rank bilinear sums on K2, one SUM. (B, H, W, n_time_bins)."""
    blocks, group, offset, _, valid, num = _slice_info(blocks, mesh)
    B = blocks.x.shape[0]
    S = height * width
    t = blocks.t.to(torch.float32)
    t0, t_last = _stream_ends(t, num, offset, group)
    span = torch.clamp(t_last - t0, min=1e-9)

    def columns(pos_s, t_s, p_s):
        ts = n_time_bins * (t_s - t0[:, None]) / span[:, None]
        ti = torch.floor(ts).to(torch.int32)
        dt = ts - ti.to(torch.float32)
        pol = torch.where(p_s > 0, 1.0, -1.0)
        v_valid = offset + pos_s < num[:, None]
        left = pol * (1.0 - dt) * v_valid * (ti < n_time_bins)
        right = pol * dt * v_valid * (ti + 1 < n_time_bins)
        vs = torch.stack([left * (ti == j) + right * (ti == j - 1) for j in range(n_time_bins)],
                         dim=1)
        return vs, None  # sum only: K2

    seg = torch.where(valid, _pixels(blocks, width), S).to(torch.int32)
    sums, _ = fused_segment_reduce(seg, (t, blocks.p.to(torch.int32)), columns, S)
    return all_reduce(sums, group).reshape(B, height, width, n_time_bins)


def sharded_mdes(blocks: EventBlock, height: int, width: int, mesh: Mesh,
                 windows: Tuple[int, ...], funcs: Tuple[str, ...], aggs: Tuple[str, ...],
                 stacking: str = "SBN") -> torch.Tensor:
    """Event-sharded fused MDES / ERGO-12, the hot representation path:
    each rank reduces its slice on K1 (K2 for a table of sums only) with
    window membership judged against GLOBAL positions
    (``mdes_partials(pos_offset=...)``), then one SUM combines the sum
    columns and one MAX the max columns before the channel combination.
    Every MDES aggregation is segment sums (sum, mean, variance moments)
    and segment maxes, so this equals the unsharded result up to the order
    of the float sums. (B, H, W, C)."""
    blocks, group, offset, pos, _, num = _slice_info(blocks, mesh)
    plan = _plan(windows, funcs, aggs)
    t = blocks.t.to(torch.float32)
    t0, t_last = _stream_ends(t, num, offset, group)
    span = t_last - t0
    t_s = (t - t0[:, None]) / torch.clamp(span[:, None], min=1.0)
    any_neg = mdes_window_any_neg(blocks.p, pos, num, t_s, stacking).to(torch.int32)
    any_neg = all_reduce(any_neg, group) > 0
    sums, maxes = mdes_partials(blocks.x, blocks.y, t, blocks.p, num, height, width, plan,
                                stacking, t0, span, any_neg, pos_offset=offset)
    all_reduce(sums, group)
    if maxes is not None:
        all_reduce(maxes, group, "max")  # empty stays NEG_INF until the combine
    return mdes_combine(sums, maxes, plan, span > 0, height, width)


def sharded_ergo12(blocks: EventBlock, height: int, width: int, mesh: Mesh) -> torch.Tensor:
    return sharded_mdes(blocks, height, width, mesh, tuple(WINDOW_INDEXES), tuple(FUNCTIONS),
                        tuple(AGGREGATIONS), "SBN")


def sharded_tore(blocks: EventBlock, height: int, width: int, mesh: Mesh,
                 k: int = K_DEFAULT) -> torch.Tensor:
    """Event-sharded TORE: each rank's k most recent qualifying timestamps
    per (pixel, polarity), then a merge across ranks (an all_gather of the
    k-candidate lists and a top-k of the ranks x k): exact, since a rank's
    survivors are the only global survivors it can hold. The slots hold the
    values in descending time, as the unsharded ``reps/tore.py``. (B, H, W,
    2k)."""
    blocks, group, offset, _, valid, num = _slice_info(blocks, mesh)
    B, n = blocks.x.shape
    hw = height * width
    # the sample time, t at global position num - 1, in the integer stream
    tgt = torch.clamp(num - 1, min=0).to(torch.int64)
    has_last = (tgt >= offset) & (tgt < offset + n)
    t_last = blocks.t.gather(1, torch.clamp(tgt - offset, 0, n - 1)[:, None])
    t_last = all_reduce(torch.where(has_last[:, None], t_last, 0), group)
    qualifies = valid & (blocks.t < t_last)  # strict (tore.py:17)
    pix = scatter.flat_pixel_index(blocks.x, blocks.y, width)
    seg = torch.where(blocks.p > 0, pix, hw + pix)
    rows = torch.arange(B, dtype=torch.int32, device=seg.device)[:, None]
    tvals = scatter.segment_topk_recent_values(
        blocks.index().reshape(-1), (seg + rows * 2 * hw).reshape(-1), qualifies.reshape(-1),
        blocks.t.reshape(-1), B * 2 * hw, k, fill=-float("inf"),
    ).reshape(B, 2 * hw, k)
    merged = torch.cat(all_gather(tvals, group), dim=-1)
    tvals = torch.topk(merged, k, dim=-1).values.reshape(B, 2 * hw * k)
    dts = torch.clamp(t_last.to(torch.float32) - tvals, max=MAX_TIME)
    vals = torch.clamp(torch.log(dts + 1.0) - math.log(MIN_TIME + 1.0), min=0.0)
    vals = vals.reshape(B, 2, height, width, k)
    return torch.cat([vals[:, 0], vals[:, 1]], dim=-1)


def sharded_time_surface(blocks: EventBlock, height: int, width: int, mesh: Mesh,
                         tau: float = TAU_DEFAULT, n_slices: int = N_SLICES) -> torch.Tensor:
    """Event-sharded ToTimesurface: the last event time at or before each
    query index, per (pixel, polarity), is a segment MAX, so each rank
    reduces its slice on K1 (masks judged against GLOBAL positions) and one
    MAX combines them before the decay. The global query indices
    (``searchsorted`` of the normalised times) are SUMs of per-rank
    strict-less counts, and each query's time comes from the rank that
    holds its (clamped) index. (B, H, W, 2 * n_slices)."""
    blocks, group, offset, _, valid, num = _slice_info(blocks, mesh)
    B, n = blocks.x.shape
    hw = height * width
    S2 = 2 * hw
    t = blocks.t.to(torch.float32)
    t0, t_last = _stream_ends(t, num, offset, group)
    span = torch.clamp(t_last - t0, min=1e-30)
    t_norm = (t - t0[:, None]) / span[:, None] * n_slices
    t_norm = torch.where(valid, t_norm, float(n_slices + 1))
    targets = torch.arange(1, n_slices + 1, dtype=torch.float32, device=t.device)
    q_idx = (t_norm[:, :, None] < targets).sum(dim=1).to(torch.int32)
    q_idx = all_reduce(q_idx, group)  # (B, n_slices)
    # t at the query index, clamped into the block as the unsharded version
    qc = torch.clamp(q_idx, max=n * mesh.size(AXIS) - 1).to(torch.int64)
    own = (qc >= offset) & (qc < offset + n)
    t_q = t.gather(1, torch.clamp(qc - offset, 0, n - 1))
    t_q = all_reduce(torch.where(own, t_q, 0.0), group)
    alive = alive_queries(q_idx)
    pol = (blocks.p > 0).to(torch.int32)
    seg = torch.where(valid, pol * hw + _pixels(blocks, width), S2).to(torch.int32)

    def columns(pos_s, t_s):
        gpos = offset + pos_s
        v_valid = gpos < num[:, None]
        vm = torch.stack([torch.where(v_valid & (gpos <= q_idx[:, q, None]), t_s, NEG_INF)
                          for q in range(n_slices)], dim=1)
        return torch.zeros((B, 1, n), device=t_s.device), vm

    _, maxes = fused_segment_reduce(seg, (t,), columns, S2)  # (B, 2*H*W, n_slices)
    all_reduce(maxes, group, "max")
    mem = torch.where(maxes <= NEG_INF / 2, -(3.0 * tau + 1.0), maxes)
    surf = torch.exp((mem - t_q[:, None, :]) / tau)
    surf = torch.where(alive[:, None, :], surf, 0.0)
    surf = surf.reshape(B, 2, height, width, n_slices).permute(0, 2, 3, 4, 1)
    return surf.reshape(B, height, width, n_slices * 2)
