"""Mosaic / affine / flip / mixup executed in EVENT space (the JAX package's
``reps/event_mosaic.py``): the strong-augment recipe straight from raw
event blocks to the augmented representation at the model's resolution.

The reference composes augmentation on rasterized images: paste four images
onto a 2S x 2S canvas, warp the canvas, flip, then mixup-blend
(ev-YOLOv6/yolov6/data/data_augment.py:153-268, datasets.py __getitem__);
``ops/warp.py`` does the same on the device. Events are points, so here the
whole pipeline becomes per-event coordinate math plus ONE fused
segment-reduce (kernel K1 on a CUDA tensor) at the output resolution:

1. per tile: sensor px -> letterboxed s-frame (r, dw, dh) -> canvas px
   (+ tile offset); events outside their tile's canvas box are cropped (the
   paste), then canvas -> output px through the forward affine
   (``plan.fwd_affine``, flips folded), rounded to the nearest pixel;
2. the representation's value columns are computed per event against its
   OWN source stream (window membership by own-stream position and time);
3. one fused segment-reduce over the concatenated (B, 4E) stream builds the
   output-resolution image directly: no canvas, no pixel gather;
4. uncovered and letterbox-pad output pixels take the 114 background
   through the image executor's own routing (``ops/warp.py``
   ``route_output_pixels``);
5. mixup blends two composed outputs (data_augment.py:87-93).

Transformed event coordinates are rounded to the nearest output pixel
(point rasterization) where the image path resamples bilinearly. With an
identity affine and a ratio-1 letterbox the two agree exactly.

Supported representations: the MDES family (MixedDensityEventStack*,
ERGO-12 / OptimizedRepresentation) and EventHistogram/ToImage, whose
per-event values depend only on own-stream position, time and polarity.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..events.core import EventBlock
from ..ops.fused_scatter import NEG_INF, fused_segment_reduce
from ..ops.image import PAD_VALUE, letterbox_geometry
from ..ops.warp import AugPlan, route_output_pixels
from .ergo12 import AGGREGATIONS as E12_AGGS
from .ergo12 import FUNCTIONS as E12_FUNCS
from .ergo12 import WINDOW_INDEXES as E12_WINDOWS
from .fused_mdes import _plan, _window_mask, mdes_combine, mdes_window_any_neg

#: representation name -> (windows, funcs, aggs, stacking) channel table
MOSAIC_MDES_TABLES = {
    "ERGO12": (tuple(E12_WINDOWS), tuple(E12_FUNCS), tuple(E12_AGGS), "SBN"),
    "OptimizedRepresentation": (
        tuple(E12_WINDOWS), tuple(E12_FUNCS), tuple(E12_AGGS), "SBN",
    ),
    # histogram = [neg count, pos count] in MDES vocabulary (window 0 = all)
    "EventHistogram": ((0, 0), ("count_neg", "count_pos"), ("sum", "sum"), "SBN"),
    "ToImage": ((0, 0), ("count_neg", "count_pos"), ("sum", "sum"), "SBN"),
}


def supports_event_mosaic(name: str) -> bool:
    return (
        name in MOSAIC_MDES_TABLES
        or "MixedDensityEventStack" in name
        or "ToImage" in name
    )


def _table_for(name: str):
    if name in MOSAIC_MDES_TABLES:
        return MOSAIC_MDES_TABLES[name]
    if "MixedDensityEventStack" in name:  # the 12-channel ERGO table
        return MOSAIC_MDES_TABLES["ERGO12"]
    if "ToImage" in name:
        return MOSAIC_MDES_TABLES["ToImage"]
    raise ValueError(
        f"aug_mode='event' supports the MDES/ERGO-12/histogram family, "
        f"not {name!r}; use aug_mode='image'"
    )


def _mdes_columns_mosaic(plan, num4, t04, span4, any_neg4, stacking, E):
    """``columns_fn`` for the concatenated (B, 4E) mosaic stream: per-event
    metadata (own-stream position, count and time base, per-window neg
    flags) is recovered from the tile-major layout (tile = pos // E), then
    the same column math as ``fused_mdes._mdes_columns``. ``num4``, ``t04``,
    ``span4`` are (B, 4) per tile, ``any_neg4`` (B, 4, n_windows)."""
    sum_cols, max_cols, _ = plan

    def value(f, t_s, p):
        if f.startswith("timestamp"):
            return t_s
        if f == "polarity":
            return p.to(torch.float32)
        return torch.ones_like(t_s)

    def columns_fn(pos_s, t_sorted, p_sorted):
        k_id = torch.div(pos_s, E, rounding_mode="floor").to(torch.int64)
        own_pos = pos_s - k_id.to(pos_s.dtype) * E
        num_e = num4.gather(1, k_id)
        t_s = (t_sorted - t04.gather(1, k_id)) / torch.clamp(span4.gather(1, k_id), min=1.0)
        p_i = p_sorted.to(torch.int32)
        wmasks = {}

        def wm(w):
            if w not in wmasks:
                wmasks[w] = _window_mask(w, own_pos, num_e, t_s, stacking)
            return wmasks[w]

        def selector(f, w, wmask):
            if f in ("timestamp_pos", "count_pos"):
                return wmask & (p_i == 1)
            if f in ("timestamp_neg", "count_neg"):
                neg_flag = any_neg4[:, :, w].gather(1, k_id)
                return wmask & torch.where(neg_flag, p_i == -1, p_i == 0)
            return wmask

        vs = []
        for kind, f, w in sum_cols:
            m = selector(f, w, wm(w)).to(torch.float32)
            if kind == "cnt":
                vs.append(m)
            elif kind == "val":
                vs.append(value(f, t_s, p_i) * m)
            else:  # sq
                v = value(f, t_s, p_i)
                vs.append(v * v * m)
        vm = []
        for f, w in max_cols:
            m = selector(f, w, wm(w))
            vm.append(torch.where(m, value(f, t_s, p_i), NEG_INF))
        if not vm:
            return torch.stack(vs, dim=1), None
        return torch.stack(vs, dim=1), torch.stack(vm, dim=1)

    return columns_fn


def _background_mask(plan: AugPlan, out_size: int, content_lo, content_hi):
    """(B, S, S) bool: the output pixel maps into some tile AND into its
    source's letterbox content region (elsewhere 114, as the image executor
    samples uncovered and pad pixels)."""
    sx, sy, _, covered = route_output_pixels(plan, out_size)
    (x_lo, y_lo), (x_hi, y_hi) = content_lo, content_hi
    content = (sx >= x_lo) & (sx < x_hi) & (sy >= y_lo) & (sy < y_hi)
    return covered & content


def mosaic_event_rep(
    blocks: EventBlock,  # (P, E) leaves: the batch rows + a partner pool
    plan: AugPlan,  # B <= P plan rows, with fwd_affine
    representation: str,
    sensor_hw: Tuple[int, int],
    out_size: int,
) -> torch.Tensor:
    """Strong-augmented (B, out_size, out_size, C) images on the 0..255
    scale, straight from raw event blocks: the event-space equivalent of
    ``letterbox(rep(events))`` + ``compose_warp``. One segment-reduce launch
    for the whole batch."""
    if plan.fwd_affine is None:
        raise ValueError("plan has no fwd_affine; re-plan with data/augment.py "
                         "plan_augment_batch")
    windows, funcs, aggs, stacking = _table_for(representation)
    blocks = blocks.as_int32()
    H0, W0 = sensor_hw
    s = out_size
    P, E = blocks.x.shape
    dev = blocks.x.device
    idx = plan.src_idx.to(torch.int64)  # (B, 4)
    B = idx.shape[0]

    # ---- per-SOURCE stream metadata (own-window semantics) ----
    num = blocks.num
    t = blocks.t.to(torch.float32)
    t0 = t[:, 0]
    t_last = t.gather(1, torch.clamp(num - 1, min=0).to(torch.int64)[:, None])[:, 0]
    span = t_last - t0
    pos_src = torch.arange(E, dtype=torch.int32, device=dev).expand(P, E)
    t_s_src = (t - t0[:, None]) / torch.clamp(span[:, None], min=1.0)
    col_plan = _plan(windows, funcs, aggs)
    any_neg = mdes_window_any_neg(blocks.p, pos_src, num, t_s_src, stacking)

    # ---- geometry: sensor -> letterbox -> canvas (crop) -> output ----
    r, (nh, nw), (dw, dh) = letterbox_geometry(H0, W0, s)
    x4 = blocks.x[idx].to(torch.float32)  # (B, 4, E)
    y4 = blocks.y[idx].to(torch.float32)
    u_lb = x4 * r + dw
    v_lb = y4 * r + dh
    cx = u_lb + plan.tile_offsets[:, :, 0, None]
    cy = v_lb + plan.tile_offsets[:, :, 1, None]
    tb = plan.tile_boxes[:, :, :, None]  # (B, 4, 4, 1)
    # each tile's events are tested against that tile's own canvas box;
    # boxes are disjoint (mosaic) or empty beyond tile 0 (non-mosaic rows),
    # so no event is counted twice
    inside = ((cx >= tb[:, :, 0]) & (cx < tb[:, :, 2])
              & (cy >= tb[:, :, 1]) & (cy < tb[:, :, 3]))
    G = plan.fwd_affine[:, :, :, None, None]  # (B, 2, 3, 1, 1)
    u = G[:, 0, 0] * cx + G[:, 0, 1] * cy + G[:, 0, 2]
    v = G[:, 1, 0] * cx + G[:, 1, 1] * cy + G[:, 1, 2]
    ui = torch.round(u).to(torch.int32)  # half to even, as jnp.round
    vi = torch.round(v).to(torch.int32)

    num4 = num[idx]  # (B, 4)
    span4 = span[idx]
    own_pos = torch.arange(E, dtype=torch.int32, device=dev).expand(B, 4, E)
    valid = (
        inside
        & (ui >= 0) & (ui < s) & (vi >= 0) & (vi < s)
        & (own_pos < num4[:, :, None])
        # a zero-span source renders as an all-zero tile in the plain rep
        # (mdes_combine's span_ok), which is contributing no events here
        & (span4[:, :, None] > 0)
    )
    S = s * s
    seg = torch.where(valid, vi * s + ui, S).reshape(B, 4 * E)
    t_r = t[idx].reshape(B, 4 * E)
    p_r = blocks.p[idx].to(torch.float32).reshape(B, 4 * E)

    columns_fn = _mdes_columns_mosaic(col_plan, num4, t0[idx], span4, any_neg[idx],
                                      stacking, E)
    sums, maxes = fused_segment_reduce(seg, (t_r, p_r), columns_fn, S)
    rep = mdes_combine(sums, maxes, col_plan, torch.ones((B,), dtype=torch.bool, device=dev),
                       s, s)  # (B, s, s, C)

    # ---- background + mixup (0..255 scale like the image path) ----
    content = _background_mask(plan, s, (dw, dh), (dw + nw, dh + nh))
    out = torch.where(content[..., None], rep * 255.0, PAD_VALUE)
    mr = plan.mix_r[:, None, None, None]
    return mr * out + (1.0 - mr) * out[plan.mix_idx.to(torch.int64)]
