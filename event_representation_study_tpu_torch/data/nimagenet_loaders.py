"""The original N-ImageNet aggregation functions ("loader types") — NumPy
twins of n_imagenet/real_cnn_model/data/imagenet.py:169-1000 (the ~19
pre-study representations: accumulate/time/count/flat/exp/intensity/sort
families including DiST ``reshape_then_acc_adj_sort`` :873-1000).

All functions take an (N, 4) float event tensor with columns [x, y, t, p]
(p in {-1, +1}, x/y already reshaped to the 224x224 frame) and return
(H, W, C) float32 — channel-LAST for this framework's NHWC pipeline (the
reference permutes to CHW at the end; same values).

Constants follow the reference: EXP_TAU 0.3, TIME_SCALE 1e6,
CLIP_COUNT_RATE 0.99, DISC_ALPHA 3.0 (imagenet.py:18-25).

These are host-side (they exist for capability parity and as golden
references); the study's six representations run fused on device via
data/nimagenet.py LOADER_TO_REP. A copy of the JAX package's
``data/nimagenet_loaders.py`` (NumPy only).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

IMAGE_H, IMAGE_W = 224, 224
EXP_TAU = 0.3
TIME_SCALE = 1_000_000
CLIP_COUNT_RATE = 0.99
DISC_ALPHA = 3.0


def _split(ev):
    return ev[ev[:, 3] > 0], ev[ev[:, 3] < 0]


def _count(sub, H, W):
    idx = sub[:, 0].astype(np.int64) + sub[:, 1].astype(np.int64) * W
    return np.bincount(idx, minlength=H * W).reshape(H, W).astype(np.float64)


def _scatter_max(vals, sub, H, W, fill=0.0):
    idx = sub[:, 0].astype(np.int64) + sub[:, 1].astype(np.int64) * W
    out = np.full(H * W, -np.inf)
    np.maximum.at(out, idx, vals)
    out[np.isinf(out)] = fill
    return out.reshape(H, W)


def _scatter_min(vals, sub, H, W, fill=0.0):
    idx = sub[:, 0].astype(np.int64) + sub[:, 1].astype(np.int64) * W
    out = np.full(H * W, np.inf)
    np.minimum.at(out, idx, vals)
    out[np.isinf(out)] = fill
    return out.reshape(H, W)


def _times(ev, pos, neg):
    t0 = ev[0, 2]
    span = ev[-1, 2] - ev[0, 2]
    span = span if span != 0 else 1.0
    return (pos[:, 2] - t0) / span, (neg[:, 2] - t0) / span


def reshape_then_acc(ev, H=IMAGE_H, W=IMAGE_W):
    """4ch: max-normalized pos/neg counts + last-event times (:169-210)."""
    pos, neg = _split(ev)
    tp, tn = _times(ev, pos, neg)
    pc = _count(pos, H, W)
    nc = _count(neg, H, W)
    pc = pc / max(pc.max(), 1e-12)
    nc = nc / max(nc.max(), 1e-12)
    return np.stack(
        [pc, _scatter_max(tp, pos, H, W), nc, _scatter_max(tn, neg, H, W)], -1
    ).astype(np.float32)


def reshape_then_acc_time(ev, H=IMAGE_H, W=IMAGE_W):
    """4ch: first/last normalized times per polarity (:213-248)."""
    pos, neg = _split(ev)
    tp, tn = _times(ev, pos, neg)
    return np.stack(
        [
            _scatter_min(tp, pos, H, W),
            _scatter_max(tp, pos, H, W),
            _scatter_min(tn, neg, H, W),
            _scatter_max(tn, neg, H, W),
        ],
        -1,
    ).astype(np.float32)


def reshape_then_acc_count(ev, H=IMAGE_H, W=IMAGE_W):
    """4ch: raw pos/neg counts + last times (:250-293)."""
    if len(ev) == 0:  # the reference's empty-sample fallback (:259-262)
        ev = np.zeros((10, 4))
        ev[:, 2] = np.arange(10) / 10.0
        ev[:, 3] = 1
    pos, neg = _split(ev)
    tp, tn = _times(ev, pos, neg)
    return np.stack(
        [
            _count(pos, H, W), _scatter_max(tp, pos, H, W),
            _count(neg, H, W), _scatter_max(tn, neg, H, W),
        ],
        -1,
    ).astype(np.float32)


def reshape_then_acc_count_pol(ev, H=IMAGE_H, W=IMAGE_W):
    """2ch raw counts (:296-321)."""
    pos, neg = _split(ev)
    return np.stack([_count(pos, H, W), _count(neg, H, W)], -1).astype(np.float32)


def reshape_then_acc_count_only(ev, H=IMAGE_H, W=IMAGE_W):
    """1ch total count (:324-343)."""
    return _count(ev, H, W)[..., None].astype(np.float32)


def reshape_then_acc_all(ev, H=IMAGE_H, W=IMAGE_W):
    """6ch: counts + max/min times (:346-394)."""
    if len(ev) == 0:
        return np.zeros((H, W, 6), np.float32)
    pos, neg = _split(ev)
    tp, tn = _times(ev, pos, neg)
    return np.stack(
        [
            _count(pos, H, W), _count(neg, H, W),
            _scatter_max(tp, pos, H, W), _scatter_max(tn, neg, H, W),
            _scatter_min(tp, pos, H, W), _scatter_min(tn, neg, H, W),
        ],
        -1,
    ).astype(np.float32)


def reshape_then_flat(ev, H=IMAGE_H, W=IMAGE_W):
    """1ch binary event image (:397-413)."""
    img = np.zeros((H, W))
    img[ev[:, 1].astype(np.int64), ev[:, 0].astype(np.int64)] = 1.0
    return img[..., None].astype(np.float32)


def reshape_then_flat_pol(ev, H=IMAGE_H, W=IMAGE_W):
    """2ch binary per polarity (:416-438)."""
    pos, neg = _split(ev)
    out = np.zeros((H, W, 2))
    out[pos[:, 1].astype(np.int64), pos[:, 0].astype(np.int64), 0] = 1.0
    out[neg[:, 1].astype(np.int64), neg[:, 0].astype(np.int64), 1] = 1.0
    return out.astype(np.float32)


def reshape_then_acc_exp(ev, H=IMAGE_H, W=IMAGE_W):
    """2ch exponential-decay time surfaces (:441-472)."""
    pos, neg = _split(ev)
    tp, tn = _times(ev, pos, neg)
    p = np.exp(-(1 - _scatter_max(tp, pos, H, W)) / EXP_TAU)
    n = np.exp(-(1 - _scatter_max(tn, neg, H, W)) / EXP_TAU)
    return np.stack([p, n], -1).astype(np.float32)


def reshape_then_acc_time_pol(ev, H=IMAGE_H, W=IMAGE_W):
    """2ch last-time per polarity (:475-510)."""
    if len(ev) == 0:
        ev = np.zeros((10, 4))
        ev[:, 2] = np.arange(10) / 10.0
        ev[:, 3] = 1
    pos, neg = _split(ev)
    tp, tn = _times(ev, pos, neg)
    return np.stack(
        [_scatter_max(tp, pos, H, W), _scatter_max(tn, neg, H, W)], -1
    ).astype(np.float32)


def reshape_then_acc_intensity(ev, H=IMAGE_H, W=IMAGE_W):
    """1ch min-max-normalized count difference (:841-870)."""
    pos, neg = _split(ev)
    inten = _count(pos, H, W) - _count(neg, H, W)
    lo, hi = inten.min(), inten.max()
    inten = (inten - lo) / max(hi - lo, 1e-12)
    return inten[..., None].astype(np.float32)


def _rank_times(t):
    """Consecutive-equal rank conversion (:521-525): quantize the (sorted)
    timestamps to microseconds, then replace each group of equal stamps with
    its 0-based group index."""
    q = np.floor(t * TIME_SCALE).astype(np.int64)
    change = np.concatenate([[True], q[1:] != q[:-1]])
    return (np.cumsum(change) - 1).astype(np.float64)


def _strict_sort_image(sub, H, W):
    """The 'strict' rank image (:560-593): keep the per-pixel LAST event,
    rank the survivors by time (ties share a rank, +1 then min-max), place
    ranks at their pixels."""
    idx = sub[:, 0].astype(np.int64) + sub[:, 1].astype(np.int64) * W
    last = {}
    for i in range(len(sub)):  # last write wins == scatter_max over time
        last[int(idx[i])] = i
    keep = np.array(sorted(last.values()), int)
    tmp = sub[keep]
    order = np.argsort(tmp[:, 2], kind="stable")
    tmp = tmp[order]
    _, counts = np.unique(tmp[:, 2], return_counts=True)
    ranks = np.repeat(np.arange(len(counts), dtype=float), counts) + 1.0
    if ranks.size and ranks.max() != ranks.min():
        ranks = (ranks - ranks.min()) / (ranks.max() - ranks.min())
    else:
        ranks = np.zeros_like(ranks)
    img = np.zeros((H, W))
    img[tmp[:, 1].astype(np.int64), tmp[:, 0].astype(np.int64)] = ranks
    return img


def _quantize(img, quantize_sort):
    if quantize_sort is None:
        return [img]
    if isinstance(quantize_sort, int):
        return [np.round(img * quantize_sort) / quantize_sort]
    return [np.round(img * q) / q for q in quantize_sort]


def reshape_then_acc_sort(ev, H=IMAGE_H, W=IMAGE_W, use_image: bool = False,
                          neglect_polarity: bool = False, strict: bool = False,
                          quantize_sort=None, global_time: bool = True):
    """Sorted-time baseline (:513-838) with the reference's kwargs and exact
    semantics (kwarg defaults follow the dataset call, imagenet.py:1288-1298):

    * times are first rewritten in place — to 0-based consecutive-equal
      global ranks when ``global_time`` (:521-525), else to raw microsecond
      stamps (:527-537 — the per-polarity ranks computed there are dead
      code, never used);
    * ``strict`` keeps each pixel's max-time event, re-ranks the survivors
      (+1, then min-max) into a rigorous sorted image (:560-593);
    * non-strict places the raw per-pixel max times: the reference computes
      a hot-pixel min-max normalization into a temporary and never writes
      it back (:597-607, :754-775), so the returned image is UNNORMALIZED —
      reproduced faithfully;
    * ``quantize_sort`` rounds the sort image to 1/q grids (int or list);
    * ``use_image`` interleaves binary event images per the reference's
      channel order [pos_img, pos_sort, neg_img, neg_sort] (:815-829).

    The reference's denoise_image/denoise_sort flags call
    ``density_filter_event_image``, which is never defined anywhere in the
    reference (a latent NameError) — they are intentionally not reproduced."""
    ev = np.asarray(ev, np.float64).copy()
    ev[:, 2] = _rank_times(ev[:, 2]) if global_time else np.floor(
        ev[:, 2] * TIME_SCALE)
    if neglect_polarity:
        sort_img = (
            _strict_sort_image(ev, H, W)
            if strict
            else _scatter_max(ev[:, 2], ev, H, W)
        )
        chans = []
        if use_image:
            img = np.zeros((H, W))
            img[ev[:, 1].astype(np.int64), ev[:, 0].astype(np.int64)] = 1.0
            chans.append(img)
        chans.extend(_quantize(sort_img, quantize_sort))
        return np.stack(chans, -1).astype(np.float32)

    pos, neg = _split(ev)
    if len(pos) == 0:
        pos = np.zeros((1, 4)); pos[:, 3] = 1
    if len(neg) == 0:
        neg = np.zeros((1, 4)); neg[:, 3] = 1
    if strict:
        pos_sort = _strict_sort_image(pos, H, W)
        neg_sort = _strict_sort_image(neg, H, W)
    else:
        pos_sort = _scatter_max(pos[:, 2], pos, H, W)
        neg_sort = _scatter_max(neg[:, 2], neg, H, W)
    chans = []
    if use_image:
        pi = np.zeros((H, W)); ni = np.zeros((H, W))
        pi[pos[:, 1].astype(np.int64), pos[:, 0].astype(np.int64)] = 1.0
        ni[neg[:, 1].astype(np.int64), neg[:, 0].astype(np.int64)] = 1.0
        chans.append(pi)
        chans.extend(_quantize(pos_sort, quantize_sort))
        chans.append(ni)
        chans.extend(_quantize(neg_sort, quantize_sort))
    else:
        chans.extend(_quantize(pos_sort, quantize_sort))
        chans.extend(_quantize(neg_sort, quantize_sort))
    return np.stack(chans, -1).astype(np.float32)


def _clip_count(count, H, W):
    """DiST's rank-based count clipping (:898-907): threshold at the rank
    where the cumulative pixel mass crosses CLIP_COUNT_RATE."""
    _, cnts = np.unique(count, return_counts=True)
    csum = np.cumsum(cnts)
    th = (csum < H * W * CLIP_COUNT_RATE).sum()
    return np.minimum(count, th)


def _pool_sum32(img, k):
    """Window sum in float32 (avg_pool2d * k^2, count_include_pad padding).
    Applied only to integer-valued counts, where float32 sums are exact."""
    p = k // 2
    pad = np.pad(img.astype(np.float32), p, constant_values=np.float32(0))
    win = np.lib.stride_tricks.sliding_window_view(pad, (k, k))
    return win.sum(axis=(2, 3), dtype=np.float32)


def _pool_max32(img, k):
    """max_pool2d with -inf padding, float32."""
    p = k // 2
    pad = np.pad(img.astype(np.float32), p,
                 constant_values=np.float32(-np.inf))
    win = np.lib.stride_tricks.sliding_window_view(pad, (k, k))
    return win.max(axis=(2, 3))


def _rank_normalize(flat):
    """Sorted-rank normalization (:973-990): equal values share a rank;
    float32 division like the reference's ``.float() / unq.shape[0]``."""
    order = np.argsort(flat, kind="stable")
    vals = flat[order]
    _, counts = np.unique(vals, return_counts=True)
    ranks = np.repeat(np.arange(len(counts), dtype=np.float32), counts)
    out = np.zeros_like(flat, dtype=np.float32)
    out[order] = ranks / np.float32(max(len(counts), 1))
    return out


def reshape_then_acc_adj_sort(ev, H=IMAGE_H, W=IMAGE_W):
    """DiST (:873-1000): clipped counts, temporal discounting by the 5x5
    neighborhood (max-pooled extremal times over average-pooled counts),
    then per-polarity sorted-rank images. 2 channels.

    Arithmetic follows the reference's float32 op order exactly (counts and
    scatter images are ``.float()``-cast before pooling there) — the rank
    normalization's tie structure is precision-sensitive, so float64 math
    here would produce systematically different rank images."""
    pos, neg = _split(ev)
    pc = _clip_count(_count(pos, H, W), H, W).astype(np.float32)
    nc = _clip_count(_count(neg, H, W), H, W).astype(np.float32)
    tp, tn = _times(ev, pos, neg)
    pos_out = _scatter_max(tp, pos, H, W).astype(np.float32)
    pos_min = _scatter_min(tp, pos, H, W).astype(np.float32)
    neg_out = _scatter_max(tn, neg, H, W).astype(np.float32)
    neg_min = _scatter_min(tn, neg, H, W).astype(np.float32)
    pos_min[pc == 0] = 1.0
    neg_min[nc == 0] = 1.0

    k = 5
    kk = np.float32(k * k)
    # k^2 * avg_pool: replicate the reference's double rounding (/25 then *25)
    pn = kk * (_pool_sum32(pc, k) / kk)
    nn_ = kk * (_pool_sum32(nc, k) / kk)
    with np.errstate(divide="ignore", invalid="ignore"):
        pos_disc = (_pool_max32(pos_out, k) + _pool_max32(-pos_min, k)) / pn
        neg_disc = (_pool_max32(neg_out, k) + _pool_max32(-neg_min, k)) / nn_

    m = pc > 0
    pos_out[m] = pos_out[m] - np.float32(DISC_ALPHA) * pos_disc[m]
    pos_out[pos_out < 0] = 0
    pos_out[pn == 1.0] = 0
    m = nc > 0
    neg_out[m] = neg_out[m] - np.float32(DISC_ALPHA) * neg_disc[m]
    neg_out[neg_out < 0] = 0
    neg_out[nn_ == 1.0] = 0

    pos_sort = _rank_normalize(pos_out.reshape(-1)).reshape(H, W)
    neg_sort = _rank_normalize(neg_out.reshape(-1)).reshape(H, W)
    return np.stack([pos_sort, neg_sort], -1).astype(np.float32)


def reshape_event_unique(ev, orig_h, orig_w, new_h, new_w):
    """Deduplicating reshape (:111-126): rescale, then keep the first event
    per (x, y, quantized-t) key."""
    out = ev.astype(np.float64).copy()
    out[:, 0] *= new_w / orig_w
    out[:, 1] *= new_h / orig_h
    coords = out[:, :2].astype(np.int64)
    ts = (out[:, 2] * TIME_SCALE).astype(np.int64)
    ts -= ts[0]
    key = coords[:, 0] + coords[:, 1] * new_w + ts * new_h * new_w
    _, uniq = np.unique(key, return_index=True)
    return out[uniq]


HOST_LOADERS: Dict[str, callable] = {
    "reshape_then_acc": reshape_then_acc,
    "reshape_then_acc_time": reshape_then_acc_time,
    "reshape_then_acc_count": reshape_then_acc_count,
    "reshape_then_acc_count_pol": reshape_then_acc_count_pol,
    "reshape_then_acc_count_only": reshape_then_acc_count_only,
    "reshape_then_acc_all": reshape_then_acc_all,
    "reshape_then_flat": reshape_then_flat,
    "reshape_then_flat_pol": reshape_then_flat_pol,
    "reshape_then_acc_exp": reshape_then_acc_exp,
    "reshape_then_acc_time_pol": reshape_then_acc_time_pol,
    "reshape_then_acc_intensity": reshape_then_acc_intensity,
    "reshape_then_acc_sort": reshape_then_acc_sort,
    "reshape_then_acc_adj_sort": reshape_then_acc_adj_sort,
}

LOADER_CHANNELS: Dict[str, int] = {
    "reshape_then_acc": 4,
    "reshape_then_acc_time": 4,
    "reshape_then_acc_count": 4,
    "reshape_then_acc_count_pol": 2,
    "reshape_then_acc_count_only": 1,
    "reshape_then_acc_all": 6,
    "reshape_then_flat": 1,
    "reshape_then_flat_pol": 2,
    "reshape_then_acc_exp": 2,
    "reshape_then_acc_time_pol": 2,
    "reshape_then_acc_intensity": 1,
    "reshape_then_acc_sort": 2,
    "reshape_then_acc_adj_sort": 2,
}
