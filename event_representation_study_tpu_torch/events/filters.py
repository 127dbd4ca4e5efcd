"""Event-stream filters (a copy of the JAX package's ``events/filters.py``) —
the equivalents of ev-licious
``tools/filters.py``, vectorized NumPy (the reference wraps numba/torch
helpers; these are pure array ops with the same stream semantics):

- HotPixel: calibrate a per-pixel count mask; drop pixels whose count
  exceeds ``threshold`` of the max, only when hot pixels are separated from
  the bulk by a 2x count gap (filters.py:23-53).
- BackgroundActivity: keep an event only if some pixel in its (2r+1)^2
  neighborhood fired within ``depth_us`` before it (:56-67).
- Random: uniform 1/k downsampling (:70-77).
- ContrastThresholdIncrease: keep every k-th same-polarity event per pixel
  (:80-94).
- RefractoryPeriod: drop events within ``depth_us`` of the previous event at
  the same pixel (:97-107).
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def hot_pixel_filter(ev: np.ndarray, height: int, width: int, threshold: float = 0.6):
    count = np.zeros((height, width))
    np.add.at(count, (ev["y"], ev["x"]), 1.0)
    mask2d = count / max(count.max(), 1) < threshold
    hot = ~mask2d
    if hot.any() and mask2d.any():
        min_hot = count[hot].min()
        max_ok = count[mask2d].max()
        if min_hot / max(max_ok, 1e-9) <= 2:
            return ev  # no clear separation -> keep everything
    else:
        return ev
    keep = mask2d[ev["y"], ev["x"]]
    return ev[keep]


def background_activity_filter(ev, height: int, width: int, depth_us: int, radius: int = 1):
    """BackgroundActivity (tools/filters.py:57-68 + utils.py:171-179,
    verbatim): every event splashes its timestamp onto the HALF-OPEN
    neighborhood box [y-r, y+r) x [x-r, x+r) (the reference's slice
    excludes the bottom/right edge and clips only at 0); an event is
    dropped when its own pixel's stamp is POSITIVE and older than
    ``depth_us`` — untouched pixels (stamp -inf) are kept."""
    ts = np.full((height, width), -np.inf)
    keep = np.ones(len(ev), bool)
    x, y, t = ev["x"], ev["y"], ev["t"]
    for i in range(len(ev)):
        t_last = ts[y[i], x[i]]
        keep[i] = not (t_last > 0 and t[i] - t_last > depth_us)
        ts[max(y[i] - radius, 0): y[i] + radius,
           max(x[i] - radius, 0): x[i] + radius] = t[i]
    return ev[keep]


def random_filter(ev, downsampling_factor: int, rng: Optional[np.random.Generator] = None):
    rng = rng or np.random.default_rng()
    n = len(ev) // downsampling_factor
    idx = np.sort(rng.choice(len(ev), n, replace=False))
    return ev[idx]


def contrast_threshold_filter(ev, height: int, width: int, multiplier: int):
    """ContrastThresholdIncrease (tools/filters.py:81-95 +
    utils.py:185-191): per-pixel SIGNED polarity accumulator — an event is
    kept (and the accumulator reset) when |sum of polarities| reaches the
    multiplier, so alternating-polarity noise cancels."""
    counter = np.zeros((height, width), np.int64)
    p = np.where(np.asarray(ev["p"]) > 0, 1, -1)
    keep = np.zeros(len(ev), bool)
    for i in range(len(ev)):
        yx = (ev["y"][i], ev["x"][i])
        counter[yx] += p[i]
        if abs(counter[yx]) >= multiplier:
            counter[yx] = 0
            keep[i] = True
    return ev[keep]


def refractory_period_filter(ev, height: int, width: int, depth_us: int):
    """RefractoryPeriod (tools/filters.py:97-110 + utils.py:194-200): drop
    events within ``depth_us`` OF THE LAST KEPT event at the pixel; the
    boundary t - last == depth_us is KEPT (the reference drops only
    strictly-inside gaps)."""
    last = np.full((height, width), -np.inf)
    keep = np.zeros(len(ev), bool)
    for i in range(len(ev)):
        yx = (ev["y"][i], ev["x"][i])
        if ev["t"][i] - last[yx] >= depth_us:
            keep[i] = True
            last[yx] = ev["t"][i]
    return ev[keep]
