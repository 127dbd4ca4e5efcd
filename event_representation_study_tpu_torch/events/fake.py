"""Synthetic event generation for tests and benchmarks.

Mirrors the role of ev-licious ``io/utils/fake_events.py``
(``generate_fake_events``): deterministic random (x, y, t, p) streams with
sorted timestamps and {-1, +1} polarity.
"""
from __future__ import annotations

import numpy as np


def generate_fake_events(
    n: int,
    height: int = 240,
    width: int = 304,
    duration_us: int = 1_000_000,
    seed: int = 0,
    structured: bool = True,
):
    """Generate ``n`` random events over an ``height x width`` sensor.

    Events are drawn with a moving-blob bias (so representations are not
    spatially uniform), timestamps sorted ascending in [0, duration_us].
    """
    rng = np.random.default_rng(seed)
    t = np.sort(rng.integers(0, duration_us, size=n)).astype(np.int64)
    # two moving gaussian blobs + uniform background
    frac = t / max(duration_us, 1)
    cx = width * (0.25 + 0.5 * frac)
    cy = height * (0.6 - 0.3 * frac)
    blob = rng.random(n) < 0.7
    x = np.where(
        blob,
        np.clip(rng.normal(cx, width * 0.05), 0, width - 1),
        rng.integers(0, width, size=n),
    ).astype(np.int64)
    y = np.where(
        blob,
        np.clip(rng.normal(cy, height * 0.05), 0, height - 1),
        rng.integers(0, height, size=n),
    ).astype(np.int64)
    p = rng.choice(np.array([-1, 1], dtype=np.int64), size=n)
    if not structured:
        return x, y, t, p
    out = np.zeros(n, dtype=[("x", "<i4"), ("y", "<i4"), ("t", "<i4"), ("p", "<i4")])
    out["x"], out["y"], out["t"], out["p"] = x, y, t, p
    return out
