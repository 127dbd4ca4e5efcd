"""Synthetic Gen1 windows made from a seed: the benchmark's own traffic
maker for the detector cells (the port is never asked to make inputs).

Events follow ``events/fake.py::generate_fake_events`` of the port (copied
here so the yardstick cannot move with the program): two moving Gaussian
blobs over a uniform background, sorted timestamps, polarity in {-1, +1}.
A split of ``length`` windows holds ``unique`` drawn windows; window i is
drawn window ``i % unique`` with its pixels shifted by ``i // unique``
steps of (37, 17) px around the sensor, so every window of the split
differs. Boxes are 1..``max_labels`` Gen1-like boxes a window (normalised
class, cx, cy, w, h), drawn for window i from (seed, i) when it is read.

The split has the interface of ``data/gen1.py::Gen1H5`` that
``data/loader.py::EventBatchLoader`` uses: ``len``, indexing to a sample
with ``events`` (4, N) int32, ``num_events``, ``labels`` (max_boxes, 5),
``num_labels``, ``index``, ``height``, ``width``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

SHIFT = (37, 17)  # px a repeat moves a window by, x and y


def fake_events(n: int, height: int, width: int, duration_us: int, seed: int) -> np.ndarray:
    """(4, n) int32 rows x, y, t, p (a copy of the port's
    ``generate_fake_events``)."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.integers(0, duration_us, size=n)).astype(np.int64)
    frac = t / max(duration_us, 1)
    cx = width * (0.25 + 0.5 * frac)
    cy = height * (0.6 - 0.3 * frac)
    blob = rng.random(n) < 0.7
    x = np.where(blob, np.clip(rng.normal(cx, width * 0.05), 0, width - 1),
                 rng.integers(0, width, size=n)).astype(np.int64)
    y = np.where(blob, np.clip(rng.normal(cy, height * 0.05), 0, height - 1),
                 rng.integers(0, height, size=n)).astype(np.int64)
    p = rng.choice(np.array([-1, 1], dtype=np.int64), size=n)
    return np.stack([x, y, t - t[0], p]).astype(np.int32)


@dataclasses.dataclass
class Sample:
    events: np.ndarray
    num_events: int
    labels: np.ndarray
    num_labels: int
    index: int
    height: int
    width: int


class SyntheticGen1:
    """One split of synthetic Gen1 windows (module docstring)."""

    def __init__(self, seed: int, length: int, unique: int, num_events: int,
                 duration_us: int, height: int = 240, width: int = 304,
                 max_boxes: int = 32, max_labels: int = 8, box_wh=(0.04, 0.3)):
        rng = np.random.default_rng(seed)
        self.height, self.width = height, width
        self.length, self.unique = int(length), int(unique)
        self.base = [fake_events(num_events, height, width, duration_us,
                                 int(rng.integers(2 ** 62))) for _ in range(self.unique)]
        self.label_seed = int(rng.integers(2 ** 62))
        self.max_boxes, self.max_labels, self.box_wh = max_boxes, max_labels, box_wh

    def labels(self, idx: int):
        """(max_boxes, 5) boxes of window ``idx`` and their count."""
        rng = np.random.default_rng((self.label_seed, idx))
        n = int(rng.integers(1, self.max_labels + 1))
        lab = np.zeros((self.max_boxes, 5), np.float32)
        lab[:n, 0] = rng.integers(0, 2, n)
        lab[:n, 1:3] = rng.uniform(0.15, 0.85, (n, 2))
        lab[:n, 3:5] = rng.uniform(self.box_wh[0], self.box_wh[1], (n, 2))
        return lab, n

    def __len__(self) -> int:
        return self.length

    def events(self, idx: int) -> np.ndarray:
        ev = self.base[idx % self.unique].copy()
        k = idx // self.unique
        if k:
            ev[0] = (ev[0] + SHIFT[0] * k) % self.width
            ev[1] = (ev[1] + SHIFT[1] * k) % self.height
        return ev

    def __getitem__(self, idx: int) -> Sample:
        idx = int(idx)
        ev = self.events(idx)
        lab, n = self.labels(idx)
        return Sample(ev, ev.shape[1], lab, n, idx, self.height, self.width)


def from_traffic(traffic: dict, seed: int) -> SyntheticGen1:
    """The split a traffic file describes, drawn from ``seed``."""
    return SyntheticGen1(seed, traffic["length"], traffic["unique_windows"],
                         traffic["num_events"], traffic["duration_us"],
                         max_labels=traffic.get("max_labels", 8),
                         box_wh=tuple(traffic.get("box_wh", (0.04, 0.3))))
