"""Gen1 automotive detection dataset over the study's HDF5 layout (a copy of
the JAX package's ``data/gen1.py``, host NumPy + h5py, or without h5py
``events/h5lite.py`` for files without Blosc chunks).

Layout (ev-YOLOv6/yolov6/data/gen1_2yolo.py:65-198): one file per split
(training/validation/testing.h5), one group per recording with
``bbox/{t_unique, offsets, class_id, x, y, w, h, event_idx}`` and
``events/{x, y, t, p, height, width}``. A sample is one unique bbox
timestamp: its boxes plus the 50k events ending at ``event_idx``.

The loader returns fixed-shape samples: raw padded event windows + padded
normalized labels. The representation, resize and letterbox run on the
device (the train and eval steps).

``write_gen1_fixture`` generates synthetic files with the same layout for
tests and smoke runs (the reference ships no fixtures).
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

try:
    import h5py
except ImportError:  # no h5py: the HDF5 subset of events/h5lite.py (no Blosc)
    from ..events import h5lite as h5py

SPLIT_FILES = {"train": "training.h5", "val": "validation.h5", "test": "testing.h5"}
CLASSES = ("car", "pedestrian")


@dataclasses.dataclass
class Gen1Sample:
    """Fixed-capacity sample."""

    events: np.ndarray  # (4, capacity) int32 rows x, y, t, p
    num_events: int
    labels: np.ndarray  # (max_boxes, 5) [cls, cx, cy, w, h] normalized
    num_labels: int
    index: int
    height: int
    width: int


class Gen1H5:
    """Reader for one split of the Gen1 HDF5 dataset."""

    def __init__(
        self,
        root,
        task: str = "train",
        num_events: int = 50000,
        max_boxes: int = 32,
        time_window: int = 300000,
        window_mode: str = "count",  # "count" (reference) | "time" (us)
    ):
        root = pathlib.Path(root)
        path = root / SPLIT_FILES[task.lower()] if root.is_dir() else root
        # the published split files are Blosc-ZSTD compressed (gen1_2yolo.py:12
        # imports hdf5plugin); open_h5 decodes those chunks even without it
        from ..events import blosc_codec

        self.h5 = blosc_codec.open_h5(path, "r")
        self.task = task
        self.num_events = num_events
        self.max_boxes = max_boxes
        self.time_window = time_window
        assert window_mode in ("count", "time")
        self.window_mode = window_mode
        self._file_names = sorted(self.h5.keys())
        self._counts = [
            len(self.h5[f"{f}/bbox/t_unique"]) for f in self._file_names
        ]
        self._cum = np.cumsum([0] + self._counts)
        first = self._file_names[0]
        self.height = int(self.h5[f"{first}/events/height"][()])
        self.width = int(self.h5[f"{first}/events/width"][()])
        self.classes = list(CLASSES)

    def __len__(self) -> int:
        return int(self._cum[-1])

    def _locate(self, idx: int):
        """Global index -> (local index, group) via the prefix sums
        (gen1_2yolo.py:160-166)."""
        file_i = int(np.searchsorted(self._cum, idx, side="right")) - 1
        return idx - int(self._cum[file_i]), self.h5[self._file_names[file_i]]

    def _load_bbox(self, handle, idx: int):
        """Normalized [cls, cx, cy, w, h] with the reference's clip-to-frame
        (gen1_2yolo.py:168-184). Numerics mirror the reference: each side is
        normalized in float32, but stacking with the int64 class_id promotes
        the bbox to float64, so the clip/center chain runs in f64 on the
        f32-rounded sides (an unclipped box keeps w/h bit-exact)."""
        b = handle["bbox"]
        i0 = 0 if idx == 0 else int(b["offsets"][idx - 1])
        i1 = int(b["offsets"][idx])
        cls = np.asarray(b["class_id"][i0:i1], np.float64)
        x = (np.asarray(b["x"][i0:i1], np.float32) / self.width).astype(np.float64)
        y = (np.asarray(b["y"][i0:i1], np.float32) / self.height).astype(np.float64)
        w = (np.asarray(b["w"][i0:i1], np.float32) / self.width).astype(np.float64)
        h = (np.asarray(b["h"][i0:i1], np.float32) / self.height).astype(np.float64)
        x2 = np.clip(x + w, 0, 1)
        y2 = np.clip(y + h, 0, 1)
        x1 = np.clip(x, 0, 1)
        y1 = np.clip(y, 0, 1)
        w, h = x2 - x1, y2 - y1
        cx, cy = x1 + 0.5 * w, y1 + 0.5 * h
        event_idx = int(b["event_idx"][idx])
        return np.stack([cls, cx, cy, w, h], axis=-1), event_idx

    def _load_events(self, handle, event_idx: int):
        """The event window ending at the bbox timestamp: the reference's
        fixed 50k-count slice (gen1_2yolo.py:186-198), or — with
        ``window_mode='time'`` — the last ``time_window`` microseconds (the
        'us'-unit windowing of ev-licious h5_event_handle.py:71-103, which
        the reference plumbs as ``time_window`` but never connects). Time
        windows are still capped at ``num_events`` (the fixed device
        capacity)."""
        ev = handle["events"]
        if self.window_mode == "time":
            t_end = int(ev["t"][event_idx - 1]) if event_idx > 0 else 0
            i0 = int(
                np.searchsorted(ev["t"], t_end - self.time_window, side="left")
            )
            i0 = max(i0, event_idx - self.num_events, 0)
        else:
            i0 = max(0, event_idx - self.num_events)
        x = np.asarray(ev["x"][i0:event_idx], np.int32)
        y = np.asarray(ev["y"][i0:event_idx], np.int32)
        t = np.asarray(ev["t"][i0:event_idx], np.int64)
        p = np.asarray(ev["p"][i0:event_idx], np.int32)
        if len(t):
            t = t - t[0]
        return x, y, t.astype(np.int32), p

    def __getitem__(self, idx: int) -> Gen1Sample:
        local, handle = self._locate(idx)
        labels, event_idx = self._load_bbox(handle, local)
        x, y, t, p = self._load_events(handle, event_idx)

        n = len(x)
        ev = np.zeros((4, self.num_events), np.int32)
        ev[0, :n], ev[1, :n], ev[2, :n], ev[3, :n] = x, y, t, p

        nl = min(len(labels), self.max_boxes)
        lab = np.zeros((self.max_boxes, 5), np.float32)
        lab[:nl] = labels[:nl]
        return Gen1Sample(
            events=ev, num_events=n, labels=lab, num_labels=nl,
            index=idx, height=self.height, width=self.width,
        )

    def structured_events(self, idx: int) -> np.ndarray:
        """Reference-style structured (x, y, t, p) array for the parity /
        GWD paths (gen1_2yolo.py:567-571 dtype)."""
        s = self[idx]
        n = s.num_events
        out = np.zeros(n, dtype=[("x", "<i4"), ("y", "<i4"), ("t", "<i4"), ("p", "<i4")])
        out["x"], out["y"], out["t"], out["p"] = (
            s.events[0, :n], s.events[1, :n], s.events[2, :n], s.events[3, :n]
        )
        return out


def write_gen1_fixture(
    path,
    num_files: int = 2,
    boxes_per_file: int = 3,
    events_per_file: int = 20000,
    height: int = 240,
    width: int = 304,
    seed: int = 0,
    learnable: bool = False,
    blosc: bool = False,
    box_w: Tuple[float, float] = (20.0, 80.0),
    box_h: Tuple[float, float] = (20.0, 60.0),
):
    """Synthetic Gen1-layout HDF5 for tests.

    ``learnable=True`` correlates events with the labels: a dense cluster of
    events is relocated into each box in the window preceding its timestamp
    (class 0 only), so a detector trained on the fixture has signal to learn
    from — the stand-in for real-data training runs.

    ``blosc=True`` compresses the event/bbox arrays with the exact flags the
    published files use (filter 32001, zstd, bit-shuffle, clevel 1 —
    gen4/precompute_reps.py:31-48) so tests cover the real on-disk format."""
    from ..events.fake import generate_fake_events

    if blosc:
        from ..events import blosc_codec

        def _store(group, key, arr):
            arr = np.ascontiguousarray(arr)
            ds = blosc_codec.create_blosc_dataset(
                group, key, arr.shape, arr.dtype,
                chunks=(min(max(len(arr), 1), 1 << 13),),
            )
            blosc_codec.write_blosc(ds, arr)
    else:

        def _store(group, key, arr):
            group[key] = arr

    rng = np.random.default_rng(seed)
    with h5py.File(path, "w") as f:
        for i in range(num_files):
            g = f.create_group(f"rec{i:03d}")
            x, y, t, p = generate_fake_events(
                events_per_file, height, width, duration_us=1_000_000,
                seed=seed + i, structured=False,
            )
            gb_data = {}
            n = boxes_per_file
            per = rng.integers(1, 4, n)
            offsets = np.cumsum(per)
            total = int(offsets[-1])
            bw = rng.uniform(*box_w, total)
            bh = rng.uniform(*box_h, total)
            gb_data["t_unique"] = np.sort(
                rng.integers(0, 1_000_000, n)
            ).astype(np.int64)
            gb_data["offsets"] = offsets.astype(np.int64)
            cls = rng.integers(0, 2, total)
            bx = rng.uniform(0, max(width - box_w[1], 1), total)
            by = rng.uniform(0, max(height - box_h[1], 1), total)
            event_idx = np.sort(
                rng.integers(1000, events_per_file, n)
            ).astype(np.int64)

            if learnable:
                cls[:] = 0
                starts = np.concatenate([[0], offsets[:-1]])
                for bi in range(n):
                    lo, hi = int(starts[bi]), int(offsets[bi])
                    e1 = int(event_idx[bi])
                    e0 = max(0, e1 - 800 * (hi - lo))
                    sel = np.arange(e0, e1)
                    # relocate 70% of the window's events into the boxes
                    sel = sel[rng.random(len(sel)) < 0.7]
                    which = rng.integers(lo, hi, len(sel))
                    x[sel] = (bx[which] + rng.random(len(sel)) * bw[which]).astype(
                        x.dtype
                    )
                    y[sel] = (by[which] + rng.random(len(sel)) * bh[which]).astype(
                        y.dtype
                    )

            ge = g.create_group("events")
            _store(ge, "x", x.astype(np.uint16))
            _store(ge, "y", y.astype(np.uint16))
            _store(ge, "t", t.astype(np.int64))
            _store(ge, "p", p.astype(np.int8))
            ge["height"], ge["width"] = height, width
            gb = g.create_group("bbox")
            for k, v in gb_data.items():
                _store(gb, k, v)
            _store(gb, "class_id", cls.astype(np.int64))
            _store(gb, "x", bx.astype(np.float32))
            _store(gb, "y", by.astype(np.float32))
            _store(gb, "w", bw.astype(np.float32))
            _store(gb, "h", bh.astype(np.float32))
            _store(gb, "event_idx", event_idx)
    return path
