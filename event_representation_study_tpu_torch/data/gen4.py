"""1 Mpx (Gen4 / Prophesee) detection pipeline — the equivalent of the
3-stage offline workflow in ev-YOLOv6/yolov6/data/gen4/precompute_reps.py:

1. :func:`consolidate_npz` — per-recording npz (events + labeled boxes) ->
   one consolidated ``{split}.h5`` with out-of-bounds event filtering
   (precompute_reps.py:284-287), frame-cropped boxes (:588-615), the paper's
   box filter (diag >= 60, sides >= 20, :617-635) and class_id <= 2 (:305).
2. :func:`Gen4Dataset` — fixed 70k-event windows ending at each label
   timestamp (the re-chunking of :313-387 realized lazily at read time; no
   second on-disk copy is needed because the representation builds fused on
   device).
3. representation baking -> cli/precompute_reps.py (shared with Gen1).

Sensor: 1280 x 720; classes pedestrian / two-wheeler / car.

A copy of the JAX package's ``data/gen4.py`` (NumPy only). The files are
written through h5py where it is installed and through ``events/h5lite.py``
otherwise; either way Blosc-ZSTD chunks when this process has a Blosc codec
(``blosc_codec.available()``), plain datasets only when it has none.
"""
from __future__ import annotations

import pathlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

try:
    import h5py
except ImportError:  # no h5py: events/h5lite.py writes the files
    from ..events import h5lite as h5py

GEN4_H, GEN4_W = 720, 1280
GEN4_CLASSES = ("pedestrian", "two-wheeler", "car")
NUM_EVENTS_GEN4 = 70000


def crop_to_frame(boxes: np.ndarray, height: int, width: int) -> np.ndarray:
    """boxes rows [t, x, y, w, h, cls]: clip to the frame, drop degenerate
    (precompute_reps.py:588-615)."""
    out = []
    for b in boxes:
        t, x, y, w, h, c = b[:6]
        if w > width:  # reference filters error labels with w > 1280
            continue
        if x < 0:
            w += x
            x = 0
        if y < 0:
            h += y
            y = 0
        if x + w > width:
            w = width - x
        if y + h > height:
            h = height - y
        if w > 0 and h > 0 and x < width and y <= height:
            out.append([t, x, y, w, h, c])
    return np.asarray(out, np.float64).reshape(-1, 6)


def filter_boxes(boxes: np.ndarray, min_box_diag: float = 60, min_box_side: float = 20):
    """The paper's evaluation filter (precompute_reps.py:617-635)."""
    w, h = boxes[:, 3], boxes[:, 4]
    mask = (w**2 + h**2 >= min_box_diag**2) & (w >= min_box_side) & (h >= min_box_side)
    return boxes[mask]


def _store(group, key, arr):
    """Blosc-ZSTD bit-shuffle dataset when a codec is available (the
    reference consolidation's H5_BLOSC_COMPRESSION_FLAGS,
    precompute_reps.py:31-48), plain otherwise."""
    from ..events import blosc_codec

    arr = np.ascontiguousarray(arr)
    if arr.ndim == 1 and len(arr) and blosc_codec.available():
        ds = blosc_codec.create_blosc_dataset(
            group, key, arr.shape, arr.dtype,
            chunks=(min(len(arr), 1 << 16),),
        )
        blosc_codec.write_blosc(ds, arr)
    else:
        group[key] = arr


def _write_recording(f, i, x, y, t, p, boxes, height, width, max_class_id):
    """One Gen1-layout recording group: filtered events + timestamp-grouped
    boxes (the write side of precompute_reps.py:253-310 toh5pyfiles)."""
    ok = (x >= 0) & (x < width) & (y >= 0) & (y < height)
    x, y, t, p = x[ok], y[ok], t[ok], p[ok]
    boxes = crop_to_frame(boxes, height, width)
    boxes = filter_boxes(boxes)
    boxes = boxes[boxes[:, 5] <= max_class_id]

    g = f.create_group(f"rec{i:05d}")
    ge = g.create_group("events")
    _store(ge, "x", x.astype(np.uint16))
    _store(ge, "y", y.astype(np.uint16))
    _store(ge, "t", t.astype(np.int64))
    _store(ge, "p", np.where(p > 0, 1, -1).astype(np.int8))
    ge["height"], ge["width"] = height, width

    # group boxes by unique timestamp like the Gen1 layout
    ts = boxes[:, 0]
    t_unique, inv = np.unique(ts, return_inverse=True)
    order = np.argsort(inv, kind="stable")
    boxes = boxes[order]
    counts = np.bincount(inv, minlength=len(t_unique))
    offsets = np.cumsum(counts)
    event_idx = np.searchsorted(t, t_unique, side="right")
    gb = g.create_group("bbox")
    _store(gb, "t_unique", t_unique.astype(np.int64))
    _store(gb, "offsets", offsets.astype(np.int64))
    _store(gb, "class_id", boxes[:, 5].astype(np.int64))
    _store(gb, "x", boxes[:, 1].astype(np.float32))
    _store(gb, "y", boxes[:, 2].astype(np.float32))
    _store(gb, "w", boxes[:, 3].astype(np.float32))
    _store(gb, "h", boxes[:, 4].astype(np.float32))
    _store(gb, "event_idx", event_idx.astype(np.int64))


def consolidate_npz(
    npz_files: Sequence[str],
    out_path,
    height: int = GEN4_H,
    width: int = GEN4_W,
    max_class_id: int = 2,
):
    """Stage 1: one group per recording with the Gen1-compatible layout so
    Gen4 plugs into the same loaders."""
    with h5py.File(out_path, "w") as f:
        for i, path in enumerate(sorted(npz_files)):
            try:
                fh = np.load(path)
            except Exception:  # bad-CRC tolerance (precompute_reps.py:278-282)
                continue
            boxes = np.asarray(fh["boxes"]) if "boxes" in fh else np.zeros((0, 6))
            _write_recording(
                f, i, np.asarray(fh["x"]), np.asarray(fh["y"]),
                np.asarray(fh["t"]), np.asarray(fh["p"]), boxes,
                height, width, max_class_id,
            )
    return out_path


def _load_boxes_any(path) -> np.ndarray:
    """Box file -> (N, 6) [t, x, y, w, h, cls]: Prophesee GT .npy (structured
    dtype with t/ts, x, y, w, h, class_id fields — the 1 Mpx release format)
    or a plain (N, 6) float array."""
    raw = np.load(path)
    if raw.dtype.names:
        tkey = "t" if "t" in raw.dtype.names else "ts"
        cols = [raw[tkey], raw["x"], raw["y"], raw["w"], raw["h"],
                raw["class_id"]]
        return np.stack([np.asarray(c, np.float64) for c in cols], -1)
    return np.asarray(raw, np.float64).reshape(-1, 6)


def consolidate_recordings(
    event_files: Sequence[str],
    box_files: Sequence[Optional[str]],
    out_path,
    height: int = GEN4_H,
    width: int = GEN4_W,
    max_class_id: int = 2,
):
    """Stage 1 from the dataset's RELEASE formats: per-recording event files
    in any supported container (Prophesee ``*_td.dat`` EVT2.0, .h5, .npz,
    .npy — suffix-dispatched through events.load_events_from_path) paired
    with ``*_bbox.npy`` GT files. This closes the raw-download -> train
    chain without the reference's intermediate npy conversion
    (precompute_reps.py:270-271 loads preconverted npy pairs)."""
    from ..events.h5_io import load_events_from_path

    assert len(event_files) == len(box_files)
    pairs = sorted(zip(event_files, box_files), key=lambda ab: str(ab[0]))
    with h5py.File(out_path, "w") as f:
        for i, (ev_path, box_path) in enumerate(pairs):
            ev = load_events_from_path(ev_path)
            boxes = (
                _load_boxes_any(box_path)
                if box_path is not None
                else np.zeros((0, 6))
            )
            _write_recording(
                f, i, np.asarray(ev["x"]), np.asarray(ev["y"]),
                np.asarray(ev["t"]), np.asarray(ev["p"]), boxes,
                height, width, max_class_id,
            )
    return out_path


class Gen4Dataset:
    """Thin wrapper: the consolidated file uses the Gen1 layout, so the
    Gen1H5 reader serves it with the Gen4 window size."""

    def __new__(cls, path, task: str = "train", num_events: int = NUM_EVENTS_GEN4,
                max_boxes: int = 64):
        from .gen1 import Gen1H5

        ds = Gen1H5(path, task=task, num_events=num_events, max_boxes=max_boxes)
        ds.classes = list(GEN4_CLASSES)
        return ds


def write_gen4_npz_fixture(root, num_recordings: int = 2, n_events: int = 8000,
                           seed: int = 0) -> List[str]:
    """Synthetic per-recording npz files for tests."""
    from ..events.fake import generate_fake_events

    rng = np.random.default_rng(seed)
    root = pathlib.Path(root)
    root.mkdir(parents=True, exist_ok=True)
    files = []
    for i in range(num_recordings):
        x, y, t, p = generate_fake_events(
            n_events, GEN4_H, GEN4_W, duration_us=1_000_000, seed=seed + i,
            structured=False,
        )
        nb = 6
        boxes = np.zeros((nb, 6))
        boxes[:, 0] = np.sort(rng.integers(0, 1_000_000, nb))
        boxes[:, 1] = rng.uniform(-50, GEN4_W - 100, nb)
        boxes[:, 2] = rng.uniform(-50, GEN4_H - 100, nb)
        boxes[:, 3] = rng.uniform(10, 300, nb)
        boxes[:, 4] = rng.uniform(10, 200, nb)
        boxes[:, 5] = rng.integers(0, 4, nb)
        path = root / f"rec{i}.npz"
        np.savez(path, x=x, y=y, t=t, p=(p > 0), boxes=boxes)
        files.append(str(path))
    return files


class Gen4RawDataset:
    """On-the-fly variant — the equivalent of
    ev-YOLOv6/yolov6/data/gen4/gen4_2yolo_raw.py (606 LoC): reads the
    per-recording npz directly (no consolidation pass), applies the same
    box filters, and serves fixed event windows ending at each label
    timestamp as :class:`..data.gen1.Gen1Sample` items (the loader and the
    fused device pipeline are shared with Gen1)."""

    def __init__(self, npz_files: Sequence[str], num_events: int = NUM_EVENTS_GEN4,
                 max_boxes: int = 64, height: int = GEN4_H, width: int = GEN4_W,
                 max_class_id: int = 2):
        self.files = sorted(str(f) for f in npz_files)
        self.num_events = num_events
        self.max_boxes = max_boxes
        self.height = height
        self.width = width
        self.classes = list(GEN4_CLASSES)
        self._cache_path: Optional[str] = None
        self._cache = None
        # index pass: (file_i, t_unique) per label timestamp
        self._items: List[Tuple[int, float]] = []
        self._rec_of_item: List[int] = []
        for fi, path in enumerate(self.files):
            try:
                fh = np.load(path)
            except Exception:  # bad-CRC tolerance (precompute_reps.py:278-282)
                continue
            boxes = np.asarray(fh["boxes"]) if "boxes" in fh else np.zeros((0, 6))
            boxes = filter_boxes(crop_to_frame(boxes, height, width))
            boxes = boxes[boxes[:, 5] <= max_class_id]
            for t in np.unique(boxes[:, 0]):
                self._items.append((fi, float(t)))
                self._rec_of_item.append(fi)

    def __len__(self):
        return len(self._items)

    def recording_boundaries(self) -> List[int]:
        """Indices whose successor belongs to a different recording — the
        exclusion list for RandomContinuousSampler."""
        out = []
        for i in range(len(self._rec_of_item) - 1):
            if self._rec_of_item[i] != self._rec_of_item[i + 1]:
                out.append(i + 1)
        return out

    def _load(self, fi: int):
        path = self.files[fi]
        if self._cache_path != path:
            fh = np.load(path)
            x, y = np.asarray(fh["x"]), np.asarray(fh["y"])
            t, p = np.asarray(fh["t"]), np.asarray(fh["p"])
            ok = (x >= 0) & (x < self.width) & (y >= 0) & (y < self.height)
            boxes = np.asarray(fh["boxes"]) if "boxes" in fh else np.zeros((0, 6))
            boxes = filter_boxes(crop_to_frame(boxes, self.height, self.width))
            self._cache = (x[ok], y[ok], t[ok], p[ok], boxes)
            self._cache_path = path
        return self._cache

    def __getitem__(self, idx: int):
        from .gen1 import Gen1Sample

        fi, t_box = self._items[idx]
        x, y, t, p, boxes = self._load(fi)
        end = int(np.searchsorted(t, t_box, side="right"))
        i0 = max(0, end - self.num_events)
        n = end - i0
        ev = np.zeros((4, self.num_events), np.int32)
        ev[0, :n] = x[i0:end]
        ev[1, :n] = y[i0:end]
        tt = t[i0:end].astype(np.int64)
        if n:
            tt = tt - tt[0]
        ev[2, :n] = tt.astype(np.int32)
        ev[3, :n] = np.where(p[i0:end] > 0, 1, -1)

        b = boxes[boxes[:, 0] == t_box]
        lab = np.zeros((self.max_boxes, 5), np.float32)
        nl = min(len(b), self.max_boxes)
        if nl:
            x1 = np.clip(b[:nl, 1] / self.width, 0, 1)
            y1 = np.clip(b[:nl, 2] / self.height, 0, 1)
            x2 = np.clip((b[:nl, 1] + b[:nl, 3]) / self.width, 0, 1)
            y2 = np.clip((b[:nl, 2] + b[:nl, 4]) / self.height, 0, 1)
            lab[:nl, 0] = b[:nl, 5]
            lab[:nl, 1] = (x1 + x2) / 2
            lab[:nl, 2] = (y1 + y2) / 2
            lab[:nl, 3] = x2 - x1
            lab[:nl, 4] = y2 - y1
        return Gen1Sample(events=ev, num_events=n, labels=lab, num_labels=nl,
                          index=idx, height=self.height, width=self.width)


def random_continuous_indices(
    data_len: int, num: int, exclude: Sequence[int],
    rng: np.random.Generator,
) -> np.ndarray:
    """RandomContinuousSampler's index stream
    (ev-YOLOv6/yolov6/data/gen4/data_sampler.py:6-44): split [0, data_len)
    into contiguous chunks of ``num``, drop chunks containing excluded
    indices (recording boundaries), shuffle chunk order, flatten — so every
    drawn pair/group of samples is temporally continuous."""
    exclude = set(int(e) for e in exclude)
    chunks = [
        list(range(i * num, (i + 1) * num)) for i in range(data_len // num)
    ]
    chunks = [c for c in chunks if not any(i in exclude for i in c)]
    order = rng.permutation(len(chunks))
    return np.asarray([i for k in order for i in chunks[k]], np.int64)
