"""Legacy RED-style Gen4 loader — twin of the reference's split-npz path (a
copy of the JAX package's ``data/gen4_legacy.py``, NumPy only).

Reference: ev-YOLOv6/yolov6/data/gen4/{dataset.py,data_loader.py,
data_sampler.py}. That path is DEAD CODE in the reference's own flow
(gen4_2yolo.py / precompute_reps.py is the used pipeline — SURVEY.md §2.3):

* ``Prophesee.__getitem__`` calls ``self.voxel_generator.generate``
  (dataset.py:155) but ``voxel_generator`` is never assigned anywhere in the
  subproject — an AttributeError on first item access.
* ``@nb.jit()`` decorates an instance method (dataset.py:81) and a function
  doing ``os.listdir`` + string joins (dataset.py:254), both of which numba
  cannot compile (it falls back to object mode / warns).
* ``__getitem__`` joins ``root/mode/labels/<file>`` (dataset.py:91-92) while
  ``load_data_files`` already returned FULL paths rooted at
  ``root/mode/<filelist>/events/...`` (dataset.py:275-278) — the two halves
  disagree about the directory layout.

This twin reproduces the well-defined semantics exactly — split-npz window
iteration with the CRC-fallback rule, out-of-bounds event masking, the
crop-to-frame and min-diag-60/min-side-20 box rules, the 1280x720 -> 512x512
event downsample with per-pixel dedup and t renormalised to [0, 4], the label
rescale to 512-scale xyxy, the polarity split with empty-side fallback, the
60-slot -1-padded box tensor, and the batch-index collate — and replaces the
undefined voxel generator with fixed-capacity padded event blocks (static
shapes, so a batch dispatches straight into the fused device representations
instead of per-item dynamic voxel lists).
"""
from __future__ import annotations

import os
import pathlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
from numpy.lib import recfunctions as rfn

from .gen4 import GEN4_H, GEN4_W

LEGACY_SIZE = 512  # dataset.py:130 resolution=1280x720 -> 512x512
MAX_NR_BBOX = 60  # dataset.py:62


def downsample_event_stream(events: np.ndarray) -> np.ndarray:
    """1280x720 -> 512x512 with per-pixel dedup (dataset.py:183-192).

    ``events`` rows are (x, y, t, p).  x and y are rescaled to the 512 grid
    (keeping fractional coordinates, as the reference does), t is renormalised
    to [0, 4] relative to the window, then events are deduplicated on the
    (x, y) pair — ``np.unique(..., return_index=True)`` keeps the FIRST
    occurrence of each pixel — and re-sorted by time.
    """
    ev = np.array(events, np.float64, copy=True)
    ev[:, 0] = ev[:, 0] / GEN4_W * LEGACY_SIZE
    ev[:, 1] = ev[:, 1] / GEN4_H * LEGACY_SIZE
    delta_t = ev[-1, 2] - ev[0, 2]
    if delta_t == 0:
        ev[:, 2] = 0.0
    else:
        ev[:, 2] = 4 * (ev[:, 2] - ev[0, 2]) / delta_t
    _, idx = np.unique(ev[:, :2], axis=0, return_index=True)
    ev = ev[idx]
    return ev[np.argsort(ev[:, 2], kind="stable")]


def normalize_histogram(histogram: np.ndarray) -> np.ndarray:
    """Standard-normalise over the nonzero bins (dataset.py:194-202)."""
    nonzero = histogram != 0
    n = nonzero.sum()
    if n > 0:
        mean = histogram.sum() / n
        std = np.sqrt((histogram**2).sum() / n - mean**2)
        histogram = nonzero * (histogram - mean) / (std + 1e-8)
    return histogram


def crop_to_frame_xywh(boxes: np.ndarray, height: int = GEN4_H,
                       width: int = GEN4_W) -> np.ndarray:
    """Legacy-layout crop: rows (x, y, w, h, class) (dataset.py:204-231).

    Matches the reference row-for-row: boxes wider than the sensor are
    dropped as label errors, negative origins are clipped with the width and
    height shrunk accordingly, overhangs are clipped to the frame, and only
    boxes with positive extent that start inside the frame survive (note the
    reference's asymmetric ``x < width`` / ``y <= height`` pair, kept as-is).
    """
    out = []
    for box in np.asarray(boxes, np.float64):
        x, y, w, h, c = box[:5]
        if w > width:
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
            out.append([x, y, w, h, c])
    return np.asarray(out, np.float64).reshape(-1, 5)


def filter_boxes_xywh(boxes: np.ndarray, min_box_diag: float = 60,
                      min_box_side: float = 20) -> np.ndarray:
    """Paper box filter on (x, y, w, h, class) rows (dataset.py:233-251)."""
    boxes = np.asarray(boxes, np.float64).reshape(-1, 5)
    w, h = boxes[:, 2], boxes[:, 3]
    mask = (w**2 + h**2 >= min_box_diag**2) & (w >= min_box_side) & (h >= min_box_side)
    return boxes[mask]


def rescale_labels_512(labels: np.ndarray) -> np.ndarray:
    """(x, y, w, h, class) at 1280x720 -> (x1, y1, x2, y2, class) at 512x512.

    The reference reaches this through a five-step xywh->xyxy->normalised->
    512->xywh->xyxy dance (dataset.py:133-144); algebraically it is one
    anisotropic scale of the xyxy corners by (512/1280, 512/720), which is
    what we compute (bit-equal up to float assoc., pinned by the golden test
    that replays the reference's exact step sequence).
    """
    labels = np.asarray(labels, np.float64).reshape(-1, 5)
    out = np.empty_like(labels)
    sx, sy = LEGACY_SIZE / GEN4_W, LEGACY_SIZE / GEN4_H
    out[:, 0] = labels[:, 0] * sx
    out[:, 1] = labels[:, 1] * sy
    out[:, 2] = (labels[:, 0] + labels[:, 2]) * sx
    out[:, 3] = (labels[:, 1] + labels[:, 3]) * sy
    out[:, 4] = labels[:, 4]
    return out


def split_polarity(events: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Split (x, y, t, p) rows into positive / negative streams with the
    reference's empty-side fallback (dataset.py:146-153): an empty polarity
    borrows the other side so downstream static shapes never see 0 events."""
    pos = events[events[:, -1] == 1.0].astype(np.float32)
    neg = events[events[:, -1] == 0.0].astype(np.float32)
    if not len(neg):
        neg = pos
    if not len(pos):
        pos = neg
    return pos, neg


def pad_event_block(events: np.ndarray, capacity: int) -> Tuple[np.ndarray, int]:
    """Fixed-capacity (capacity, 4) float32 block + valid count.

    Replacement for the reference's (undefined) voxel generator:
    static shapes so a whole batch of windows stacks into one device
    dispatch; truncates from the front (keeps the most recent events) when a
    window exceeds capacity, mirroring the END-aligned Gen1 windows.
    """
    events = np.asarray(events, np.float32).reshape(-1, 4)
    n = min(len(events), capacity)
    out = np.zeros((capacity, 4), np.float32)
    out[:n] = events[len(events) - n:]
    return out, n


class LegacyProphesee:
    """Iterator over split-npz recordings (dataset.py:18-181).

    Layout: ``root/<mode>/<filelist>/{events,labels}/<dir>/<file>.npy`` with
    paired, sorted event/label files (dataset.py:253-279).  Each file holds
    npz members ``e0..eN`` / ``l0..lN`` — one (events, boxes) window each.
    ``__getitem__`` returns ``(boxes, pos_blocks, neg_blocks, counts)``:

    * boxes — (num_windows, 60, 5) float32, -1-padded, rows
      (x1, y1, x2, y2, class) at 512x512 scale;
    * pos_blocks / neg_blocks — (num_windows, capacity, 4) float32 padded
      event blocks at 512 scale, (x, y, t in [0,4], p);
    * counts — (num_windows, 2) int32 valid-event counts (pos, neg).
    """

    MODES = {"training": "train", "validation": "val", "testing": "test"}

    def __init__(self, root, object_classes: Sequence[str],
                 height: int = GEN4_H, width: int = GEN4_W,
                 mode: str = "training", capacity: int = 50000):
        self.root = str(root)
        self.mode = self.MODES.get(mode, mode)
        self.height, self.width = height, width
        self.capacity = capacity
        self.object_classes = list(object_classes)
        self.nr_classes = len(self.object_classes)
        self.max_nr_bbox = MAX_NR_BBOX
        self.event_files, self.label_files, self.index_files = \
            self.load_data_files(os.path.join(self.root, self.mode))
        assert len(self.event_files) == len(self.label_files)
        self.nr_samples = len(self.event_files)

    @staticmethod
    def load_data_files(filelist_path: str):
        """Walk root/mode/<filelist>/{events,labels}/<dir>/* in sorted order
        (dataset.py:253-279).  Returns FULL event/label paths (the reference
        returns full event paths then re-joins a different layout in
        __getitem__ — see the module docstring; we keep the full-path half,
        which is the one its own directory walk produces) and the per-dir
        last-index list used by RandomContinuousSampler to avoid drawing a
        continuous pair across a recording boundary."""
        idx = 0
        event_files: List[str] = []
        label_files: List[str] = []
        index_files: List[int] = []
        for filelist in sorted(os.listdir(filelist_path)):
            event_path = os.path.join(filelist_path, filelist, "events")
            label_path = os.path.join(filelist_path, filelist, "labels")
            for dirs in sorted(os.listdir(event_path)):
                ev_sub = os.path.join(event_path, dirs)
                lb_sub = os.path.join(label_path, dirs)
                ev_list = sorted(os.listdir(ev_sub))
                lb_list = sorted(os.listdir(lb_sub))
                idx += len(ev_list) - 1
                index_files.append(idx)
                for ev, lb in zip(ev_list, lb_list):
                    event_files.append(os.path.join(ev_sub, ev))
                    label_files.append(os.path.join(lb_sub, lb))
        return event_files, label_files, index_files

    def file_index(self) -> List[int]:
        return self.index_files

    def __len__(self) -> int:
        return self.nr_samples

    def _window(self, events_np, labels_np, n: int):
        """One e{n}/l{n} window with the CRC-fallback rule
        (dataset.py:96-107): a corrupt member re-reads the previous index."""
        try:
            ev_s = events_np[f"e{n}"]
            lb_s = labels_np[f"l{n}"]
        except Exception:
            ev_s = events_np[f"e{n - 1}"]
            lb_s = labels_np[f"l{n - 1}"]
        mask = (ev_s["x"] < self.width) & (ev_s["y"] < self.height)
        ev_s = ev_s[mask]
        # field picks: events (t,x,y,p)->[x,y,t,p], labels
        # (t,x,y,w,h,class_id,...)->[x,y,w,h,class_id] (dataset.py:114-119)
        events = rfn.structured_to_unstructured(ev_s)[:, [1, 2, 0, 3]]
        labels = rfn.structured_to_unstructured(lb_s)[:, [1, 2, 3, 4, 5]]
        labels = crop_to_frame_xywh(labels, self.height, self.width)
        labels = filter_boxes_xywh(labels)
        events = downsample_event_stream(events.astype(np.float64))
        labels = rescale_labels_512(labels)
        return events, labels

    def __getitem__(self, idx: int):
        events_np = np.load(self.event_files[idx], allow_pickle=False)
        labels_np = np.load(self.label_files[idx], allow_pickle=False)
        num_windows = len(labels_np.files)
        boxes = np.full((num_windows, self.max_nr_bbox, 5), -1, np.float32)
        pos_blocks = np.zeros((num_windows, self.capacity, 4), np.float32)
        neg_blocks = np.zeros((num_windows, self.capacity, 4), np.float32)
        counts = np.zeros((num_windows, 2), np.int32)
        for n in range(num_windows):
            events, labels = self._window(events_np, labels_np, n)
            k = min(len(labels), self.max_nr_bbox)
            boxes[n, :k] = labels[:k]
            pos, neg = split_polarity(events)
            pos_blocks[n], counts[n, 0] = pad_event_block(pos, self.capacity)
            neg_blocks[n], counts[n, 1] = pad_event_block(neg, self.capacity)
        return boxes, pos_blocks, neg_blocks, counts


def collate_legacy(items) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Batch collate (data_loader.py:47-65): flatten every item's windows,
    append a running batch-index column to each window's (valid) boxes and
    concatenate; event blocks stack into one (total_windows, capacity, 4)
    array per polarity — a single static-shape device dispatch instead of the
    reference's nested python lists of per-window tensors."""
    all_labels, all_pos, all_neg, all_counts = [], [], [], []
    idx_batch = 0
    for boxes, pos, neg, counts in items:
        for w in range(boxes.shape[0]):
            valid = boxes[w][boxes[w, :, 4] >= 0]
            lb = np.concatenate(
                [valid, np.full((len(valid), 1), idx_batch, np.float32)], 1
            )
            all_labels.append(lb)
            idx_batch += 1
        all_pos.append(pos)
        all_neg.append(neg)
        all_counts.append(counts)
    labels = (np.concatenate(all_labels, 0) if all_labels
              else np.zeros((0, 6), np.float32))
    return (labels, np.concatenate(all_pos, 0), np.concatenate(all_neg, 0),
            np.concatenate(all_counts, 0))


def write_legacy_fixture(root, num_filelists: int = 1, num_dirs: int = 1,
                         num_files: int = 2, windows_per_file: int = 3,
                         n_events: int = 4000, seed: int = 0,
                         mode: str = "train") -> pathlib.Path:
    """Synthesize the legacy directory layout with Prophesee-dtyped npz
    members for tests (the reference ships no fixture — layout reverse-read
    from dataset.py:253-279 and the EVT/BBOX dtypes in box_loading)."""
    rng = np.random.default_rng(seed)
    root = pathlib.Path(root)
    ev_dtype = np.dtype([("t", "<u4"), ("x", "<u2"), ("y", "<u2"), ("p", "<u1")])
    lb_dtype = np.dtype([
        ("t", "<u8"), ("x", "<f4"), ("y", "<f4"), ("w", "<f4"), ("h", "<f4"),
        ("class_id", "<u1"), ("track_id", "<u4"), ("class_confidence", "<f4"),
    ])
    for fl in range(num_filelists):
        for d in range(num_dirs):
            ev_dir = root / mode / f"moorea_{fl}" / "events" / f"rec{d}"
            lb_dir = root / mode / f"moorea_{fl}" / "labels" / f"rec{d}"
            ev_dir.mkdir(parents=True, exist_ok=True)
            lb_dir.mkdir(parents=True, exist_ok=True)
            for f in range(num_files):
                ev_members, lb_members = {}, {}
                for w in range(windows_per_file):
                    ev = np.zeros(n_events, ev_dtype)
                    ev["t"] = np.sort(rng.integers(0, 1_000_000, n_events))
                    # a few out-of-bounds events to exercise the mask
                    ev["x"] = rng.integers(0, GEN4_W + 40, n_events)
                    ev["y"] = rng.integers(0, GEN4_H + 40, n_events)
                    ev["p"] = rng.integers(0, 2, n_events)
                    nb = int(rng.integers(1, 8))
                    lb = np.zeros(nb, lb_dtype)
                    lb["t"] = rng.integers(0, 1_000_000, nb)
                    lb["x"] = rng.uniform(-30, GEN4_W - 40, nb)
                    lb["y"] = rng.uniform(-30, GEN4_H - 40, nb)
                    lb["w"] = rng.uniform(10, 400, nb)
                    lb["h"] = rng.uniform(10, 300, nb)
                    lb["class_id"] = rng.integers(0, 3, nb)
                    ev_members[f"e{w}"] = ev
                    lb_members[f"l{w}"] = lb
                np.savez(ev_dir / f"{f:05d}.npz", **ev_members)
                np.savez(lb_dir / f"{f:05d}.npz", **lb_members)
    return root
