"""Mini N-ImageNet event-classification data pipeline — the equivalent of
n_imagenet/real_cnn_model/data/imagenet.py.

Samples are .npz files of ``event_data`` (x, y, t, p); the pipeline
1. reshapes 480x640 sensor coords to 224x224 (``no_sample`` coordinate
   rescale :105-109, ``sample`` subsampling :87-103),
2. slices a random fixed-length 30k-event window (slice_method=random,
   :60-84),
3. builds a representation (the study's 6 loader_types map to our fused
   kernels; e.g. ``reshape_then_optimized`` :1025-1040 -> ERGO-12),
4. optional shift/flip augmentation (:1140-1191).

Polarity convention: N-ImageNet stores p in {0, 1}; the representations
normalize via the same rules as the dispatcher.

A copy of the JAX package's ``data/nimagenet.py`` (host NumPy): the same
``seed`` draws the same numbers (``np.random.default_rng``), so the same
samples come out bit for bit. Step 3 runs on the device in
``train/classifier.py`` (``batched_representation``; ERGO-12 on K1).
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

SENSOR_H, SENSOR_W = 480, 640
IMAGE_H, IMAGE_W = 224, 224


def reshape_event_no_sample(ev: np.ndarray, orig_h, orig_w, new_h, new_w):
    """Coordinate rescale (imagenet.py:105-109)."""
    out = ev.astype(np.float64).copy()
    out[:, 0] *= new_w / orig_w
    out[:, 1] *= new_h / orig_h
    return out


def reshape_event_with_sample(ev, orig_h, orig_w, new_h, new_w, rng):
    """Subsample proportionally to the area ratio then rescale
    (imagenet.py:87-103)."""
    ratio = (new_h * new_w) / (orig_h * orig_w)
    n = int(ratio * len(ev))
    sel = np.sort(rng.choice(len(ev), size=n, replace=False))
    return reshape_event_no_sample(ev[sel], orig_h, orig_w, new_h, new_w)


def slice_events_random(ev, length: int, rng):
    """Random fixed-length window (imagenet.py:60-84, slice_method=random)."""
    if len(ev) <= length:
        return ev
    start = rng.integers(0, len(ev) - length)
    return ev[start : start + length]


def base_augment(ev, new_w: int, rng, new_h: int = None):
    """The reference's train-mode event augmentation (imagenet.py:1140-1191
    base_augment): random time flip (reverse order, t -> t_max - t, invert
    polarity), random x flip, then a +-20 px shift that DROPS events landing
    outside the frame (not a clip)."""
    new_h = IMAGE_H if new_h is None else new_h
    ev = ev.copy()
    if rng.random() < 0.5:  # random_time_flip (:1166-1173)
        ev = ev[::-1].copy()
        ev[:, 2] = ev[0, 2] - ev[:, 2]
        ev[:, 3] = -ev[:, 3]
    if rng.random() < 0.5:  # random_flip_events_along_x (:1157-1163)
        ev[:, 0] = new_w - 1 - ev[:, 0]
    shift = rng.integers(-20, 21, 2)  # random_shift_events (:1140-1154)
    ev[:, 0] += shift[0]
    ev[:, 1] += shift[1]
    keep = (
        (ev[:, 0] >= 0) & (ev[:, 0] < new_w)
        & (ev[:, 1] >= 0) & (ev[:, 1] < new_h)
    )
    return ev[keep]


@dataclasses.dataclass
class NImageNetSample:
    events: np.ndarray  # (4, capacity) int32
    num_events: int
    label: int


class NImageNetDataset:
    """File-list driven dataset (train_list.txt style: one npz path per line,
    labels from the parent directory name via a label map)."""

    def __init__(
        self,
        file_list: Sequence[str],
        labels: Sequence[int],
        loader_type: str = "reshape_then_optimized",
        slice_length: int = 30000,
        reshape_method: str = "no_sample",
        augment: bool = False,
        seed: int = 0,
    ):
        assert len(file_list) == len(labels)
        self.files = list(file_list)
        self.labels = list(labels)
        self.loader_type = loader_type
        self.slice_length = slice_length
        self.reshape_method = reshape_method
        self.augment = augment
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.files)

    def _event_tensor(self, idx: int) -> np.ndarray:
        raw = np.load(self.files[idx])["event_data"]
        if raw.dtype.names:  # structured
            ev = np.stack(
                [raw["x"], raw["y"], raw["t"], raw["p"].astype(np.int32)], axis=-1
            ).astype(np.float64)
        else:
            ev = raw.astype(np.float64)
        # polarity {0,1} -> {-1,1}
        p = ev[:, 3]
        ev[:, 3] = np.where(p > 0, 1, -1)
        if self.reshape_method == "sample":
            ev = reshape_event_with_sample(ev, SENSOR_H, SENSOR_W, IMAGE_H, IMAGE_W, self.rng)
        else:
            ev = reshape_event_no_sample(ev, SENSOR_H, SENSOR_W, IMAGE_H, IMAGE_W)
        ev = slice_events_random(ev, self.slice_length, self.rng)
        if self.augment:
            ev = base_augment(ev, IMAGE_W, self.rng)
        ev[:, 0] = np.clip(ev[:, 0], 0, IMAGE_W - 1)
        ev[:, 1] = np.clip(ev[:, 1], 0, IMAGE_H - 1)
        return ev

    def __getitem__(self, idx: int) -> NImageNetSample:
        ev = self._event_tensor(idx)

        n = len(ev)
        out = np.zeros((4, self.slice_length), np.int32)
        t = ev[:, 2] - (ev[0, 2] if n else 0)
        out[0, :n] = np.clip(ev[:, 0], 0, IMAGE_W - 1).astype(np.int32)
        out[1, :n] = np.clip(ev[:, 1], 0, IMAGE_H - 1).astype(np.int32)
        out[2, :n] = t.astype(np.int64).astype(np.int32)
        out[3, :n] = ev[:, 3].astype(np.int32)
        return NImageNetSample(out, n, int(self.labels[idx]))

