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

:meth:`NImageNetDataset.batch` assembles a batch on the dataset's thread
pool (zlib's inflate and NumPy's whole-array work release the GIL): each
file is decoded on the pool, every random draw is taken on the caller in
sample order (the draws depend on lengths alone), and the rest of each
sample runs on the pool into its row of the batch.
"""
from __future__ import annotations

import dataclasses
import os
import pathlib
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils.profiling import span

SENSOR_H, SENSOR_W = 480, 640
IMAGE_H, IMAGE_W = 224, 224

LOADER_TO_REP = {
    "reshape_then_voxel_grid": "ToVoxelGrid",
    "reshape_then_optimized": "OptimizedRepresentation",
    "reshape_then_event_stack": "EventStack",
    "reshape_then_to_image": "ToImage",
    "reshape_then_tore": "TORE",
    "reshape_then_time_surface": "ToTimesurface",
}


def reshape_event_no_sample(ev: np.ndarray, orig_h, orig_w, new_h, new_w):
    """Coordinate rescale (imagenet.py:105-109)."""
    out = ev.astype(np.float64).copy()
    out[:, 0] *= new_w / orig_w
    out[:, 1] *= new_h / orig_h
    return out


def sample_rows(n: int, orig_h, orig_w, new_h, new_w, rng) -> np.ndarray:
    """The sorted rows of ``n`` events that the ``sample`` reshape keeps: a
    share of the area ratio, then rescaled by :func:`reshape_event_no_sample`
    (imagenet.py:87-103)."""
    ratio = (new_h * new_w) / (orig_h * orig_w)
    return np.sort(rng.choice(n, size=int(ratio * n), replace=False))


def slice_start(n: int, length: int, rng) -> Optional[int]:
    """The first event of the random fixed-length window over ``n`` events,
    or None when all fit (imagenet.py:60-84, slice_method=random)."""
    return None if n <= length else rng.integers(0, n - length)


def augment_draws(rng) -> Tuple[bool, bool, np.ndarray]:
    """The draws of :func:`augment_with` in the reference's order: the time
    flip, the x flip, the (x, y) shift."""
    return rng.random() < 0.5, rng.random() < 0.5, rng.integers(-20, 21, 2)


def augment_with(ev, draws, new_w: int, new_h: int = None):
    """The reference's train-mode event augmentation (imagenet.py:1140-1191
    base_augment) with its draws given (:func:`augment_draws`): random time
    flip (reverse order, t -> t_max - t, invert polarity), random x flip,
    then a +-20 px shift that DROPS events landing outside the frame (not a
    clip)."""
    new_h = IMAGE_H if new_h is None else new_h
    time_flip, x_flip, shift = draws
    ev = ev.copy()
    if time_flip:  # random_time_flip (:1166-1173)
        ev = ev[::-1].copy()
        ev[:, 2] = ev[0, 2] - ev[:, 2]
        ev[:, 3] = -ev[:, 3]
    if x_flip:  # random_flip_events_along_x (:1157-1163)
        ev[:, 0] = new_w - 1 - ev[:, 0]
    ev[:, 0] += shift[0]  # random_shift_events (:1140-1154)
    ev[:, 1] += shift[1]
    keep = (
        (ev[:, 0] >= 0) & (ev[:, 0] < new_w)
        & (ev[:, 1] >= 0) & (ev[:, 1] < new_h)
    )
    return ev[keep]


MAX_POOL_WIDTH = 4  # wider pools built no batch faster on an 8-core H100 host (PERF.md §6)


def pool_width() -> int:
    """Threads of a dataset's pool: the cores this process may run on, at
    most :data:`MAX_POOL_WIDTH` (the GIL-holding parts of a sample gain
    nothing from more threads); with one core a batch runs inline."""
    cores = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else os.cpu_count()
    return min(cores or 1, MAX_POOL_WIDTH)


@dataclasses.dataclass(frozen=True)
class SamplePlan:
    """Every random draw of one sample: the rows the ``sample`` reshape
    keeps, the slice's first event, the augment's draws (None where the
    step takes none)."""
    rows: Optional[np.ndarray]
    start: Optional[int]
    augment: Optional[Tuple[bool, bool, np.ndarray]]


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
        self._pool: Optional[ThreadPoolExecutor] = None  # made by the first batch

    def __len__(self):
        return len(self.files)

    @property
    def representation(self) -> Optional[str]:
        """Device representation name, or None when the loader type is one
        of the original host aggregation functions (nimagenet_loaders.py) —
        then __getitem__ serves prebuilt images."""
        if self.loader_type in LOADER_TO_REP:
            return LOADER_TO_REP[self.loader_type]
        from .nimagenet_loaders import HOST_LOADERS

        if self.loader_type in HOST_LOADERS:
            return None
        raise ValueError(f"unknown loader_type: {self.loader_type}")

    @property
    def channels(self) -> int:
        if self.representation is not None:
            # by the dispatcher's name rules: the JAX package looks the name
            # up in REPRESENTATION_CHANNELS, where ToVoxelGrid, ToImage and
            # ToTimesurface are missing (KeyError)
            from ..reps.dispatch import representation_channels

            return representation_channels(self.representation)
        from .nimagenet_loaders import LOADER_CHANNELS

        return LOADER_CHANNELS[self.loader_type]

    def _decoded(self, idx: int) -> np.ndarray:
        """Sample ``idx``'s file as an (N, 4) array of x, y, t, p."""
        with np.load(self.files[idx]) as npz:
            raw = npz["event_data"]
        if raw.dtype.names:  # structured
            raw = np.stack([raw["x"], raw["y"], raw["t"], raw["p"].astype(np.int32)], axis=-1)
        return raw

    def _staged(self, raw: np.ndarray) -> np.ndarray:
        """Decoded events up to the sample's first draw: float64, polarity
        {0,1} -> {-1,1}, reshaped unless the reshape draws."""
        ev = raw.astype(np.float64)
        p = ev[:, 3]
        ev[:, 3] = np.where(p > 0, 1, -1)
        if self.reshape_method == "unique":
            from .nimagenet_loaders import reshape_event_unique

            ev = reshape_event_unique(ev, SENSOR_H, SENSOR_W, IMAGE_H, IMAGE_W)
        elif self.reshape_method != "sample":
            ev = reshape_event_no_sample(ev, SENSOR_H, SENSOR_W, IMAGE_H, IMAGE_W)
        return ev

    def _plan(self, n: int) -> SamplePlan:
        """Every draw of a sample of ``n`` staged events from ``self.rng``,
        in the order of the steps that take them. The draws depend on
        lengths alone, so a batch takes them here, sample after sample,
        and leaves the generator where the samples one by one leave it."""
        rows = None
        if self.reshape_method == "sample":
            rows = sample_rows(n, SENSOR_H, SENSOR_W, IMAGE_H, IMAGE_W, self.rng)
            n = len(rows)
        start = slice_start(n, self.slice_length, self.rng)
        return SamplePlan(rows, start, augment_draws(self.rng) if self.augment else None)

    def _prepped(self, ev: np.ndarray, plan: SamplePlan) -> np.ndarray:
        """The staged events through ``plan``: the ``sample`` reshape, the
        slice, the augment, the clip to the frame."""
        if plan.rows is not None:
            ev = reshape_event_no_sample(ev[plan.rows], SENSOR_H, SENSOR_W, IMAGE_H, IMAGE_W)
        if plan.start is not None:
            ev = ev[plan.start : plan.start + self.slice_length]
        if plan.augment is not None:
            ev = augment_with(ev, plan.augment, IMAGE_W)
        ev[:, 0] = np.clip(ev[:, 0], 0, IMAGE_W - 1)
        ev[:, 1] = np.clip(ev[:, 1], 0, IMAGE_H - 1)
        return ev

    def _assembled(self, indices, finish) -> list:
        """``finish(k, events)`` of the k-th of ``indices`` after
        :meth:`_prepped`, in order. The files are decoded on the pool and
        staged on it; the draws are taken here in sample order
        (:meth:`_plan`); the rest runs on the pool again. The spans are the
        calling thread's wall time on each phase."""
        idx = [int(i) for i in indices]
        with span("nimagenet/batch"):
            with span("nimagenet/decode"):
                raw = self._map(self._decoded, idx)
            with span("nimagenet/prep"):
                staged = self._map(self._staged, raw)
                plans = [self._plan(len(ev)) for ev in staged]
                return self._map(lambda k, ev, plan: finish(k, self._prepped(ev, plan)),
                                 range(len(idx)), staged, plans)

    def _map(self, fn, *args) -> list:
        """``[fn(*a) for a in zip(*args)]``, on the dataset's thread pool
        (made at the first batch of two or more and kept) where there is
        more than one core. A worker's exception is raised here."""
        if len(args[0]) > 1 and self._pool is None and (width := pool_width()) > 1:
            self._pool = ThreadPoolExecutor(width, thread_name_prefix="nimagenet")
        if len(args[0]) <= 1 or self._pool is None:
            return list(map(fn, *args))
        return list(self._pool.map(fn, *args))

    def batch(self, indices) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The samples ``indices`` as one batch: events ``(B, 4,
        slice_length)`` int32, counts ``(B,)`` int32, labels ``(B,)``
        int64, equal to ``self[i]`` one after another, and leaving
        ``self.rng`` where they leave it."""
        out = np.zeros((len(indices), 4, self.slice_length), np.int32)

        def pack(k, ev):  # into row k
            n = len(ev)
            t = ev[:, 2] - (ev[0, 2] if n else 0)
            out[k, 0, :n] = np.clip(ev[:, 0], 0, IMAGE_W - 1).astype(np.int32)
            out[k, 1, :n] = np.clip(ev[:, 1], 0, IMAGE_H - 1).astype(np.int32)
            out[k, 2, :n] = t.astype(np.int64).astype(np.int32)
            out[k, 3, :n] = ev[:, 3].astype(np.int32)
            return n

        num = np.array(self._assembled(indices, pack), np.int32)
        return out, num, np.array([self.labels[int(i)] for i in indices], np.int64)

    def host_images(self, indices) -> np.ndarray:
        """Prebuilt ``(B, H, W, C)`` images of the samples ``indices`` via
        the original aggregation fns, as :meth:`batch` assembles events."""
        from .nimagenet_loaders import HOST_LOADERS

        build = HOST_LOADERS[self.loader_type]
        return np.stack(self._assembled(indices, lambda k, ev: build(ev)))

    def _event_tensor(self, idx: int) -> np.ndarray:
        """Sample ``idx``'s float64 (N, 4) events before the int32 packing."""
        return self._assembled([idx], lambda k, ev: ev)[0]

    def host_image(self, idx: int) -> np.ndarray:
        """Prebuilt (H, W, C) image via the original aggregation fns."""
        return self.host_images([idx])[0]

    def __getitem__(self, idx: int) -> NImageNetSample:
        events, num, labels = self.batch([idx])
        return NImageNetSample(events[0], int(num[0]), int(labels[0]))


def write_nimagenet_fixture(root, num_classes=3, per_class=4, n_events=4000, seed=0):
    """Synthetic npz tree + file list for tests."""
    from ..events.fake import generate_fake_events

    root = pathlib.Path(root)
    files, labels = [], []
    k = 0
    for c in range(num_classes):
        d = root / f"n{c:08d}"
        d.mkdir(parents=True, exist_ok=True)
        for i in range(per_class):
            x, y, t, p = generate_fake_events(
                n_events, SENSOR_H, SENSOR_W, duration_us=100_000,
                seed=seed + k, structured=False,
            )
            ev = np.stack([x, y, t, (p > 0).astype(np.int64)], -1)
            path = d / f"s{i}.npz"
            np.savez(path, event_data=ev)
            files.append(str(path))
            labels.append(c)
            k += 1
    return files, labels
