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

:meth:`NImageNetDataset.batch` assembles a batch of at least two samples
a worker on the process's pool of worker processes, in two phases: each
worker reads, decodes and stages its samples (sample k is worker k mod
W's) and returns their lengths; the calling thread takes every random
draw in sample order (the draws depend on lengths alone); each worker then
finishes its samples into their rows of a shared-memory buffer. Smaller
batches, and a process with one core, run inline.
"""
from __future__ import annotations

import atexit
import dataclasses
import mmap
import multiprocessing
import os
import pathlib
import pickle
import signal
import threading
import traceback
from multiprocessing import reduction
from typing import Optional, Sequence, Tuple

import numpy as np

# numpy alone at import: the worker processes import this module and so
# start without torch; the step thread's spans import it at a batch

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


# the 8-core H100 host: 4 / 6 / 8 workers trained 245 / 325 / 356 samples/s on
# nimagenet_resnet34.train, 8 the most (PERF.md §6)
MAX_POOL_WIDTH = 8


def pool_width() -> int:
    """Worker processes of the batch pool: the cores this process may run
    on, at most :data:`MAX_POOL_WIDTH`. The step thread only waits while a
    batch is assembled, so the pool takes every core."""
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


@dataclasses.dataclass(frozen=True)
class Recipe:
    """A sample's work apart from its draws, with the frame as it was when
    the batch began. It pickles, so a worker process does the work as the
    dataset's own thread would."""
    reshape_method: str
    slice_length: int
    image_hw: Tuple[int, int]
    loader: Optional[str] = None  # a host loader's name: the sample ends as its image

    def staged(self, path) -> np.ndarray:
        """The file's events as an (N, 4) array of x, y, t, p up to the
        sample's first draw: float64, polarity {0,1} -> {-1,1}, reshaped
        unless the reshape draws."""
        with np.load(path) as npz:
            raw = npz["event_data"]
        if raw.dtype.names:  # structured
            raw = np.stack([raw["x"], raw["y"], raw["t"], raw["p"].astype(np.int32)], axis=-1)
        ev = raw.astype(np.float64)
        p = ev[:, 3]
        ev[:, 3] = np.where(p > 0, 1, -1)
        h, w = self.image_hw
        if self.reshape_method == "unique":
            from .nimagenet_loaders import reshape_event_unique

            ev = reshape_event_unique(ev, SENSOR_H, SENSOR_W, h, w)
        elif self.reshape_method != "sample":
            ev = reshape_event_no_sample(ev, SENSOR_H, SENSOR_W, h, w)
        return ev

    def prepped(self, ev: np.ndarray, plan: SamplePlan) -> np.ndarray:
        """The staged events through ``plan``: the ``sample`` reshape, the
        slice, the augment, the clip to the frame."""
        h, w = self.image_hw
        if plan.rows is not None:
            ev = reshape_event_no_sample(ev[plan.rows], SENSOR_H, SENSOR_W, h, w)
        if plan.start is not None:
            ev = ev[plan.start : plan.start + self.slice_length]
        if plan.augment is not None:
            ev = augment_with(ev, plan.augment, w, h)
        ev[:, 0] = np.clip(ev[:, 0], 0, w - 1)
        ev[:, 1] = np.clip(ev[:, 1], 0, h - 1)
        return ev

    def finished(self, ev: np.ndarray, row: Optional[np.ndarray]):
        """The host loader's image of the prepped events, or their count
        once packed as int32 into ``row`` (``(4, slice_length)``; zeros past
        the count)."""
        if self.loader is not None:
            from .nimagenet_loaders import HOST_LOADERS

            return HOST_LOADERS[self.loader](ev)
        h, w = self.image_hw
        n = len(ev)
        t = ev[:, 2] - (ev[0, 2] if n else 0)
        row[0, :n] = np.clip(ev[:, 0], 0, w - 1).astype(np.int32)
        row[1, :n] = np.clip(ev[:, 1], 0, h - 1).astype(np.int32)
        row[2, :n] = t.astype(np.int64).astype(np.int32)
        row[3, :n] = ev[:, 3].astype(np.int32)
        row[:, n:] = 0
        return n


def _serve(conn) -> None:
    """A worker process's loop. It takes the shared buffer's descriptor,
    then one message a phase: ``("stage", recipe, [(k, path), ...],
    None)`` stages those samples and keeps them, replying their lengths;
    ``("finish", recipe, [(k, plan), ...], shape)`` finishes the kept
    samples, packing events into rows ``k`` of the buffer seen as
    ``shape`` (None for images), replying the counts or images. A reply is
    ``(results, failure)``, ``failure`` None or ``(k, exception,
    traceback)`` for the sample that raised. It ends on None or when the
    parent is gone."""
    signal.signal(signal.SIGINT, signal.SIG_IGN)  # the parent handles an interrupt
    fd = reduction.recv_handle(conn)
    mapped, kept = None, {}
    while True:
        try:
            message = conn.recv()
        except EOFError:
            return
        if message is None:
            return
        kind, recipe, jobs, shape = message
        results, failure = [], None
        try:
            if kind == "stage":
                kept = {}
                for k, path in jobs:
                    kept[k] = recipe.staged(path)
                    results.append(len(kept[k]))
            else:
                rows = None
                if shape is not None:
                    size = int(np.prod(shape))
                    if mapped is None or len(mapped) < 4 * size:
                        mapped = mmap.mmap(fd, 4 * size)
                    rows = np.frombuffer(mapped, np.int32, size).reshape(shape)
                for k, plan in jobs:
                    results.append(recipe.finished(recipe.prepped(kept.pop(k), plan),
                                                   None if rows is None else rows[k]))
                del rows  # no view may pin a mapping that the next batch replaces
        except Exception as exc:  # sent to the caller, who raises it
            try:
                pickle.dumps(exc)
            except Exception:
                exc = RuntimeError(f"{type(exc).__name__}: {exc}")
            failure = (jobs[len(results)][0], exc, traceback.format_exc())
        conn.send((results, failure))


class _Workers:
    """``width`` worker processes (``spawn``: never a fork of a process
    with CUDA and threads up; they never touch CUDA), each on its own
    pipe, and one buffer of shared memory that every worker maps, an
    anonymous file (``memfd``) grown to the largest batch: its rows take
    the batch's events. Sample k of a batch is worker k mod ``width``'s in
    both phases."""

    def __init__(self, width: int):
        ctx = multiprocessing.get_context("spawn")
        self.lock = threading.Lock()  # one batch at a time on the pipes
        self.fd = os.memfd_create("nimagenet-batch")
        self.buffer: Optional[mmap.mmap] = None
        self.conns, self.procs = [], []
        for _ in range(width):  # started, not waited on: a worker's imports run beside the caller
            mine, theirs = ctx.Pipe()
            proc = ctx.Process(target=_serve, args=(theirs,), name="nimagenet-worker",
                               daemon=True)
            proc.start()
            theirs.close()
            reduction.send_handle(mine, self.fd, proc.pid)
            self.conns.append(mine)
            self.procs.append(proc)

    def assembled(self, recipe: Recipe, paths: Sequence[str], plan_of) -> tuple:
        """The samples at ``paths`` through ``recipe``, the draws
        ``plan_of(length)`` taken here in sample order between the phases:
        the events ``(B, 4, slice_length)`` int32 (the caller's own copy)
        and the counts, or None and the images."""
        from ..utils.profiling import span

        width, b = len(self.conns), len(paths)
        mine = [range(w, b, width) for w in range(width)]
        with self.lock:
            with span("nimagenet/decode"):
                lengths = self._exchange(mine, [("stage", recipe, [(k, paths[k]) for k in ks], None)
                                                for ks in mine])
            with span("nimagenet/prep"):
                plans = [plan_of(n) for n in lengths]
                shape = None if recipe.loader is not None else (b, 4, recipe.slice_length)
                rows = None if shape is None else self._rows(shape)
                results = self._exchange(mine, [("finish", recipe, [(k, plans[k]) for k in ks], shape)
                                                 for ks in mine])
                return (None if rows is None else rows.copy()), results

    def _rows(self, shape) -> np.ndarray:
        """The shared buffer as an int32 array of ``shape``, grown to fit."""
        size = int(np.prod(shape))
        if self.buffer is None or len(self.buffer) < 4 * size:
            os.ftruncate(self.fd, 4 * size)
            self.buffer = mmap.mmap(self.fd, 4 * size)
        return np.frombuffer(self.buffer, np.int32, size).reshape(shape)

    def _exchange(self, mine, messages) -> list:
        """Each worker's message sent and every reply taken: the results in
        sample order, or the exception of the first sample that raised,
        once all workers have replied."""
        try:
            for conn, message in zip(self.conns, messages):
                conn.send(message)
            replies = [conn.recv() for conn in self.conns]
        except BaseException as exc:  # a worker lost, or an interrupt between send and reply
            self.close()
            if isinstance(exc, (EOFError, OSError)):
                raise RuntimeError("a nimagenet worker process ended mid-batch") from exc
            raise
        out, failures = [None] * sum(map(len, mine)), []
        for ks, (results, failure) in zip(mine, replies):
            for k, result in zip(ks, results):
                out[k] = result
            if failure is not None:
                failures.append(failure)
        if failures:
            k, exc, trace = min(failures, key=lambda f: f[0])
            exc.add_note(f"raised in a nimagenet worker process:\n{trace}")
            raise exc
        return out

    def close(self) -> None:
        """Stop every worker and release the buffer."""
        for conn in self.conns:
            try:
                conn.send(None)
            except OSError:
                pass
            conn.close()
        for proc in self.procs:
            proc.join(timeout=10)
            if proc.is_alive():
                proc.kill()
                proc.join()
        self.conns, self.procs, self.buffer = [], [], None
        if self.fd >= 0:
            os.close(self.fd)
            self.fd = -1


_POOL: Optional[_Workers] = None  # the process's one pool, shared by every dataset
_POOL_LOCK = threading.Lock()


def _pool_for(batch: int) -> Optional[_Workers]:
    """The worker pool where a batch of ``batch`` samples takes it (at
    least two samples a worker, more than one core), started by the first
    such batch; None runs the batch on the caller's thread."""
    global _POOL
    width = pool_width()
    if width < 2 or batch < 2 * width:
        return None
    with _POOL_LOCK:
        if _POOL is not None and len(_POOL.procs) != width:
            _POOL.close()
            _POOL = None
        if _POOL is None:
            _POOL = _Workers(width)
        return _POOL


def shutdown_pool() -> None:
    """Stop the worker pool, if one runs (also at the interpreter's exit);
    the next batch that takes it starts a new one."""
    global _POOL
    with _POOL_LOCK:
        if _POOL is not None:
            _POOL.close()
            _POOL = None


atexit.register(shutdown_pool)


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

    def _recipe(self, loader: Optional[str] = None) -> Recipe:
        return Recipe(self.reshape_method, self.slice_length, (IMAGE_H, IMAGE_W), loader)

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

    def _assembled(self, indices, loader: Optional[str] = None) -> tuple:
        """The samples ``indices`` through :class:`Recipe`: the events
        ``(B, 4, slice_length)`` int32 and the counts, or (a ``loader``)
        None and the images. A batch the pool takes (:func:`_pool_for`)
        is staged and finished on the worker processes, any other on this
        thread; either way every draw is taken here in sample order
        (:meth:`_plan`), between staging and finishing. The spans are this
        thread's wall time on each phase."""
        from ..utils.profiling import count, span

        paths = [self.files[int(i)] for i in indices]
        recipe = self._recipe(loader)
        pool = _pool_for(len(paths))
        with span("nimagenet/batch"):
            if pool is not None:
                out = pool.assembled(recipe, paths, self._plan)
                count("nimagenet/worker_samples", len(paths))
                return out
            with span("nimagenet/decode"):
                staged = [recipe.staged(path) for path in paths]
            with span("nimagenet/prep"):
                plans = [self._plan(len(ev)) for ev in staged]
                rows = None if loader is not None else np.zeros(
                    (len(paths), 4, self.slice_length), np.int32)
                return rows, [recipe.finished(recipe.prepped(ev, plan), None if rows is None else rows[k])
                              for k, (ev, plan) in enumerate(zip(staged, plans))]

    def batch(self, indices) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The samples ``indices`` as one batch: events ``(B, 4,
        slice_length)`` int32, counts ``(B,)`` int32, labels ``(B,)``
        int64, equal to ``self[i]`` one after another, and leaving
        ``self.rng`` where they leave it. The arrays are the caller's own."""
        events, num = self._assembled(indices)
        return (events, np.array(num, np.int32),
                np.array([self.labels[int(i)] for i in indices], np.int64))

    def host_images(self, indices) -> np.ndarray:
        """Prebuilt ``(B, H, W, C)`` images of the samples ``indices`` via
        the original aggregation fns, as :meth:`batch` assembles events."""
        return np.stack(self._assembled(indices, self.loader_type)[1])

    def _event_tensor(self, idx: int) -> np.ndarray:
        """Sample ``idx``'s float64 (N, 4) events before the int32 packing."""
        recipe = self._recipe()
        ev = recipe.staged(self.files[idx])
        return recipe.prepped(ev, self._plan(len(ev)))

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
