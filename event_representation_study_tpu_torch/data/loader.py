"""Batched, prefetching host loader (the JAX package's
``data/loader.py::EventBatchLoader``).

Replaces the reference's 8-worker torch DataLoader + infinite _RepeatSampler
(ev-YOLOv6/yolov6/data/data_load.py:107-164) and the DistributedSampler
(:115-117): a background thread assembles fixed-shape NumPy batches while
the device computes; ``shard_id``/``num_shards`` stride the index stream
per process. The representation is not built here (it runs on the device),
so batch assembly is slicing, stacking and the host half of augmentation.

Batches are :class:`..parallel.train_step.Batch` with NumPy leaves, events
in the compact wire dtypes (:meth:`EventBatchLoader._wire_block`); the
train and eval steps move them and upcast once
(``parallel/train_step.py::batch_on_device``).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np

from ..events.core import EventBlock
from ..ops.image import letterbox_labels
from ..ops.warp import AugPlan
from ..parallel.train_step import Batch
from .augment import apply_event_affine, plan_augment_batch, plan_event_affine
from .gen1 import Gen1H5

PREFETCH = 2  # batches assembled ahead of the consumer


class EventBatchLoader:
    def __init__(
        self,
        dataset: Gen1H5,
        batch_size: int,
        img_size: int = 640,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        shard_id: int = 0,
        num_shards: int = 1,
        flipud: float = 0.0,
        fliplr: float = 0.0,
        hyp: Optional[dict] = None,
        partner_pool: int = 0,
    ):
        """``flipud``/``fliplr`` enable the reference's geometric flip
        augmentation (gen1_2yolo.py:210-228) applied jointly to the event
        window and the normalized labels before the representation builds
        on the device.

        ``hyp`` enables the strong-augment recipe (the reference's --augment
        path, gen1_2yolo.py:365-390 + data_augment.py). With mosaic or mixup
        on, the loader plans mosaic/random_affine/flips/mixup geometry and
        labels on the host and ships an :class:`AugPlan` the train step
        executes on the device; with both off (after the trainer's stop-aug
        boundary, which zeroes ``hyp['mosaic']``/``hyp['mixup']`` in place)
        it moves the events through the affine + flips here. With ``hyp``
        set the ``flipud``/``fliplr`` args are ignored.

        ``partner_pool`` (strong aug only): number of extra dataset-wide
        samples appended to each batch as mosaic/mixup partners (the
        reference draws partners from random dataset indices). The event
        block then has B + partner_pool rows; the train step emits the
        first B."""
        self.ds = dataset
        self.batch_size = batch_size
        self.img_size = img_size
        self.flipud = flipud
        self.fliplr = fliplr
        self.hyp = dict(hyp) if hyp else None
        self.partner_pool = int(partner_pool)
        self._aug_rng = np.random.default_rng(seed + 777)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.epoch = 0

    def __len__(self):
        n = len(self.ds) // self.num_shards
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _indices(self):
        idx = np.arange(len(self.ds))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        return idx[self.shard_id :: self.num_shards]

    @staticmethod
    def _wire_block(ev, num) -> EventBlock:
        """Compact wire dtypes (x/y int16, t int32, p int8: 9 B an event
        instead of 16): sensor coordinates (Gen1 304x240, 1Mpx 1280x720)
        fit int16. The upcast to int32 happens once, on the device
        (``EventBlock.as_int32``)."""
        return EventBlock(
            x=ev[:, 0].astype(np.int16),
            y=ev[:, 1].astype(np.int16),
            t=ev[:, 2].astype(np.int32),
            p=ev[:, 3].astype(np.int8),
            num=np.asarray(num, np.int32),
        )

    def _letterboxed(self, s):
        return letterbox_labels(s.labels[: s.num_labels], self.ds.height, self.ds.width,
                                self.img_size)

    def _make_batch(self, indices):
        """(Batch, dataset indices of its rows) in host NumPy."""
        samples = [self.ds[int(i)] for i in indices]
        ev = np.stack([s.events for s in samples])  # (B, 4, N)

        if self.hyp is not None:
            abs_labels = [self._letterboxed(s) for s in samples]
            strong = self.hyp.get("mosaic", 0.0) > 0 or self.hyp.get("mixup", 0.0) > 0
            if not strong:
                # event-space affine + flips, the reference's Gen1 recipe
                # (gen1_2yolo.py:365-390 has no mosaic), on the host
                cap = samples[0].labels.shape[0]
                maps, labels, nl = plan_event_affine(
                    abs_labels, self.img_size, self.hyp, self._aug_rng, cap
                )
                num = np.zeros(len(samples), np.int32)
                for bi, s in enumerate(samples):
                    n = s.num_events
                    xs, ys, keep = apply_event_affine(
                        ev[bi, 0], ev[bi, 1], n, maps[bi],
                        self.ds.height, self.ds.width, self.img_size,
                    )
                    m = len(xs)
                    t_k = ev[bi, 2, :n][keep]
                    p_k = ev[bi, 3, :n][keep]
                    ev[bi, :, :] = 0
                    ev[bi, 0, :m] = xs
                    ev[bi, 1, :m] = ys
                    ev[bi, 2, :m] = t_k
                    ev[bi, 3, :m] = p_k
                    num[bi] = m
                mask = np.arange(cap)[None, :] < nl[:, None]
                return Batch(
                    images=None,
                    events=self._wire_block(ev, num),
                    gt_labels=labels[..., 0].astype(np.int32),
                    gt_bboxes=labels[..., 1:5].astype(np.float32),
                    gt_mask=mask.astype(np.float32),
                ), np.array([s.index for s in samples])

            n_out = len(samples)
            if self.partner_pool > 0:
                # dataset-wide partner pool: extra samples appended to the
                # event block, never emitted
                extra_idx = self._aug_rng.integers(len(self.ds), size=self.partner_pool)
                extras = [self.ds[int(i)] for i in extra_idx]
                samples = samples + extras
                ev = np.concatenate([ev, np.stack([s.events for s in extras])])
                abs_labels = abs_labels + [self._letterboxed(s) for s in extras]
            num = np.array([s.num_events for s in samples], np.int32)
            cap = samples[0].labels.shape[0]
            cap *= 4 if self.hyp.get("mosaic", 0.0) > 0 else 1
            cap *= 2 if self.hyp.get("mixup", 0.0) > 0 else 1
            plan, labels, nl = plan_augment_batch(
                abs_labels, self.img_size, self.hyp, self._aug_rng, cap, n_out=n_out,
            )
            mask = np.arange(cap)[None, :] < nl[:, None]
            return Batch(
                images=None,
                events=self._wire_block(ev, num),
                gt_labels=labels[..., 0].astype(np.int32),
                gt_bboxes=labels[..., 1:5].astype(np.float32),
                gt_mask=mask.astype(np.float32),
                aug=AugPlan(**plan),
            ), np.array([s.index for s in samples[:n_out]])

        labels_aug = []
        for bi, s in enumerate(samples):
            lab = s.labels.copy()
            n = s.num_events
            if self.fliplr and self._aug_rng.random() < self.fliplr:
                ev[bi, 0, :n] = self.ds.width - 1 - ev[bi, 0, :n]
                lab[: s.num_labels, 1] = 1 - lab[: s.num_labels, 1]
            if self.flipud and self._aug_rng.random() < self.flipud:
                ev[bi, 1, :n] = self.ds.height - 1 - ev[bi, 1, :n]
                lab[: s.num_labels, 2] = 1 - lab[: s.num_labels, 2]
            labels_aug.append(lab)
        num = np.array([s.num_events for s in samples], np.int32)
        labels = np.stack(labels_aug)  # (B, M, 5)
        nl = np.array([s.num_labels for s in samples], np.int32)
        mask = np.arange(labels.shape[1])[None, :] < nl[:, None]
        # normalized cxcywh -> absolute xyxy in the letterboxed model frame
        # (the label path of gen1_2yolo.py:348-362)
        lb = np.stack([
            letterbox_labels(l, self.ds.height, self.ds.width, self.img_size)
            for l in labels
        ])
        return Batch(
            images=None,
            events=self._wire_block(ev, num),
            gt_labels=labels[..., 0].astype(np.int32),
            gt_bboxes=lb[..., 1:5].astype(np.float32),
            gt_mask=mask.astype(np.float32),
        ), np.array([s.index for s in samples])

    def __iter__(self) -> Iterator:
        indices = self._indices()
        nb = len(self)
        q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        stop = object()
        # a consumer that abandons the iterator mid-epoch (early break,
        # generator close) must not strand the worker on a full queue: every
        # put is bounded and checks the cancellation flag
        cancelled = threading.Event()

        def _put(item) -> bool:
            while not cancelled.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for b in range(nb):
                    sel = indices[b * self.batch_size : (b + 1) * self.batch_size]
                    if len(sel) < self.batch_size and self.drop_last:
                        break
                    if not _put(self._make_batch(sel)):
                        return
            except Exception as e:  # handed to the consumer, which re-raises
                _put(e)
                return
            _put(stop)

        th = threading.Thread(target=worker, daemon=True)
        th.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
            self.epoch += 1
        finally:
            cancelled.set()
            th.join(timeout=10)
