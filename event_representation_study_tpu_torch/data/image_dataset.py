"""Image-folder training and validation data (the JAX package's
``data/image_dataset.py``; the reference's ``TrainValDataset`` role,
ev-YOLOv6/yolov6/data/datasets.py:49-420) for original image data.

Layout (YOLOv5/6 convention, datasets.py get_imgs_labels:244-380):

    root/images/{train,val,test}/*.{jpg,png,bmp,...}
    root/labels/{train,val,test}/<stem>.txt   # rows: cls cx cy w h (norm.)

As in the JAX package:
- the strong augmentation runs on the device: the loader letterboxes the
  tiles and plans mosaic / random_affine / flips / mixup on the host
  (``data/augment.py::plan_augment_batch``, the planner of the event path),
  and the train step's warp composes them (``ops/warp.py``, K3 in the
  separable executor);
- every batch is a square letterbox of ``img_size`` (no ``rect`` mode);
- ``cache_ram`` keeps decoded images in memory, and an ``img_info`` JSON
  cache of the original shapes is keyed on name and mtime
  (get_imgs_labels cache json, :255-296);
- the HSV jitter (data_augment.py:13-28) draws its gains once per source
  tile, where the reference draws once per composed output.

The loader assembles batches in a background thread, ``prefetch`` batches
ahead (2 by default, as ``data/loader.py::PREFETCH``). It does not advance
its epoch itself, as in the JAX package: each epoch shuffles with
``seed + epoch`` only when the caller calls :meth:`ImageBatchLoader.set_epoch`.
"""
from __future__ import annotations

import json
import pathlib
from typing import Iterator, List, NamedTuple, Optional

import numpy as np

from ..ops.image import letterbox_geometry, letterbox_labels
from ..parallel.train_step import Batch
from .loader import prefetched

IMG_SUFFIXES = {".jpg", ".jpeg", ".png", ".bmp", ".webp", ".tif", ".tiff"}


class ImageSample(NamedTuple):
    image: np.ndarray  # (h0, w0, 3) uint8 RGB
    labels: np.ndarray  # (max_labels, 5) [cls, cx, cy, w, h] normalized
    num_labels: int
    index: int


def _augment_hsv(img: np.ndarray, hgain: float, sgain: float, vgain: float,
                 rng: np.random.Generator) -> np.ndarray:
    """LUT HSV jitter, the gain/LUT recipe of data_augment.py:13-28 (RGB in
    and out here, BGR in the reference; the hue LUT does not depend on the
    channel order)."""
    if not (hgain or sgain or vgain):
        return img
    import cv2

    r = rng.uniform(-1, 1, 3) * [hgain, sgain, vgain] + 1
    hue, sat, val = cv2.split(cv2.cvtColor(img, cv2.COLOR_RGB2HSV))
    x = np.arange(0, 256, dtype=r.dtype)
    lut_hue = ((x * r[0]) % 180).astype(img.dtype)
    lut_sat = np.clip(x * r[1], 0, 255).astype(img.dtype)
    lut_val = np.clip(x * r[2], 0, 255).astype(img.dtype)
    im_hsv = cv2.merge((cv2.LUT(hue, lut_hue), cv2.LUT(sat, lut_sat), cv2.LUT(val, lut_val)))
    return cv2.cvtColor(im_hsv, cv2.COLOR_HSV2RGB)


class ImageFolderDataset:
    """Indexable image + label store (the data half of TrainValDataset)."""

    def __init__(self, root, task: str = "train", img_size: int = 640,
                 max_labels: int = 32, cache_ram: bool = False,
                 class_names: Optional[List[str]] = None):
        root = pathlib.Path(root)
        img_dir = root / "images" / task
        lab_dir = root / "labels" / task
        if not img_dir.is_dir():
            raise FileNotFoundError(f"no image dir {img_dir}")
        self.img_paths = sorted(p for p in img_dir.iterdir() if p.suffix.lower() in IMG_SUFFIXES)
        if not self.img_paths:
            raise FileNotFoundError(f"no images under {img_dir}")
        self.lab_dir = lab_dir
        self.img_size = img_size
        self.max_labels = max_labels
        self.cache_ram = cache_ram
        self._ram: dict = {}
        self.classes = class_names or []
        # the model frame is the letterbox target: the Evaler's rep_hw and
        # scale-back are the identity at (img_size, img_size)
        self.height = self.width = img_size
        self._shape_cache = self._load_shape_cache(root, task)

    def _load_shape_cache(self, root, task):
        """The original shapes, cached as JSON keyed on name + mtime (the
        get_imgs_labels img_info cache, datasets.py:255-296), so that a
        label edit needs no re-scan."""
        cache = root / f".{task}_img_info.json"
        key = {p.name: p.stat().st_mtime for p in self.img_paths}
        if cache.exists():
            try:
                data = json.loads(cache.read_text())
                if data.get("key") == key:
                    return data["shapes"]
            except (OSError, ValueError):
                pass
        import cv2

        shapes = {}
        for p in self.img_paths:
            im = cv2.imread(str(p))
            if im is None:
                raise ValueError(f"unreadable image {p}")
            shapes[p.name] = list(im.shape[:2])
        try:
            cache.write_text(json.dumps({"key": key, "shapes": shapes}))
        except OSError:
            pass
        return shapes

    def __len__(self):
        return len(self.img_paths)

    def _decode(self, path: pathlib.Path) -> np.ndarray:
        if self.cache_ram and path.name in self._ram:
            return self._ram[path.name]
        import cv2

        im = cv2.imread(str(path))  # BGR
        img = np.ascontiguousarray(im[:, :, ::-1])  # RGB
        if self.cache_ram:
            self._ram[path.name] = img
        return img

    def _labels(self, path: pathlib.Path):
        txt = self.lab_dir / (path.stem + ".txt")
        out = np.zeros((self.max_labels, 5), np.float32)
        n = 0
        if txt.exists():
            rows = (np.atleast_2d(np.loadtxt(txt, dtype=np.float32, ndmin=2))
                    if txt.stat().st_size else np.zeros((0, 5), np.float32))
            n = min(len(rows), self.max_labels)
            out[:n] = rows[:n]
        return out, n

    def __getitem__(self, i: int) -> ImageSample:
        p = self.img_paths[i]
        labels, n = self._labels(p)
        return ImageSample(self._decode(p), labels, n, i)


def _letterbox_image_np(img: np.ndarray, new_shape: int, scaleup: bool = True) -> np.ndarray:
    """Host letterbox of one RGB image to (S, S, 3) float32 0..255, pad 114
    (data_augment.py letterbox, :31-63; the geometry of ``ops/image.py``)."""
    import cv2

    h0, w0 = img.shape[:2]
    r, (nh, nw), (dw, dh) = letterbox_geometry(h0, w0, new_shape, scaleup)
    resized = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
    out = np.full((new_shape, new_shape, 3), 114.0, np.float32)
    t, l = int(round(dh)), int(round(dw))
    out[t : t + nh, l : l + nw] = resized
    return out


class ImageBatchLoader:
    """Batches an :class:`ImageFolderDataset` into the train step's
    :class:`..parallel.train_step.Batch` (NumPy leaves).

    - ``hyp=None`` (val, or training without --augment): letterboxed,
      /255 model-ready images.
    - ``hyp`` given (--augment): 0..255 letterboxed tiles, plus
      ``partner_pool`` dataset-wide rows (the get_mosaic random-index role),
      with an AugPlan; the train step warps them on the device, divides by
      255 after composing and keeps the B labelled rows.
    """

    def __init__(self, dataset: ImageFolderDataset, batch_size: int,
                 img_size: int = 640, shuffle: bool = True, seed: int = 0,
                 drop_last: bool = True, hyp: Optional[dict] = None,
                 shard_id: int = 0, num_shards: int = 1,
                 partner_pool: int = 0, prefetch: int = 2):
        self.ds = dataset
        self.batch_size = batch_size
        self.img_size = img_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.hyp = dict(hyp) if hyp else None
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.partner_pool = partner_pool if hyp else 0
        self.prefetch = prefetch
        self.epoch = 0
        self._aug_rng = np.random.default_rng(seed + 7919)

    def __len__(self):
        n = len(self.ds) // self.num_shards
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _indices(self):
        idx = np.arange(len(self.ds))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        return idx[self.shard_id :: self.num_shards]

    def _abs_labels(self, s: ImageSample):
        h0, w0 = s.image.shape[:2]
        return letterbox_labels(s.labels[: s.num_labels], h0, w0, self.img_size,
                                scaleup=self.hyp is not None)

    def _make_batch(self, indices):
        samples = [self.ds[int(i)] for i in indices]
        S = self.img_size

        if self.hyp is None:
            imgs = np.stack([_letterbox_image_np(s.image, S, scaleup=False)
                             for s in samples]) / 255.0
            cap = self.ds.max_labels
            lab = np.zeros((len(samples), cap, 5), np.float32)
            for bi, s in enumerate(samples):
                al = self._abs_labels(s)
                lab[bi, : len(al)] = al
            nl = np.array([s.num_labels for s in samples], np.int32)
            mask = np.arange(cap)[None, :] < nl[:, None]
            return Batch(
                images=imgs.astype(np.float32),
                events=None,
                gt_labels=lab[..., 0].astype(np.int32),
                gt_bboxes=lab[..., 1:5].astype(np.float32),
                gt_mask=mask.astype(np.float32),
            ), np.array([s.index for s in samples])

        from ..ops.warp import AugPlan
        from .augment import plan_augment_batch

        n_out = len(samples)
        if self.partner_pool > 0:
            extra_idx = self._aug_rng.integers(len(self.ds), size=self.partner_pool)
            samples = samples + [self.ds[int(i)] for i in extra_idx]

        hsv = (self.hyp.get("hsv_h", 0.0), self.hyp.get("hsv_s", 0.0),
               self.hyp.get("hsv_v", 0.0))
        tiles, abs_labels = [], []
        for s in samples:
            img = s.image
            if any(hsv):
                img = _augment_hsv(img, *hsv, rng=self._aug_rng)
            tiles.append(_letterbox_image_np(img, S, scaleup=True))
            abs_labels.append(self._abs_labels(s))
        imgs = np.stack(tiles)  # (B + pool, S, S, 3) float32 0..255

        cap = self.ds.max_labels
        cap *= 4 if self.hyp.get("mosaic", 0.0) > 0 else 1
        cap *= 2 if self.hyp.get("mixup", 0.0) > 0 else 1
        plan, labels, nl = plan_augment_batch(abs_labels, S, self.hyp, self._aug_rng, cap,
                                              n_out=n_out)
        mask = np.arange(cap)[None, :] < nl[:, None]
        return Batch(
            images=imgs.astype(np.float32),
            events=None,
            gt_labels=labels[..., 0].astype(np.int32),
            gt_bboxes=labels[..., 1:5].astype(np.float32),
            gt_mask=mask.astype(np.float32),
            aug=AugPlan(**plan),
        ), np.array([s.index for s in samples[:n_out]])

    def _selections(self):
        indices = self._indices()
        for b in range(len(self)):
            sel = indices[b * self.batch_size : (b + 1) * self.batch_size]
            if len(sel) == 0:
                return
            yield sel

    def __iter__(self) -> Iterator:
        return prefetched(self._make_batch, list(self._selections()), self.prefetch)


def write_image_folder(root, n: int = 8, seed: int = 0, h_range=(80, 140),
                       w_range=(100, 160), tasks=("train", "val")) -> dict:
    """A synthetic image folder for tests and smoke runs: per task, ``n``
    PNGs of sizes drawn from ``h_range`` x ``w_range``, each a flat
    background with one coloured box labelled class 0, and the last image of
    each task background only (an empty label file). Returns
    {stem: (h0, w0, x1, y1, bw, bh)}."""
    import cv2

    root = pathlib.Path(root)
    rng = np.random.default_rng(seed)
    boxes = {}
    for task in tasks:
        (root / "images" / task).mkdir(parents=True, exist_ok=True)
        (root / "labels" / task).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            h0 = int(rng.integers(*h_range))
            w0 = int(rng.integers(*w_range))
            img = np.full((h0, w0, 3), 40, np.uint8)
            bw, bh = int(w0 * 0.4), int(h0 * 0.35)
            x1 = int(rng.integers(0, w0 - bw))
            y1 = int(rng.integers(0, h0 - bh))
            img[y1 : y1 + bh, x1 : x1 + bw] = (220, 60, 60)
            name = f"{task}_{i:03d}"
            if not cv2.imwrite(str(root / "images" / task / f"{name}.png"), img[:, :, ::-1]):
                raise OSError(f"cv2 could not write {name}.png")
            cx, cy = (x1 + bw / 2) / w0, (y1 + bh / 2) / h0
            lab = f"0 {cx:.6f} {cy:.6f} {bw / w0:.6f} {bh / h0:.6f}\n"
            if i == n - 1:
                lab = ""  # one background-only image
            (root / "labels" / task / f"{name}.txt").write_text(lab)
            boxes[name] = (h0, w0, x1, y1, bw, bh)
    return boxes
