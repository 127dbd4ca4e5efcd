"""Strong-augmentation planning on the host, in NumPy (a copy of the JAX
package's ``data/augment.py``): mosaic routing, random_affine matrices,
flips and mixup, with the label math done here and the pixel work left to
``ops/warp.py`` or ``reps/event_mosaic.py``; the event-space affine + flip
of the Gen1 recipe without mosaic (:func:`plan_event_affine`,
:func:`apply_event_affine`), which moves the events themselves on the host;
and the reference's per-image host transforms (:func:`random_affine` with
scipy's ``affine_transform`` in cv2.warpAffine's place, :func:`mixup`,
:func:`flip_augment`, :func:`mosaic_augmentation`), which no train path
calls: the device warp executes the same geometry.

The same ``np.random.Generator`` state gives the same plan and labels, bit
for bit, as the JAX package's planner.
"""
from __future__ import annotations

import math
import random
from typing import Optional, Sequence, Tuple

import numpy as np

from ..ops.image import letterbox_geometry

try:
    from scipy import ndimage as _ndi
except ImportError:  # pragma: no cover
    _ndi = None

PAD_VALUE = 114.0


def get_transform_matrix(img_shape, new_shape, degrees, scale, shear, translate,
                         rng: random.Random):
    """Random affine matrix (data_augment.py:153-185)."""
    new_h, new_w = new_shape
    C = np.eye(3)
    C[0, 2] = -img_shape[1] / 2
    C[1, 2] = -img_shape[0] / 2
    a = rng.uniform(-degrees, degrees)
    s = rng.uniform(1 - scale, 1 + scale)
    R = np.eye(3)
    rad = math.radians(a)
    R[0, 0], R[0, 1] = s * math.cos(rad), s * math.sin(rad)
    R[1, 0], R[1, 1] = -s * math.sin(rad), s * math.cos(rad)
    S = np.eye(3)
    S[0, 1] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    S[1, 0] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    T = np.eye(3)
    T[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * new_w
    T[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * new_h
    return T @ S @ R @ C, s


def box_candidates(box1, box2, wh_thr=2, ar_thr=20, area_thr=0.1, eps=1e-16):
    """Filter degenerate post-affine boxes (data_augment.py:96-108)."""
    w1, h1 = box1[2] - box1[0], box1[3] - box1[1]
    w2, h2 = box2[2] - box2[0], box2[3] - box2[1]
    ar = np.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return (w2 > wh_thr) & (h2 > wh_thr) & (w2 * h2 / (w1 * h1 + eps) > area_thr) & (ar < ar_thr)


def transform_labels(labels: np.ndarray, M: np.ndarray, s: float,
                     width: int, height: int) -> np.ndarray:
    """The label half of random_affine (data_augment.py:128-151): map box
    corners through M, re-box, clip, drop degenerate candidates."""
    n = len(labels)
    if not n:
        return labels.reshape(0, 5)
    labels = labels.copy()
    xy = np.ones((n * 4, 3))
    xy[:, :2] = labels[:, [1, 2, 3, 4, 1, 4, 3, 2]].reshape(n * 4, 2)
    xy = (xy @ M.T)[:, :2].reshape(n, 8)
    x = xy[:, [0, 2, 4, 6]]
    y = xy[:, [1, 3, 5, 7]]
    new = np.stack([x.min(1), y.min(1), x.max(1), y.max(1)], axis=1)
    new[:, [0, 2]] = new[:, [0, 2]].clip(0, width)
    new[:, [1, 3]] = new[:, [1, 3]].clip(0, height)
    keep = box_candidates(labels[:, 1:5].T * s, new.T, area_thr=0.1)
    labels = labels[keep]
    labels[:, 1:5] = new[keep]
    return labels


def random_affine(img, labels, degrees, translate, scale, shear,
                  new_shape: Tuple[int, int], rng: Optional[random.Random] = None):
    """img (H, W, C) float, labels (N, 5) [cls, x1, y1, x2, y2] absolute."""
    rng = rng or random
    height, width = new_shape
    M, s = get_transform_matrix(img.shape[:2], new_shape, degrees, scale, shear,
                                translate, rng)
    if not np.allclose(M, np.eye(3)):
        if _ndi is not None:
            inv = np.linalg.inv(M)
            # M is in (x, y) convention; scipy indexes (row=y, col=x)
            mat = np.array([[inv[1, 1], inv[1, 0]], [inv[0, 1], inv[0, 0]]])
            off = np.array([inv[1, 2], inv[0, 2]])
            out = np.empty((height, width, img.shape[2]), img.dtype)
            for c in range(img.shape[2]):
                out[..., c] = _ndi.affine_transform(
                    img[..., c], mat, offset=off,
                    output_shape=(height, width), order=1,
                    mode="grid-constant",  # cv2 BORDER_CONSTANT edge blending
                    cval=PAD_VALUE,
                )
            img = out
    labels = transform_labels(labels, M, s, width, height)
    return img, labels


def mixup(im, labels, im2, labels2, rng: Optional[np.random.Generator] = None):
    """Beta(32, 32) blend (data_augment.py:87-93)."""
    rng = rng or np.random.default_rng()
    r = rng.beta(32.0, 32.0)
    im = im * r + im2 * (1 - r)
    return im, np.concatenate([labels, labels2], 0)


def flip_augment(img, labels_norm, flipud_p, fliplr_p, rng: Optional[random.Random] = None):
    """Random ud/lr flips on (H, W, C) + normalized cxcywh labels
    (gen1_2yolo.py:210-228)."""
    rng = rng or random
    if rng.random() < flipud_p:
        img = np.flipud(img)
        if len(labels_norm):
            labels_norm[:, 2] = 1 - labels_norm[:, 2]
    if rng.random() < fliplr_p:
        img = np.fliplr(img)
        if len(labels_norm):
            labels_norm[:, 1] = 1 - labels_norm[:, 1]
    return np.ascontiguousarray(img), labels_norm


def _mosaic_tiles(s: int, xc: int, yc: int):
    """Canvas boxes + canvas->source offsets for 4 s-by-s tiles around
    (xc, yc) — the placement math of data_augment.py:200-230 with h=w=s."""
    w = h = s
    geo = []
    for i in range(4):
        if i == 0:
            x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
            x1b, y1b = w - (x2a - x1a), h - (y2a - y1a)
        elif i == 1:
            x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, 2 * s), yc
            x1b, y1b = 0, h - (y2a - y1a)
        elif i == 2:
            x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(2 * s, yc + h)
            x1b, y1b = w - (x2a - x1a), 0
        else:
            x1a, y1a, x2a, y2a = xc, yc, min(xc + w, 2 * s), min(2 * s, yc + h)
            x1b, y1b = 0, 0
        geo.append(((x1a, y1a, x2a, y2a), (x1a - x1b, y1a - y1b)))
    return geo


def _flip_compose(inv: np.ndarray, labels: np.ndarray, s: int,
                  do_lr: bool, do_ud: bool):
    """Fold post-affine flips (general_augment, gen1_2yolo.py:210-228) into
    the inverse map and the label coordinates. The reference flips normalized
    cxcywh by 1-c (a half-pixel off the np.flip pixel map — reproduced)."""
    if do_lr:
        F = np.array([[-1.0, 0, s - 1], [0, 1.0, 0], [0, 0, 1.0]])
        inv = inv @ F
        if len(labels):
            x1, x2 = labels[:, 1].copy(), labels[:, 3].copy()
            labels[:, 1], labels[:, 3] = s - x2, s - x1
    if do_ud:
        F = np.array([[1.0, 0, 0], [0, -1.0, s - 1], [0, 0, 1.0]])
        inv = inv @ F
        if len(labels):
            y1, y2 = labels[:, 2].copy(), labels[:, 4].copy()
            labels[:, 2], labels[:, 4] = s - y2, s - y1
    return inv, labels


def plan_event_affine(
    labels_list: Sequence[np.ndarray],  # per-sample (n, 5) abs xyxy, s-frame
    img_size: int,
    hyp: dict,
    rng: np.random.Generator,
    label_cap: int,
):
    """Affine+flip plan for EVENT-SPACE execution — the fast path for the
    reference's actual Gen1 recipe (random_affine + flips, no mosaic,
    gen1_2yolo.py:365-390). Events are points, so the image warp's point map
    applies directly to their coordinates: a point at position c lands at
    ``P c`` with ``P = F @ M`` (M the random affine, F the flip involution).

    Returns (point_maps (B, 3, 3) in the letterboxed frame, labels
    (B, cap, 5), nl (B,)). Label math is identical to the image path."""
    B = len(labels_list)
    s = img_size
    py_rng = random.Random(int(rng.integers(2**31)))
    maps = np.zeros((B, 3, 3), np.float32)
    labels = np.zeros((B, label_cap, 5), np.float32)
    nl = np.zeros((B,), np.int32)
    for i in range(B):
        M, sc = get_transform_matrix(
            (s, s), (s, s), hyp.get("degrees", 0.0), hyp.get("scale", 0.0),
            hyp.get("shear", 0.0), hyp.get("translate", 0.0), py_rng,
        )
        lab = transform_labels(labels_list[i].copy(), M, sc, s, s)
        lab[:, [1, 3]] = lab[:, [1, 3]].clip(0, s - 1e-3)
        lab[:, [2, 4]] = lab[:, [2, 4]].clip(0, s - 1e-3)
        P = M.copy()
        do_lr = py_rng.random() < hyp.get("fliplr", 0.0)
        do_ud = py_rng.random() < hyp.get("flipud", 0.0)
        if do_lr:
            F = np.array([[-1.0, 0, s - 1], [0, 1.0, 0], [0, 0, 1.0]])
            P = F @ P
            if len(lab):
                x1, x2 = lab[:, 1].copy(), lab[:, 3].copy()
                lab[:, 1], lab[:, 3] = s - x2, s - x1
        if do_ud:
            F = np.array([[1.0, 0, 0], [0, -1.0, s - 1], [0, 0, 1.0]])
            P = F @ P
            if len(lab):
                y1, y2 = lab[:, 2].copy(), lab[:, 4].copy()
                lab[:, 2], lab[:, 4] = s - y2, s - y1
        maps[i] = P.astype(np.float32)
        n = min(len(lab), label_cap)
        labels[i, :n] = lab[:n]
        nl[i] = n
    return maps, labels, nl


def apply_event_affine(
    x: np.ndarray, y: np.ndarray, n: int,
    P: np.ndarray,  # (3, 3) point map in the letterboxed img_size frame
    sensor_h: int, sensor_w: int, img_size: int,
):
    """Move the first ``n`` events through the letterbox-frame point map and
    back to sensor coordinates; events leaving the frame are dropped
    (compacted to the front). Returns (x', y', keep mask)."""
    r, _, (dw, dh) = letterbox_geometry(sensor_h, sensor_w, img_size)
    u = x[:n].astype(np.float64) * r + dw
    v = y[:n].astype(np.float64) * r + dh
    u2 = P[0, 0] * u + P[0, 1] * v + P[0, 2]
    v2 = P[1, 0] * u + P[1, 1] * v + P[1, 2]
    xs = (u2 - dw) / r
    ys = (v2 - dh) / r
    keep = (xs >= 0) & (xs <= sensor_w - 1) & (ys >= 0) & (ys <= sensor_h - 1)
    return (
        np.round(xs[keep]).astype(x.dtype),
        np.round(ys[keep]).astype(y.dtype),
        keep,
    )


def plan_augment_batch(
    labels_list: Sequence[np.ndarray],  # per-sample (n, 5) abs xyxy, s-frame
    img_size: int,
    hyp: dict,
    rng: np.random.Generator,
    label_cap: int,
    n_out: Optional[int] = None,
):
    """Plan the full strong-augment pipeline for one batch: mosaic routing,
    random_affine matrices, flips and mixup — label math here on host, pixel
    math on device via :func:`..ops.warp.compose_warp`.

    Mirrors the reference composition order (datasets.py __getitem__ /
    gen1_2yolo.py:365-390): [mosaic?] -> random_affine -> flips -> [mixup?].

    ``labels_list`` may be LONGER than the emitted batch: pass ``n_out`` to
    plan P = len(labels_list) rows but emit labels only for the first
    ``n_out``. The extra rows are a dataset-wide partner pool (the
    reference's mosaic/mixup partners are random dataset indices,
    datasets.py get_mosaic/__getitem__; YOLOv6's mixup partner is itself a
    full fresh mosaic, which is why every pool row gets its own complete
    mosaic+affine+flip plan here). With ``n_out=None`` partners come from
    the batch itself — equivalent in distribution under a shuffled sampler
    but with within-batch label correlation; the pool removes that.

    Returns (plan_arrays: dict of numpy arrays matching AugPlan fields,
    P rows each, labels (n_out, label_cap, 5) abs xyxy, nl (n_out,) int32).
    """
    B = len(labels_list)
    if n_out is None:
        n_out = B
    s = img_size
    py_rng = random.Random(int(rng.integers(2**31)))
    src_idx = np.tile(np.arange(B, dtype=np.int32)[:, None], (1, 4))
    inv_aff = np.zeros((B, 2, 3), np.float32)
    fwd_aff = np.zeros((B, 2, 3), np.float32)
    tile_boxes = np.zeros((B, 4, 4), np.float32)
    tile_offsets = np.zeros((B, 4, 2), np.float32)
    mix_idx = np.arange(B, dtype=np.int32)
    mix_r = np.ones((B,), np.float32)
    out_labels: list = []

    for i in range(B):
        use_mosaic = B >= 4 and rng.random() < hyp.get("mosaic", 0.0)
        if use_mosaic:
            partners = rng.choice(B, size=3, replace=False)
            idxs = [i] + [int(p) for p in partners]
            src_idx[i] = idxs
            yc = int(py_rng.uniform(s // 2, 3 * s // 2))
            xc = int(py_rng.uniform(s // 2, 3 * s // 2))
            canvas_labels = []
            for k, ((box), (offx, offy)) in enumerate(_mosaic_tiles(s, xc, yc)):
                tile_boxes[i, k] = box
                tile_offsets[i, k] = (offx, offy)
                lab = labels_list[idxs[k]].copy()
                if len(lab):
                    lab[:, [1, 3]] += offx
                    lab[:, [2, 4]] += offy
                    canvas_labels.append(lab)
            lab = (
                np.concatenate(canvas_labels, 0)
                if canvas_labels
                else np.zeros((0, 5), np.float32)
            )
            lab[:, 1:] = lab[:, 1:].clip(0, 2 * s)
            canvas_hw = (2 * s, 2 * s)
        else:
            tile_boxes[i, 0] = (0, 0, s, s)
            lab = labels_list[i].copy()
            canvas_hw = (s, s)

        M, sc = get_transform_matrix(
            canvas_hw, (s, s), hyp.get("degrees", 0.0), hyp.get("scale", 0.0),
            hyp.get("shear", 0.0), hyp.get("translate", 0.0), py_rng,
        )
        lab = transform_labels(lab, M, sc, s, s)
        lab[:, [1, 3]] = lab[:, [1, 3]].clip(0, s - 1e-3)
        lab[:, [2, 4]] = lab[:, [2, 4]].clip(0, s - 1e-3)
        inv = np.linalg.inv(M)
        inv, lab = _flip_compose(
            inv, lab, s,
            do_lr=py_rng.random() < hyp.get("fliplr", 0.0),
            do_ud=py_rng.random() < hyp.get("flipud", 0.0),
        )
        inv_aff[i] = inv[:2].astype(np.float32)
        # forward map canvas px -> output px (flips folded), for the
        # event-space executor (reps/event_mosaic.py): points move through
        # the affine directly instead of inverse-sampling pixels
        fwd_aff[i] = np.linalg.inv(inv)[:2].astype(np.float32)
        out_labels.append(lab)

    # mixup blends two composed outputs (data_augment.py:87-93 beta(32,32));
    # labels of the partner are appended. Only emitted rows mix; partners
    # may be any composed pool row.
    mixed_labels = [out_labels[i].copy() for i in range(n_out)]
    for i in range(n_out):
        if B >= 2 and rng.random() < hyp.get("mixup", 0.0):
            j = int(rng.integers(B))
            mix_idx[i] = j
            mix_r[i] = float(rng.beta(32.0, 32.0))
            if len(out_labels[j]):
                mixed_labels[i] = np.concatenate(
                    [mixed_labels[i], out_labels[j]], 0
                )

    labels = np.zeros((n_out, label_cap, 5), np.float32)
    nl = np.zeros((n_out,), np.int32)
    for i, lab in enumerate(mixed_labels):
        n = min(len(lab), label_cap)
        labels[i, :n] = lab[:n]
        nl[i] = n
    plan = dict(
        src_idx=src_idx, inv_affine=inv_aff, fwd_affine=fwd_aff,
        tile_boxes=tile_boxes, tile_offsets=tile_offsets, mix_idx=mix_idx,
        mix_r=mix_r,
    )
    return plan, labels, nl


def mosaic_augmentation(img_size: int, imgs: Sequence[np.ndarray],
                        labels: Sequence[np.ndarray],
                        rng: Optional[random.Random] = None):
    """4-tile mosaic (data_augment.py:187-268): place 4 images around a
    random center in a 2x-size canvas; labels absolute xyxy."""
    rng = rng or random
    assert len(imgs) == 4
    s = img_size
    yc = int(rng.uniform(s // 2, 2 * s - s // 2))
    xc = int(rng.uniform(s // 2, 2 * s - s // 2))
    c = imgs[0].shape[2]
    canvas = np.full((2 * s, 2 * s, c), PAD_VALUE, imgs[0].dtype)
    out_labels = []
    for i, (im, lab) in enumerate(zip(imgs, labels)):
        h, w = im.shape[:2]
        if i == 0:
            x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
            x1b, y1b = w - (x2a - x1a), h - (y2a - y1a)
        elif i == 1:
            x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, 2 * s), yc
            x1b, y1b = 0, h - (y2a - y1a)
        elif i == 2:
            x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(2 * s, yc + h)
            x1b, y1b = w - (x2a - x1a), 0
        else:
            x1a, y1a, x2a, y2a = xc, yc, min(xc + w, 2 * s), min(2 * s, yc + h)
            x1b, y1b = 0, 0
        canvas[y1a:y2a, x1a:x2a] = im[y1b : y1b + (y2a - y1a), x1b : x1b + (x2a - x1a)]
        if len(lab):
            l = lab.copy()
            l[:, [1, 3]] += x1a - x1b
            l[:, [2, 4]] += y1a - y1b
            out_labels.append(l)
    labels = np.concatenate(out_labels, 0) if out_labels else np.zeros((0, 5))
    if len(labels):
        labels[:, [1, 3]] = labels[:, [1, 3]].clip(0, 2 * s)
        labels[:, [2, 4]] = labels[:, [2, 4]].clip(0, 2 * s)
    return canvas, labels
