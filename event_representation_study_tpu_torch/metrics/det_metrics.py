"""Per-class PR/F1/AP curves + confusion matrix (a copy of the JAX package's
``metrics/det_metrics.py``), the twin of ev-YOLOv6/yolov6/utils/metrics.py (ap_per_class :18, compute_ap :84,
process_batch :171, ConfusionMatrix :202), feeding the optional
do_pr_metric evaluation path (core/evaler.py:179-337).

Pure NumPy host post-processing (the reference's is too); the device part of
evaluation ends at NMS.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

IOUV = np.linspace(0.5, 0.95, 10)  # evaler.py iouv
# NumPy 2 renamed trapz to trapezoid; either gives the same value
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def box_iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 4) x (M, 4) xyxy -> (N, M) IoU."""
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-16)


def process_batch(detections: np.ndarray, labels: np.ndarray,
                  iouv: np.ndarray = IOUV) -> np.ndarray:
    """Per-detection correctness at each IoU threshold
    (metrics.py:171-199): detections (N, 6) [x1,y1,x2,y2,conf,cls],
    labels (M, 5) [cls,x1,y1,x2,y2] -> bool (N, len(iouv))."""
    correct = np.zeros((detections.shape[0], iouv.shape[0]), bool)
    if len(labels) == 0 or len(detections) == 0:
        return correct
    iou = box_iou_np(labels[:, 1:], detections[:, :4])
    cls_match = labels[:, 0:1] == detections[:, 5][None, :]
    for i, t in enumerate(iouv):
        li, di = np.where((iou >= t) & cls_match)
        if li.shape[0]:
            m = np.stack([li, di, iou[li, di]], 1)
            if li.shape[0] > 1:
                m = m[m[:, 2].argsort()[::-1]]
                m = m[np.unique(m[:, 1], return_index=True)[1]]
                m = m[np.unique(m[:, 0], return_index=True)[1]]
            correct[m[:, 1].astype(int), i] = True
    return correct


def ap_per_class(tp: np.ndarray, conf: np.ndarray, pred_cls: np.ndarray,
                 target_cls: np.ndarray):
    """Per-class P/R/AP/F1 curves over 1000 confidence points
    (metrics.py:18-82). Returns (p, r, ap, f1, unique_classes)."""
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]
    unique_classes = np.unique(target_cls)
    nc = unique_classes.shape[0]
    px = np.linspace(0, 1, 1000)
    ap = np.zeros((nc, tp.shape[1]))
    p = np.zeros((nc, 1000))
    r = np.zeros((nc, 1000))
    for ci, c in enumerate(unique_classes):
        i = pred_cls == c
        n_l = (target_cls == c).sum()
        if i.sum() == 0 or n_l == 0:
            continue
        fpc = (1 - tp[i]).cumsum(0)
        tpc = tp[i].cumsum(0)
        recall = tpc / (n_l + 1e-16)
        r[ci] = np.interp(-px, -conf[i], recall[:, 0], left=0)
        precision = tpc / (tpc + fpc)
        p[ci] = np.interp(-px, -conf[i], precision[:, 0], left=1)
        for j in range(tp.shape[1]):
            ap[ci, j], _, _ = compute_ap(recall[:, j], precision[:, j])
    f1 = 2 * p * r / (p + r + 1e-16)
    return p, r, ap, f1, unique_classes.astype(np.int32)


def compute_ap(recall, precision) -> Tuple[float, np.ndarray, np.ndarray]:
    """101-point interpolated AP (metrics.py:84-110)."""
    mrec = np.concatenate(([0.0], recall, [recall[-1] + 0.01]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    ap = _trapezoid(np.interp(x, mrec, mpre), x)
    return float(ap), mpre, mrec


class ConfusionMatrix:
    """Detection confusion matrix with a background row/col
    (metrics.py:202-300)."""

    def __init__(self, nc: int, conf: float = 0.25, iou_thres: float = 0.45):
        self.matrix = np.zeros((nc + 1, nc + 1))
        self.nc = nc
        self.conf = conf
        self.iou_thres = iou_thres

    def process_batch(self, detections: np.ndarray, labels: np.ndarray):
        if len(detections):
            detections = detections[detections[:, 4] > self.conf]
        gt_classes = labels[:, 0].astype(int) if len(labels) else np.zeros(0, int)
        if len(detections) == 0:
            for gc in gt_classes:
                self.matrix[self.nc, gc] += 1  # background FN
            return
        det_classes = detections[:, 5].astype(int)
        if len(labels):
            iou = box_iou_np(labels[:, 1:], detections[:, :4])
            li, di = np.where(iou > self.iou_thres)
            if li.shape[0]:
                m = np.stack([li, di, iou[li, di]], 1)
                if li.shape[0] > 1:
                    m = m[m[:, 2].argsort()[::-1]]
                    m = m[np.unique(m[:, 1], return_index=True)[1]]
                    # unlike process_batch, the reference RE-SORTS by IoU
                    # before the label dedup (metrics.py:235-238): a GT
                    # matched by several retained detections keeps the
                    # highest-IoU one, not the lowest det index
                    m = m[m[:, 2].argsort()[::-1]]
                    m = m[np.unique(m[:, 0], return_index=True)[1]]
            else:
                m = np.zeros((0, 3))
            matched = m.shape[0] > 0
            m0, m1 = m[:, 0].astype(int), m[:, 1].astype(int)
            for i, gc in enumerate(gt_classes):
                j = m0 == i
                if matched and j.sum() == 1:
                    self.matrix[det_classes[m1[j]][0], gc] += 1  # correct/confused
                else:
                    self.matrix[self.nc, gc] += 1  # background FN
            for i, dc in enumerate(det_classes):
                if not matched or not (m1 == i).any():
                    self.matrix[dc, self.nc] += 1  # background FP
        else:
            for dc in det_classes:
                self.matrix[dc, self.nc] += 1


class PRMetric:
    """Accumulates (tp, conf, cls) stats across images and reports the
    reference's do_pr_metric summary: mAP50, best-F1 P/R, per-class AP
    (evaler.py:179-337)."""

    def __init__(self, nc: int, iouv: np.ndarray = IOUV):
        self.nc = nc
        self.iouv = iouv
        self.stats = []
        self.confusion = ConfusionMatrix(nc)

    def add_image(self, detections: np.ndarray, labels: np.ndarray):
        correct = process_batch(detections, labels, self.iouv)
        conf = detections[:, 4] if len(detections) else np.zeros(0)
        pcls = detections[:, 5] if len(detections) else np.zeros(0)
        tcls = labels[:, 0] if len(labels) else np.zeros(0)
        self.stats.append((correct, conf, pcls, tcls))
        self.confusion.process_batch(detections, labels)

    def summarize(self) -> dict:
        if not self.stats:
            return {}
        tp = np.concatenate([s[0] for s in self.stats])
        conf = np.concatenate([s[1] for s in self.stats])
        pcls = np.concatenate([s[2] for s in self.stats])
        tcls = np.concatenate([s[3] for s in self.stats])
        if tp.size == 0 or tcls.size == 0:
            return {}
        p, r, ap, f1, classes = ap_per_class(tp, conf, pcls, tcls)
        mf1 = f1.mean(0)
        best = int(mf1.argmax())
        ap50 = ap[:, 0]
        return {
            "mAP50_pr": float(ap50.mean()),
            "mAP50_95_pr": float(ap.mean()),
            "precision_at_best_f1": float(p.mean(0)[best]),
            "recall_at_best_f1": float(r.mean(0)[best]),
            "f1_best": float(mf1[best]),
            "per_class_ap50": {int(c): float(a) for c, a in zip(classes, ap50)},
            "confusion_matrix": self.confusion.matrix.tolist(),
        }
