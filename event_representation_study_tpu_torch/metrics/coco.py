"""COCO-protocol detection metrics (mAP / AR), a copy of the JAX package's
``metrics/coco.py``: a pycocotools-equivalent evaluator (the reference shells out to pycocotools COCOeval,
ev-YOLOv6/yolov6/core/evaler.py:372-478; that package is not vendored here,
so the protocol is implemented directly).

Protocol (matching COCOeval 'bbox'):
- IoU thresholds 0.50:0.05:0.95, recall grid 0:0.01:1 (101 points)
- per (image, class): score-descending greedy matching, each GT used once,
  a detection matches the *unmatched* GT with the highest IoU >= threshold
- area ranges all / small(<32^2) / medium / large(>96^2), maxDets 1/10/100
- AP = mean over classes x IoU thresholds of the 101-point interpolated
  precision envelope; classes absent from the GT are excluded (-1).

Inputs are plain arrays; no JSON round trip is needed (the reference's
convert_to_coco_format + json file step collapses into direct calls).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

IOU_THRS = np.round(np.arange(0.5, 1.0, 0.05), 2)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
MAX_DETS = (1, 10, 100)


def _iou_matrix(dt: np.ndarray, gt: np.ndarray) -> np.ndarray:
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    lt = np.maximum(dt[:, None, :2], gt[None, :, :2])
    rb = np.minimum(dt[:, None, 2:4], gt[None, :, 2:4])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    a_dt = (dt[:, 2] - dt[:, 0]) * (dt[:, 3] - dt[:, 1])
    a_gt = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1])
    union = a_dt[:, None] + a_gt[None, :] - inter
    # no epsilon: an IoU of exactly t must match at threshold t
    # (maskUtils.iou divides exactly; epsilon would push 0.5 below 0.5)
    return np.where(union > 0, inter / np.maximum(union, 1e-300), 0.0)


@dataclasses.dataclass
class _ImgEval:
    dt_scores: np.ndarray  # (D,)
    dt_matched: np.ndarray  # (T, D) bool
    dt_ignore: np.ndarray  # (T, D) bool
    num_gt: int


class CocoEvaluator:
    """Accumulate per-image detections and compute COCO stats.

    add_image(dets, gts): dets (D, 6) [x1 y1 x2 y2 score cls] in original
    image pixels; gts (G, 5) [cls x1 y1 x2 y2].
    """

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        # evals[(cls, area)] -> list of _ImgEval per maxDet=100 (restricted later)
        self.evals: Dict[Tuple[int, str], List[_ImgEval]] = {
            (c, a): [] for c in range(num_classes) for a in AREA_RNG
        }

    def add_image(self, dets: np.ndarray, gts: np.ndarray):
        dets = np.asarray(dets, np.float64).reshape(-1, 6)
        gts = np.asarray(gts, np.float64).reshape(-1, 5)
        for c in range(self.num_classes):
            dt = dets[dets[:, 5] == c]
            gt = gts[gts[:, 0] == c][:, 1:5]
            order = np.argsort(-dt[:, 4], kind="mergesort")
            dt = dt[order][: max(MAX_DETS)]
            gt_area = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1])
            dt_area = (dt[:, 2] - dt[:, 0]) * (dt[:, 3] - dt[:, 1])
            ious = _iou_matrix(dt[:, :4], gt)
            for aname, (lo, hi) in AREA_RNG.items():
                gt_ig = (gt_area < lo) | (gt_area > hi)
                T, D, G = len(IOU_THRS), len(dt), len(gt)
                dt_m = np.zeros((T, D), bool)
                dt_ig = np.zeros((T, D), bool)
                for ti, thr in enumerate(IOU_THRS):
                    gt_used = np.zeros(G, bool)
                    # match non-ignored gts first (COCO sorts ignored last)
                    gt_order = np.argsort(gt_ig, kind="mergesort")
                    for di in range(D):
                        # COCOeval starts at min(t, 1-1e-10) and keeps
                        # ious >= that (evaluateImg: `if ious < iou: continue`)
                        best, best_iou = -1, min(thr, 1.0 - 1e-10)
                        for gi in gt_order:
                            if gt_used[gi]:
                                continue
                            if best >= 0 and gt_ig[gi] and not gt_ig[best]:
                                break  # only ignored left; keep current best
                            if ious[di, gi] >= best_iou:
                                best, best_iou = gi, ious[di, gi]
                        if best >= 0:
                            gt_used[best] = True
                            dt_m[ti, di] = True
                            dt_ig[ti, di] = gt_ig[best]
                    # unmatched dets outside the area range are ignored
                    out_rng = (dt_area < lo) | (dt_area > hi)
                    dt_ig[ti] |= (~dt_m[ti]) & out_rng
                self.evals[(c, aname)].append(
                    _ImgEval(dt[:, 4].copy(), dt_m, dt_ig, int((~gt_ig).sum()))
                )

    def _pr(self, cls: int, area: str, max_det: int):
        evs = self.evals[(cls, area)]
        npig = sum(e.num_gt for e in evs)
        if npig == 0:
            return None
        scores = np.concatenate([e.dt_scores[:max_det] for e in evs])
        order = np.argsort(-scores, kind="mergesort")
        T = len(IOU_THRS)
        tps = np.concatenate([e.dt_matched[:, :max_det] for e in evs], axis=1)[:, order]
        igs = np.concatenate([e.dt_ignore[:, :max_det] for e in evs], axis=1)[:, order]
        tp = tps & ~igs
        fp = ~tps & ~igs
        tp_c = np.cumsum(tp, axis=1).astype(np.float64)
        fp_c = np.cumsum(fp, axis=1).astype(np.float64)
        recall = tp_c / npig
        precision = tp_c / np.maximum(tp_c + fp_c, 1e-12)
        # precision envelope + 101-point interpolation per threshold
        prec101 = np.zeros((T, len(REC_THRS)))
        max_rec = recall[:, -1] if recall.shape[1] else np.zeros(T)
        for t in range(T):
            p = precision[t]
            for i in range(len(p) - 1, 0, -1):
                p[i - 1] = max(p[i - 1], p[i])
            idx = np.searchsorted(recall[t], REC_THRS, side="left")
            ok = idx < len(p)
            prec101[t, ok] = p[idx[ok]]
        return prec101, max_rec

    def summarize(self) -> Dict[str, float]:
        def ap(area="all", max_det=100, iou: Optional[float] = None):
            vals = []
            for c in range(self.num_classes):
                pr = self._pr(c, area, max_det)
                if pr is None:
                    continue
                p101, _ = pr
                if iou is None:
                    vals.append(p101.mean())
                else:
                    ti = int(np.argmin(np.abs(IOU_THRS - iou)))
                    vals.append(p101[ti].mean())
            return float(np.mean(vals)) if vals else -1.0

        def ar(area="all", max_det=100):
            vals = []
            for c in range(self.num_classes):
                pr = self._pr(c, area, max_det)
                if pr is None:
                    continue
                _, max_rec = pr
                vals.append(max_rec.mean())
            return float(np.mean(vals)) if vals else -1.0

        return {
            "AP": ap(),
            "AP50": ap(iou=0.5),
            "AP75": ap(iou=0.75),
            "AP_small": ap(area="small"),
            "AP_medium": ap(area="medium"),
            "AP_large": ap(area="large"),
            "AR1": ar(max_det=1),
            "AR10": ar(max_det=10),
            "AR100": ar(max_det=100),
            "AR_small": ar(area="small"),
            "AR_medium": ar(area="medium"),
            "AR_large": ar(area="large"),
        }
