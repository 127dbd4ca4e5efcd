"""The comparisons that decide ``correct``: the port's readings against the
plain reference's, each reduced to one number that the workload file
holds to a limit.

Training (per leaf: a named parameter, a BatchNorm statistic or an entry
of the EMA): the gap between the port's norm and the reference's, over the
reference's norm of that leaf or of the median leaf, whichever is larger;
the worst leaf is the reading.

Detections: each answer of the port is judged by what it says, against the
reference's candidates and kept detections (:func:`detection_gaps`).
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, Optional, Tuple

import torch


@torch.no_grad()
def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Float64 L2 norm of every leaf."""
    return {k: float(torch.linalg.vector_norm(v.detach().double())) for k, v in tensors.items()}


def worst_leaf_gap(got: Dict[str, float], want: Dict[str, float],
                   leaves: Optional[Iterable[str]] = None) -> Tuple[float, str]:
    """(worst gap, its leaf) over ``leaves`` (all of ``want`` by default)."""
    names = list(want if leaves is None else leaves)
    if not names:
        return math.inf, ""
    med = statistics.median(want[k] for k in names)
    worst, where = -1.0, ""
    for k in names:
        if k not in got:
            return math.inf, k
        gap = abs(got[k] - want[k]) / max(want[k], med, 1e-30)
        if not math.isfinite(gap):
            return math.inf, k
        if gap > worst:
            worst, where = gap, k
    return worst, where


def moving_leaves(ref_grad_norms: Dict[str, float], share: float = 1e-3):
    """Leaves whose reference gradient is at least ``share`` of the median
    leaf's: the others move by round-off alone under the optimizer."""
    med = statistics.median(ref_grad_norms.values())
    return [k for k, v in ref_grad_norms.items() if v >= share * med]


def loss_gap(got, want) -> float:
    """Worst relative gap of the step losses."""
    if len(got) != len(want):
        return math.inf
    gaps = [abs(g - w) / max(abs(w), 1e-30) for g, w in zip(got, want)]
    return max(gaps) if all(map(math.isfinite, gaps)) else math.inf


def _box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-7)


@torch.no_grad()
def detection_gaps(dets: torch.Tensor, pairs: torch.Tensor, conf_thres: float,
                   iou_thres: float, max_det: int) -> Tuple[float, float, float]:
    """(box gap px, score gap, decision gap) of one request. ``dets`` (n, 6)
    are the port's detections [x1 y1 x2 y2 score cls] in the order they were
    kept; ``pairs`` (m, 6) the reference's box and score of every (anchor,
    class) pair of the request.

    Each detection is the reference pair of its class nearest to it: the
    largest coordinate difference is the box gap, the score difference the
    score gap. The reference then follows the port's greedy suppression
    choice by choice, as a served token is judged against the reference's
    best logit at its position. Each choice reads, in the decision gap, the
    least move of a score across ``conf_thres`` or of an overlap across
    ``iou_thres`` (both on a 0..1 scale) under which the reference would
    have made it too; rounding moves them by little, a wrong choice by much:

    - a detection that is an alive candidate, for each alive candidate of a
      higher reference score: the lesser of the two scores' difference (two
      candidates whose scores differ by rounding may be kept in either
      order) and the distance of its largest overlap with a kept detection
      of its class below ``iou_thres`` (then the port's geometry suppressed
      it, and it leaves the alive set);
    - one at or below the threshold in the reference: its distance below;
    - one that an earlier one suppresses in the reference's geometry: how
      far their overlap exceeds ``iou_thres``;
    - when the port stops before ``max_det``, a candidate the reference
      leaves alive (a missing detection): the lesser of its height above
      the threshold and the distance of its largest overlap with a kept
      detection of its class below ``iou_thres``.
    """
    dets, pairs = dets.double().cpu(), pairs.double().cpu()
    cand = pairs[pairs[:, 4] > conf_thres]
    iou = _box_iou(cand[:, :4], cand[:, :4]) * (cand[:, 5, None] == cand[None, :, 5])
    alive = torch.ones(len(cand), dtype=torch.bool)
    picked = torch.zeros(len(cand), dtype=torch.bool)
    box_gap = score_gap = decision_gap = 0.0
    for d in dets:
        cls_rows = pairs[:, 5] == d[5]
        if not cls_rows.any():
            return math.inf, math.inf, math.inf
        dist = torch.where(cls_rows, (pairs[:, :4] - d[:4]).abs().amax(dim=1), math.inf)
        j = int(dist.argmin())
        ref = pairs[j]
        box_gap = max(box_gap, float(dist[j]))
        score_gap = max(score_gap, abs(float(ref[4] - d[4])))
        k = ((cand[:, :4] == ref[:4]).all(dim=1) & (cand[:, 5] == ref[5])).nonzero()
        if len(k) == 0:  # at or below the threshold in the reference
            decision_gap = max(decision_gap, conf_thres - float(ref[4]))
            continue
        k = int(k[0])
        if alive[k]:
            for b in (alive & (cand[:, 4] > cand[k, 4])).nonzero().flatten().tolist():
                ahead = float(cand[b, 4] - cand[k, 4])
                near = iou_thres - (float(iou[b, picked].max()) if picked.any() else 0.0)
                decision_gap = max(decision_gap, min(ahead, near))
                if near < ahead:
                    alive[b] = False
        else:
            decision_gap = max(decision_gap, float(iou[k, picked].max()) - iou_thres
                               if picked.any() else math.inf)
        alive &= ~(iou[k] > iou_thres)
        alive[k] = False
        picked[k] = True
    if len(dets) < max_det:
        for c in alive.nonzero().flatten().tolist():
            overlap = float(iou[c, picked].max()) if picked.any() else 0.0
            decision_gap = max(decision_gap, min(float(cand[c, 4]) - conf_thres,
                                                 iou_thres - overlap))
    return box_gap, score_gap, decision_gap
