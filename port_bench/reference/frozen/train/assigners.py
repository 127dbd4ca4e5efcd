"""Label assigners (the JAX package's ``train/assigners.py``): ATSS and the
task-aligned assigner over fixed-capacity padded GT tensors
``gt_labels (B, M, 1)``, ``gt_bboxes (B, M, 4)`` xyxy image units,
``mask_gt (B, M, 1)``.

Outputs: ``target_labels (B, A)``, ``target_bboxes (B, A, 4)``,
``target_scores (B, A, nc)``, ``fg_mask (B, A) bool``.

Ties decide which anchors are picked, so every selection breaks them toward
the lower index, as ``lax.top_k`` and ``jnp.argmax`` do: ``torch.argmax``
knockouts (the first maximum is documented) and a stable ``torch.sort``,
never ``torch.topk``, which promises no order of ties.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def iou_batch(box1, box2, eps: float = 1e-9):
    """(B, M, 4) x (B, A, 4) -> (B, M, A) IoU."""
    b1 = box1[:, :, None, :]
    b2 = box2[:, None, :, :]
    x1y1 = torch.maximum(b1[..., 0:2], b2[..., 0:2])
    x2y2 = torch.minimum(b1[..., 2:4], b2[..., 2:4])
    overlap = (x2y2 - x1y1).clamp(min=0).prod(-1)
    area1 = (b1[..., 2:4] - b1[..., 0:2]).clamp(min=0).prod(-1)
    area2 = (b2[..., 2:4] - b2[..., 0:2]).clamp(min=0).prod(-1)
    return overlap / (area1 + area2 - overlap + eps)


def select_candidates_in_gts(xy_centers, gt_bboxes, eps: float = 1e-9):
    """(A, 2), (B, M, 4) -> (B, M, A) float: anchor centre strictly inside."""
    lt = xy_centers[None, None] - gt_bboxes[:, :, None, 0:2]
    rb = gt_bboxes[:, :, None, 2:4] - xy_centers[None, None]
    deltas = torch.cat([lt, rb], dim=-1)
    return (deltas.amin(-1) > eps).to(gt_bboxes.dtype)


def select_highest_overlaps(mask_pos, overlaps, n_max_boxes: int):
    """Resolve anchors claimed by several GTs by the highest IoU."""
    fg_mask = mask_pos.sum(-2)  # (B, A)
    mask_multi = fg_mask[:, None, :] > 1
    max_idx = overlaps.argmax(1)  # (B, A), first maximum
    is_max = F.one_hot(max_idx, n_max_boxes).to(overlaps.dtype).transpose(1, 2)
    mask_pos = torch.where(mask_multi, is_max, mask_pos)
    fg_mask = mask_pos.sum(-2)
    target_gt_idx = mask_pos.argmax(-2)  # (B, A)
    return target_gt_idx, fg_mask, mask_pos


def _gather_targets(gt_labels, gt_bboxes, target_gt_idx, fg_mask, num_classes: int,
                    bg_on_labels: bool):
    b = torch.arange(gt_labels.shape[0], device=gt_labels.device)[:, None]
    labels = gt_labels[..., 0].to(torch.int64)[b, target_gt_idx]  # (B, A)
    bboxes = gt_bboxes[b, target_gt_idx]
    if bg_on_labels:
        labels = torch.where(fg_mask > 0, labels, num_classes)
        scores = F.one_hot(labels, num_classes + 1)[..., :num_classes].to(gt_bboxes.dtype)
    else:
        scores = F.one_hot(labels.clamp(min=0), num_classes).to(gt_bboxes.dtype)
        scores = torch.where((fg_mask > 0)[..., None], scores, 0.0)
    return labels, bboxes, scores


def _topk_mask(dist, k: int, row_valid):
    """The k-hot over the last axis of the ``k`` SMALLEST ``dist`` (ties to
    the lower index, as ``lax.top_k(-dist)``), with indices of invalid rows
    sent to 0 and indices picked more than once dropped. Returns
    (mask, candidate indices (..., k))."""
    idxs = torch.sort(dist, dim=-1, stable=True).indices[..., :k]
    idxs_m = torch.where(row_valid[..., None], idxs, 0)
    is_in = torch.zeros_like(dist).scatter_add_(-1, idxs_m, torch.ones_like(idxs_m, dtype=dist.dtype))
    return torch.where(is_in > 1, 0.0, is_in), idxs


def _topk_khot(metrics, topk: int, row_valid):
    """k-hot of the ``topk`` largest metrics per row by ``topk`` argmax
    knockouts (the first maximum wins a tie); invalid rows all zero."""
    khot = torch.zeros(metrics.shape, dtype=torch.bool, device=metrics.device)
    m = metrics.clone()
    for _ in range(topk):
        idx = m.argmax(-1, keepdim=True)
        khot.scatter_(-1, idx, True)
        m.scatter_(-1, idx, float("-inf"))
    return (khot & row_valid[..., None]).to(metrics.dtype)


@torch.no_grad()
def task_aligned_assigner(pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes, mask_gt,
                          topk: int = 13, alpha: float = 1.0, beta: float = 6.0,
                          eps: float = 1e-9):
    """TaskAlignedAssigner: ``pd_scores (B, A, nc)``, ``pd_bboxes (B, A, 4)``
    and ``anc_points (A, 2)`` in image units."""
    num_classes = pd_scores.shape[-1]
    n_max = gt_bboxes.shape[1]
    labels = gt_labels[..., 0].to(torch.int64).clamp(0, num_classes - 1)
    bbox_scores = torch.gather(
        pd_scores.transpose(1, 2), 1, labels[:, :, None].expand(-1, -1, pd_scores.shape[1])
    )  # (B, M, A)
    overlaps = iou_batch(gt_bboxes, pd_bboxes)
    align_metric = bbox_scores.pow(alpha) * overlaps.pow(beta)

    mask_in_gts = select_candidates_in_gts(anc_points, gt_bboxes)
    mask_topk = _topk_khot(align_metric * mask_in_gts, topk, mask_gt[..., 0] > 0)
    mask_pos = mask_topk * mask_in_gts * mask_gt

    target_gt_idx, fg_mask, mask_pos = select_highest_overlaps(mask_pos, overlaps, n_max)
    target_labels, target_bboxes, target_scores = _gather_targets(
        gt_labels, gt_bboxes, target_gt_idx, fg_mask, num_classes, bg_on_labels=False
    )
    align_metric = align_metric * mask_pos
    pos_align = align_metric.amax(-1, keepdim=True)
    pos_overlaps = (overlaps * mask_pos).amax(-1, keepdim=True)
    norm = (align_metric * pos_overlaps / (pos_align + eps)).amax(-2)[..., None]
    return target_labels, target_bboxes, target_scores * norm, fg_mask > 0


@torch.no_grad()
def atss_assigner(anc_bboxes, n_level_bboxes: Sequence[int], gt_labels, gt_bboxes, mask_gt,
                  pd_bboxes, num_classes: int, topk: int = 9):
    """ATSS: ``anc_bboxes (A, 4)`` image-unit cell boxes, ``pd_bboxes
    (B, A, 4)`` or None."""
    n_anchors = anc_bboxes.shape[0]
    bs, n_max = gt_bboxes.shape[:2]
    overlaps = iou_batch(gt_bboxes, anc_bboxes[None].expand(bs, n_anchors, 4))
    gt_c = (gt_bboxes[..., 0:2] + gt_bboxes[..., 2:4]) / 2  # (B, M, 2)
    ac_c = (anc_bboxes[:, 0:2] + anc_bboxes[:, 2:4]) / 2  # (A, 2)
    distances = ((gt_c[:, :, None, :] - ac_c[None, None]) ** 2).sum(-1).sqrt()

    row_valid = mask_gt[..., 0] > 0
    is_in, cand_idx, start = [], [], 0
    for nl in n_level_bboxes:
        mask, idxs = _topk_mask(distances[..., start:start + nl], min(topk, nl), row_valid)
        is_in.append(mask)
        cand_idx.append(idxs + start)
        start += nl
    is_in_candidate = torch.cat(is_in, -1)
    candidate_idxs = torch.cat(cand_idx, -1)  # (B, M, L * topk)

    # IoU threshold per GT: mean + std of its candidates' IoUs
    cand_overlaps_full = torch.where(is_in_candidate > 0, overlaps, 0.0)
    cand = torch.gather(cand_overlaps_full, -1, candidate_idxs)
    thr = cand.mean(-1, keepdim=True) + cand.std(-1, keepdim=True)

    is_pos = torch.where(cand_overlaps_full > thr, is_in_candidate, 0.0)
    mask_pos = is_pos * select_candidates_in_gts(ac_c, gt_bboxes) * mask_gt
    target_gt_idx, fg_mask, mask_pos = select_highest_overlaps(mask_pos, overlaps, n_max)
    target_labels, target_bboxes, target_scores = _gather_targets(
        gt_labels, gt_bboxes, target_gt_idx, fg_mask, num_classes, bg_on_labels=True
    )
    if pd_bboxes is not None:
        ious = (iou_batch(gt_bboxes, pd_bboxes) * mask_pos).amax(-2)[..., None]
        target_scores = target_scores * ious
    return target_labels, target_bboxes, target_scores, fg_mask > 0
