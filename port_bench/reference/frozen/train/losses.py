"""Detection loss (the JAX package's ``train/losses.py``): varifocal loss on
the sigmoid class scores, GIoU on assigned positives and Distribution Focal
Loss over the 4 x (reg_max + 1) regression bins, weighted 1 / 2.5 / 0.5,
with ATSS assignment before ``warmup_epoch`` and TAL after it.

Targets are fixed-capacity padded per image: ``gt_labels (B, M)``,
``gt_bboxes (B, M, 4)`` xyxy image pixels, ``gt_mask (B, M)``; positives
enter as mask-weighted dense sums.

Under a data-parallel step (``group``: the process group of the "data"
mesh axis) each rank holds its share of the batch. The terms are sums over
the batch divided by the target-score sum, and JAX's sharded step divides
by the GLOBAL batch's. So the normaliser is all-reduced first (it carries
no gradient), and each rank's loss is its local sum over the global
normaliser: its share of the global loss. The step SUMS the ranks'
gradients (``parallel/train_step.py``), which gives the global batch's
gradient exactly; there is no ``loss * world_size`` factor, which the
reference needs only because DDP averages. The loss and parts a rank
returns are its shares; their sum over the ranks is the global batch's.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..ops.boxes import bbox2dist, dist2bbox, iou_loss
from .anchors import generate_anchors_train
from .assigners import atss_assigner, task_aligned_assigner


def global_sum(x, group=None):
    """One process: the sum over the group is the value itself."""
    if group is not None:
        raise ValueError("the frozen reference runs in one process")
    return x


class LossAux(NamedTuple):
    """Intermediates that the distillation objective reuses
    (``train/losses_variants.py``): it shares the base loss's assigner
    pass."""

    raw_cls: torch.Tensor  # unweighted scalars
    raw_iou: torch.Tensor
    raw_dfl: torch.Tensor
    fg_mask: torch.Tensor  # (B, A) bool
    bbox_weight: torch.Tensor  # (B, A)
    denom: torch.Tensor  # the target-scores-sum guard
    target_bboxes: torch.Tensor  # (B, A, 4) assigned boxes in grid units


class LossConfig(NamedTuple):
    num_classes: int
    strides: Tuple[int, ...] = (8, 16, 32, 64)
    reg_max: int = 16
    use_dfl: bool = True
    iou_type: str = "giou"
    warmup_epoch: int = 4
    weight_class: float = 1.0
    weight_iou: float = 2.5
    weight_dfl: float = 0.5
    atss_topk: int = 9
    tal_topk: int = 13


def varifocal_loss(pred_score, gt_score, label, alpha: float = 0.75, gamma: float = 2.0):
    """Focal-weighted BCE on probabilities, summed."""
    weight = alpha * pred_score.pow(gamma) * (1 - label) + gt_score * label
    p = pred_score.clamp(1e-9, 1 - 1e-9)
    bce = -(gt_score * torch.log(p) + (1 - gt_score) * torch.log(1 - p))
    return (bce * weight).sum()


def _df_loss(pred_dist, target, reg_max: int):
    """DFL: cross-entropy against the floor and ceil bins with linear
    weights. ``pred_dist`` (..., 4, reg_max + 1) logits, ``target`` (..., 4)
    in [0, reg_max)."""
    tl = target.floor().to(torch.int64)
    tr = tl + 1
    wl = tr.to(target.dtype) - target
    wr = 1.0 - wl
    logp = F.log_softmax(pred_dist, dim=-1)
    ll = -logp.gather(-1, tl[..., None])[..., 0]
    lr = -logp.gather(-1, tr.clamp(max=reg_max)[..., None])[..., 0]
    return (ll * wl + lr * wr).mean(-1, keepdim=True)


def bbox_decode(anchor_points, pred_dist, reg_max: int, use_dfl: bool = True):
    """DFL softmax expectation (or the raw ltrb distances without DFL),
    then ltrb -> xyxy."""
    if use_dfl:
        b, a, _ = pred_dist.shape
        proj = torch.arange(reg_max + 1, dtype=pred_dist.dtype, device=pred_dist.device)
        pred_dist = torch.softmax(pred_dist.reshape(b, a, 4, reg_max + 1), dim=-1) @ proj
    return dist2bbox(pred_dist, anchor_points)


def detection_loss(
    outputs,  # (feats, pred_scores (B, A, nc), pred_distri (B, A, 4 * (reg_max + 1)))
    gt_labels,  # (B, M) int
    gt_bboxes,  # (B, M, 4) xyxy image pixels
    gt_mask,  # (B, M) bool/float
    feat_shapes: Sequence[Tuple[int, int]],
    epoch: int,
    cfg: LossConfig,
    return_aux: bool = False,
    group=None,
):
    """``(loss, parts)``, and the :class:`LossAux` third with
    ``return_aux``. With ``group`` the normaliser is the global batch's
    (module docstring)."""
    _, pred_scores, pred_distri = outputs
    dev = pred_scores.device
    anchors, anchor_points, n_anchors_list, stride_tensor = generate_anchors_train(
        feat_shapes, cfg.strides, device=dev
    )
    gt_labels_ = gt_labels[..., None].to(torch.float32)
    mask_gt = gt_mask[..., None].to(torch.float32)

    anchor_points_s = anchor_points / stride_tensor
    pred_bboxes = bbox_decode(anchor_points_s, pred_distri, cfg.reg_max, cfg.use_dfl)
    # the assigners see no gradient (JAX: stop_gradient)
    pd_scores = pred_scores.detach()
    pd_boxes_img = pred_bboxes.detach() * stride_tensor

    if cfg.warmup_epoch > 0 and epoch < cfg.warmup_epoch:
        target_labels, target_bboxes, target_scores, fg_mask = atss_assigner(
            anchors, n_anchors_list, gt_labels_, gt_bboxes, mask_gt, pd_boxes_img,
            cfg.num_classes, topk=cfg.atss_topk,
        )
    else:
        target_labels, target_bboxes, target_scores, fg_mask = task_aligned_assigner(
            pd_scores, pd_boxes_img, anchor_points, gt_labels_, gt_bboxes, mask_gt,
            topk=cfg.tal_topk,
        )
    target_bboxes = target_bboxes / stride_tensor

    # classification
    tl = torch.where(fg_mask, target_labels, cfg.num_classes)
    one_hot = F.one_hot(tl, cfg.num_classes + 1)[..., : cfg.num_classes].to(pred_scores.dtype)
    loss_cls = varifocal_loss(pred_scores, target_scores, one_hot)
    tss = global_sum(target_scores.sum(), group)
    denom = torch.where(tss > 1, tss, 1.0)  # normalisation guard
    loss_cls = loss_cls / denom

    # box and DFL losses on positives, mask-weighted dense sums
    bbox_weight = target_scores.sum(-1) * fg_mask
    iou_v = iou_loss(pred_bboxes, target_bboxes, cfg.iou_type)
    loss_iou = ((1.0 - iou_v) * bbox_weight).sum() / denom
    if cfg.use_dfl:
        b, a, _ = pred_distri.shape
        pd = pred_distri.reshape(b, a, 4, cfg.reg_max + 1)
        target_ltrb = bbox2dist(anchor_points_s, target_bboxes, cfg.reg_max)
        dfl = _df_loss(pd, target_ltrb, cfg.reg_max)[..., 0]
        loss_dfl = (dfl * bbox_weight).sum() / denom
    else:
        loss_dfl = torch.zeros((), device=dev)

    loss = cfg.weight_class * loss_cls + cfg.weight_iou * loss_iou + cfg.weight_dfl * loss_dfl
    parts = {
        "iou": cfg.weight_iou * loss_iou,
        "dfl": cfg.weight_dfl * loss_dfl,
        "cls": cfg.weight_class * loss_cls,
        "num_pos": fg_mask.sum().to(torch.float32),
    }
    if return_aux:
        return loss, parts, LossAux(loss_cls, loss_iou, loss_dfl, fg_mask, bbox_weight, denom,
                                    target_bboxes)
    return loss, parts
