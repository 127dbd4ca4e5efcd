"""Loss variants (the JAX package's ``train/losses_variants.py``; ev-YOLOv6's
``loss_fuseab.py``, ``loss_distill.py`` and ``loss_distill_ns.py``):

- :func:`detection_loss_fuseab`: the anchor-base branch of the fuse-ab
  head. TAL with ``topk=26`` on xywh boxes (the xy offsets added to the
  anchor points), varifocal + IoU, no DFL.
- :func:`kd_cls_loss`, :func:`kd_dfl_loss`, :func:`kd_cw_loss`: class KL,
  positive-anchor DFL KL and channel-wise feature KD.
- :func:`detection_loss_distill`: the base loss, sharing its assigner pass
  (``detection_loss(..., return_aux=True)``), plus the KD terms decayed by
  :func:`distill_weight_decay`; with ``reg_lrtb`` the nano/small variant.

Feature maps are NCHW here; the JAX package's are NHWC. Either way
:func:`kd_cw_loss` takes a softmax over each channel's H * W positions.

Under a data-parallel step (``group``) every term must be the rank's share
of the global batch's term, since the step sums the ranks' gradients
(``train/losses.py``): a batch sum over a batch statistic divides by the
statistic's global value (the target-score sums; the positive count and
target-weight sum of :func:`kd_dfl_loss`; the images of :func:`kd_cw_loss`,
a mean over the batch), and a plain sum (:func:`kd_cls_loss`) needs
nothing.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..ops.boxes import dist2bbox, iou_loss
from ..parallel.dist import global_sum
from .anchors import generate_anchors_train
from .assigners import task_aligned_assigner
from .losses import LossConfig, detection_loss, varifocal_loss

EPS = 1e-12


def _xywh2xyxy(b):
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def detection_loss_fuseab(
    cls_ab,  # (B, na * A, nc) sigmoid scores
    reg_ab,  # (B, na * A, 4) xywh in grid units, wh anchor-scaled
    gt_labels,
    gt_bboxes,  # (B, M, 4) xyxy image pixels
    gt_mask,
    feat_shapes: Sequence[Tuple[int, int]],
    cfg: LossConfig,
    na: int = 1,
    tal_topk: int = 26,
    group=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The anchor-base branch loss. The head flattens each level anchor by
    anchor, so each level's points are tiled na times ([pts; pts; pts]), not
    repeated point by point."""
    dev = cls_ab.device
    _, anchor_points, _, stride_tensor = generate_anchors_train(feat_shapes, cfg.strides,
                                                                device=dev)
    if na > 1:
        pts, sts, off = [], [], 0
        for h, w in feat_shapes:
            n = h * w
            pts.append(anchor_points[off:off + n].repeat(na, 1))
            sts.append(stride_tensor[off:off + n].repeat(na, 1))
            off += n
        anchor_points, stride_tensor = torch.cat(pts), torch.cat(sts)
    anchor_points_s = anchor_points / stride_tensor
    pred_bboxes = _xywh2xyxy(torch.cat([reg_ab[..., :2] + anchor_points_s[None],
                                        reg_ab[..., 2:]], -1))  # grid units

    gt_labels_ = gt_labels[..., None].to(torch.float32)
    mask_gt = gt_mask[..., None].to(torch.float32)
    target_labels, target_bboxes, target_scores, fg_mask = task_aligned_assigner(
        cls_ab.detach(), pred_bboxes.detach() * stride_tensor, anchor_points, gt_labels_,
        gt_bboxes, mask_gt, topk=tal_topk)
    target_bboxes = target_bboxes / stride_tensor

    tl = torch.where(fg_mask, target_labels, cfg.num_classes)
    one_hot = F.one_hot(tl, cfg.num_classes + 1)[..., : cfg.num_classes].to(cls_ab.dtype)
    tss = global_sum(target_scores.sum(), group)
    denom = torch.where(tss > 1, tss, 1.0)
    loss_cls = varifocal_loss(cls_ab, target_scores, one_hot) / denom
    bbox_weight = target_scores.sum(-1) * fg_mask
    iou_v = iou_loss(pred_bboxes, target_bboxes, cfg.iou_type)
    loss_iou = ((1.0 - iou_v) * bbox_weight).sum() / denom
    loss = cfg.weight_class * loss_cls + cfg.weight_iou * loss_iou
    return loss, {
        "ab_cls": cfg.weight_class * loss_cls,
        "ab_iou": cfg.weight_iou * loss_iou,
        "ab_num_pos": fg_mask.sum().to(torch.float32),
    }


def distill_weight_decay(epoch, max_epoch: int) -> torch.Tensor:
    """The cosine decay 1 -> 0.01 over ``max_epoch`` of every KD term:
    ((1 - cos(e pi / E)) / 2) (0.01 - 1) + 1, in float32."""
    e = torch.as_tensor(epoch, dtype=torch.float32)
    return ((1.0 - torch.cos(e * math.pi / max_epoch)) / 2.0) * (0.01 - 1.0) + 1.0


def _kl(p_t, log_p_s):
    return p_t * (torch.log(p_t.clamp_min(EPS)) - log_p_s)


def kd_cls_loss(s_scores, t_scores, temperature):
    """KL(teacher || student) of the softmax over classes of the sigmoid
    scores / T, summed over all anchors and classes, times T^2."""
    nc = s_scores.shape[-1]
    log_p_s = F.log_softmax(s_scores.reshape(-1, nc) / temperature, dim=-1)
    p_t = F.softmax(t_scores.detach().reshape(-1, nc) / temperature, dim=-1)
    return _kl(p_t, log_p_s).sum() * temperature ** 2


def kd_dfl_loss(s_dist, t_dist, fg_mask, bbox_weight, denom, reg_max: int, temperature,
                group=None):
    """The bin KL x T^2 of the DFL distributions, its mean over the positive
    anchors and 4 sides, weighted by the positives' target-score sum over
    ``denom`` (the global one under ``group``, as the positive count and
    the weight sum are made here)."""
    b, a, _ = s_dist.shape
    log_p_s = F.log_softmax(s_dist.reshape(b, a, 4, reg_max + 1) / temperature, dim=-1)
    p_t = F.softmax(t_dist.detach().reshape(b, a, 4, reg_max + 1) / temperature, dim=-1)
    kl = _kl(p_t, log_p_s).sum(-1)  # (B, A, 4)
    fg = fg_mask.to(torch.float32)
    n_pos = global_sum(fg.sum(), group).clamp_min(1.0)
    scalar = (kl.mean(-1) * fg).sum() / n_pos * temperature ** 2
    return scalar * global_sum(bbox_weight.sum(), group) / denom


def kd_cw_loss(s_feats, t_feats, temperature: float = 1.0, group=None):
    """Channel-wise feature KD on the first three levels: per (image,
    channel) a softmax over the H * W positions, KL(student || teacher as
    log target) summed, over (B * C), times T^2; B is the global batch's
    image count under ``group``."""
    total = torch.zeros((), device=s_feats[0].device)
    b = s_feats[0].shape[0]
    if group is not None:  # the global image count, kept on the device
        b = global_sum(torch.tensor(float(b), device=total.device), group)
    for s, t in zip(s_feats[:3], t_feats[:3]):
        _, c, h, w = s.shape
        log_p_s = F.log_softmax(s.reshape(-1, c, h * w) / temperature, dim=-1)
        log_p_t = F.log_softmax(t.detach().reshape(-1, c, h * w) / temperature, dim=-1)
        kl = (log_p_t.exp() * (log_p_t - log_p_s)).sum()
        total = total + kl * temperature ** 2 / (b * c)
    return total


def detection_loss_distill(
    student_outputs,  # (feats, cls, reg_distri)
    teacher_outputs,  # (feats, cls, reg_distri), detached here
    gt_labels,
    gt_bboxes,
    gt_mask,
    feat_shapes: Sequence[Tuple[int, int]],
    epoch,
    max_epoch: int,
    cfg: LossConfig,
    temperature: float = 20.0,
    distill_feat: bool = False,
    weight_cwd: float = 10.0,
    distill_weight_class: float = 1.0,
    distill_weight_dfl: float = 1.0,
    reg_lrtb=None,
    group=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """class (cls + dw d_cls) + iou iou + dfl (dfl + dw d_dfl) + cwd dw d_cw,
    dw the decay of :func:`distill_weight_decay`. ``reg_lrtb`` (B, A, 4),
    the student's direct box branch, adds a second IoU term on the same
    assignment (the nano/small variant; callers pass ``warmup_epoch=0``,
    as that variant always assigns by TAL). ``group`` as the module
    docstring says."""
    _, parts, aux = detection_loss(student_outputs, gt_labels, gt_bboxes, gt_mask, feat_shapes,
                                   epoch, cfg, return_aux=True, group=group)
    raw_iou = aux.raw_iou
    if reg_lrtb is not None:
        _, anchor_points, _, stride_tensor = generate_anchors_train(
            feat_shapes, cfg.strides, device=reg_lrtb.device)
        iou_v = iou_loss(dist2bbox(reg_lrtb, anchor_points / stride_tensor), aux.target_bboxes,
                         cfg.iou_type)
        raw_iou = raw_iou + ((1.0 - iou_v) * aux.bbox_weight).sum() / aux.denom
    s_feats, s_cls, s_dist = student_outputs
    t_feats, t_cls, t_dist = teacher_outputs
    zero = torch.zeros((), device=s_cls.device)
    dw = distill_weight_decay(epoch, max_epoch).to(s_cls.device)
    d_cls = kd_cls_loss(s_cls, t_cls, temperature) * dw
    d_dfl = (kd_dfl_loss(s_dist, t_dist, aux.fg_mask, aux.bbox_weight, aux.denom, cfg.reg_max,
                         temperature, group) if cfg.use_dfl else zero) * dw
    d_cw = (kd_cw_loss(s_feats, t_feats, group=group) if distill_feat else zero) * dw
    loss_cls_all = aux.raw_cls + d_cls * distill_weight_class
    loss_dfl_all = aux.raw_dfl + d_dfl * distill_weight_dfl
    loss = (cfg.weight_class * loss_cls_all + cfg.weight_iou * raw_iou
            + cfg.weight_dfl * loss_dfl_all + weight_cwd * d_cw)
    parts = dict(parts, kd_cls=d_cls, kd_dfl=d_dfl, kd_cw=d_cw,
                 cls=cfg.weight_class * loss_cls_all, iou=cfg.weight_iou * raw_iou,
                 dfl=cfg.weight_dfl * loss_dfl_all)
    return loss, parts
