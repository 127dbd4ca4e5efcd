"""Fixed-shape batched NMS (the JAX package's ``ops/nms.py``).

obj*cls scoring, multi-label expansion (every (anchor, class) with score >
``conf_thres`` is a candidate), the class-offset trick so IoU never crosses
classes, greedy suppression at IoU > ``iou_thres``, at most ``MAX_DET``
detections. A static top-``PRE_NMS_TOPK`` candidate set feeds a masked
greedy loop, all on the device with no host round trip.

Returns ``(dets, num)``: dets (B, MAX_DET, 6) = [x1 y1 x2 y2 score cls],
zero-padded, and num (B,) valid counts.
"""
from __future__ import annotations

import torch

from .boxes import box_iou_pairwise, xywh2xyxy

MAX_WH = 7680.0  # class offset
IOU_THRES = 0.65
MAX_DET = 300
PRE_NMS_TOPK = 2048


def non_max_suppression(
    prediction: torch.Tensor,  # (B, A, 5 + nc) [cx cy w h obj cls...]
    conf_thres: float = 0.03,
    iou_thres: float = IOU_THRES,
):
    B, A, _ = prediction.shape
    nc = prediction.shape[-1] - 5
    dev = prediction.device
    boxes = xywh2xyxy(prediction[..., :4])  # (B, A, 4)
    scores = prediction[..., 5:] * prediction[..., 4:5]  # (B, A, nc)
    # multi-label: every (anchor, class) pair is a candidate, anchor-major
    flat_scores = scores.reshape(B, -1)
    a_idx = torch.arange(A, device=dev).repeat_interleave(nc).expand(B, -1)
    c_idx = torch.arange(nc, device=dev).repeat(A).expand(B, -1)
    flat_scores = torch.where(flat_scores > conf_thres, flat_scores, 0.0)

    k = min(PRE_NMS_TOPK, flat_scores.shape[1])
    top_scores, top = torch.topk(flat_scores, k, dim=1)
    top_boxes = boxes.gather(1, a_idx.gather(1, top)[..., None].expand(-1, -1, 4))
    top_cls = c_idx.gather(1, top).to(prediction.dtype)
    alive = top_scores > conf_thres

    off = top_cls[..., None] * MAX_WH
    iou = box_iou_pairwise(top_boxes + off, top_boxes + off)  # (B, k, k)

    ar = torch.arange(k, device=dev)
    bidx = torch.arange(B, device=dev)
    sel_idx = torch.full((B, MAX_DET), -1, dtype=torch.int64, device=dev)
    sel_n = torch.zeros(B, dtype=torch.int32, device=dev)
    for i in range(MAX_DET):
        s = torch.where(alive, top_scores, -1.0)
        pick = s.argmax(dim=1)  # first maximal index, as lax.argmax
        ok = s[bidx, pick] > 0
        sel_idx[:, i] = torch.where(ok, pick, -1)
        sel_n += ok.to(torch.int32)
        suppress = iou[bidx, pick] > iou_thres
        alive = alive & ~suppress & (ar[None] != pick[:, None]) & ok[:, None]

    safe = sel_idx.clamp(min=0)
    dets = torch.cat(
        [
            top_boxes.gather(1, safe[..., None].expand(-1, -1, 4)),
            top_scores.gather(1, safe)[..., None],
            top_cls.gather(1, safe)[..., None],
        ],
        dim=-1,
    )
    dets = torch.where((sel_idx >= 0)[..., None], dets, 0.0)
    return dets, sel_n
