"""Training and eval steps (the JAX package's ``parallel/train_step.py``,
one device).

One step: raw padded events -> the augmented model input -> /255 ->
detector in train mode -> ATSS/TAL assignment -> VFL + GIoU + DFL loss ->
backward -> 3-group SGD (with accumulation) -> EMA. The strong augmentation
(mosaic / affine / flip / mixup) is planned on the host
(``data/augment.py::plan_augment_batch``) and runs on the device in one of
two executors:
- ``aug_mode="image"``: ERGO-12 (kernel K1) -> letterbox -> the image warp
  (``ops/warp.py``; the separable executor rolls rows on kernel K3);
- ``aug_mode="event"``: ``reps/event_mosaic.py`` moves the events and builds
  the augmented representation in one K1 launch.
A batch without a plan (no strong aug, or the loader's event-space affine)
takes ERGO-12 -> letterbox. With the learned representation the detector
takes the raw events itself (``models/learned_repr.py``; no /255).

The modes of the JAX step:
- ``"plain"``;
- ``"fuseab"``: a fuse-ab-headed model; the anchor-base branch's loss
  (``detection_loss_fuseab``) is added to the anchor-free one;
- ``"distill"``: a frozen ``teacher`` model sees the same input in train
  mode (batch statistics) under ``no_grad``, its BatchNorm statistics left
  as they were (the JAX step discards the teacher's updates), and the
  student optimises ``detection_loss_distill``; a distill_ns student (a
  4-output head) assigns by TAL from the first step (``warmup_epoch=0``).

The JAX step is a pure function of (params, batch_stats, opt_state, ema);
here :class:`TrainState` carries the ``nn.Module`` (parameters and BatchNorm
statistics), the optimizer with its state, the EMA and the step count, and
the step updates them in place: a 140M-parameter model is not copied per
step. The step draws no random numbers: the plan arrives with the batch.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..events.core import EventBlock
from ..models.yolo import init_weights_
from ..ops.image import letterbox_image
from ..ops.warp import AugPlan, compose_warp, compose_warp_separable
from ..reps.dispatch import batched_representation
from ..reps.event_mosaic import mosaic_event_rep, supports_event_mosaic
from ..train.ema import EMAState, ema_init, ema_update
from ..train.losses import LossConfig, detection_loss
from ..train.losses_variants import detection_loss_distill, detection_loss_fuseab


@dataclasses.dataclass
class TrainState:
    model: nn.Module  # parameters + BatchNorm statistics
    opt_state: Any  # train/optim.py FusedSGD or MultiSteps, with its state
    ema: EMAState
    step: int = 0


class Batch(NamedTuple):
    """One batch: prebuilt images or raw event blocks, padded targets, and
    an optional strong-augmentation plan. Leaves may be NumPy arrays or
    tensors; :func:`batch_on_device` moves them."""

    images: Optional[Any]  # (B, S, S, C) 0..255 or None
    events: Optional[EventBlock]  # (P, N) blocks, P >= B (a partner pool), or None
    gt_labels: Any  # (B, M)
    gt_bboxes: Any  # (B, M, 4) xyxy pixels in the model frame
    gt_mask: Any  # (B, M)
    aug: Optional[AugPlan] = None


def _tensor(a, device, dtype=None):
    return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                           dtype=dtype).to(device)


def batch_on_device(batch: Batch, device) -> Batch:
    """Move every leaf to ``device``; event blocks in the compact wire
    dtypes are upcast to int32 (the single upcast site of the step)."""
    return Batch(
        images=None if batch.images is None else _tensor(batch.images, device, torch.float32),
        events=None if batch.events is None else batch.events.to(device).as_int32(),
        gt_labels=_tensor(batch.gt_labels, device, torch.int64),
        gt_bboxes=_tensor(batch.gt_bboxes, device, torch.float32),
        gt_mask=_tensor(batch.gt_mask, device, torch.float32),
        aug=None if batch.aug is None else batch.aug.to(device),
    )


LEARNED = "LearnedRepresentation"


def _check_modes(mode: str, aug_mode: str, representation: Optional[str]) -> None:
    if mode not in ("plain", "fuseab", "distill"):
        raise ValueError(f"unknown mode {mode!r}")
    if aug_mode not in ("image", "event"):
        raise ValueError(f"unknown aug_mode {aug_mode!r}")
    if aug_mode == "event" and not (representation and supports_event_mosaic(representation)):
        raise ValueError(
            f"aug_mode='event' needs an MDES/ERGO-12/histogram-family representation, "
            f"got {representation!r}")


def make_train_step(
    loss_cfg: LossConfig,
    representation: Optional[str] = None,
    rep_hw: Tuple[int, int] = (240, 304),
    img_size: int = 640,
    mode: str = "plain",
    aug_mode: str = "image",
    warp_impl: str = "exact",  # image executor: "exact" | "separable"
    update_ema: bool = True,
    device="cuda",
    teacher: Optional[nn.Module] = None,
    max_epoch: int = 300,
    temperature: float = 20.0,
    distill_feat: bool = False,
):
    """Build ``train_step(state, batch, epoch) -> (state, parts)`` on
    ``device`` (``cuda`` unless the caller asks for ``cpu``). With
    ``representation`` the step builds it from the batch's raw events;
    ``parts`` holds the loss and its weighted terms as 0-d tensors.
    ``mode``, ``teacher`` (the distillation teacher, a model on ``device``
    with its weights), ``max_epoch``, ``temperature`` and ``distill_feat``
    as the module docstring says.

    The returned function also carries the stages it composes
    (``rep_fn``, ``warp``, ``images_of``, ``loss_fn``, ``apply_update``),
    so a profiler can time them one by one."""
    _check_modes(mode, aug_mode, representation)
    if warp_impl not in ("exact", "separable"):
        raise ValueError(f"unknown warp_impl {warp_impl!r}")
    if (mode == "distill") != (teacher is not None):
        raise ValueError("mode='distill' needs a teacher, and only it takes one")
    device = resolve_device(device)
    H, W = rep_hw
    learned = representation == LEARNED
    rep_fn = (batched_representation(representation, H, W)
              if representation and not learned else None)
    warp = compose_warp_separable if warp_impl == "separable" else compose_warp

    @torch.no_grad()
    def images_of(batch: Batch):
        """(B, C, S, S) model input on the 0..1 scale (an NCHW view of an
        NHWC tensor); nothing upstream of the detector needs a gradient.
        With the learned representation, the raw events."""
        if learned:
            return batch.events
        n_out = batch.gt_labels.shape[0]
        if batch.images is not None:
            img = batch.images
            if batch.aug is not None:
                img = warp(img, batch.aug, img_size)[:n_out] / 255.0
        elif batch.aug is not None and aug_mode == "event":
            img = mosaic_event_rep(batch.events, batch.aug, representation, (H, W),
                                   img_size)[:n_out] / 255.0
        else:
            img = letterbox_image(rep_fn(batch.events), img_size)
            if batch.aug is not None:
                # every pool row is composed (mixup partners need their own
                # composed output); only the labelled rows are emitted
                img = warp(img, batch.aug, img_size)[:n_out]
            img = img / 255.0
        return img.permute(0, 3, 1, 2)

    def loss_fn(model: nn.Module, imgs, batch: Batch, epoch: int):
        outputs = model(imgs)
        feats = outputs[0]
        feat_shapes = [tuple(f.shape[2:]) for f in feats]
        gt = (batch.gt_labels, batch.gt_bboxes, batch.gt_mask)
        if mode == "fuseab":
            _, cls_ab, reg_ab, cls, reg = outputs
            loss, parts = detection_loss((feats, cls, reg), *gt, feat_shapes, epoch, loss_cfg)
            loss_ab, parts_ab = detection_loss_fuseab(cls_ab, reg_ab, *gt, feat_shapes,
                                                      loss_cfg, na=model.head.na)
            return loss + loss_ab, dict(parts, **parts_ab)
        if mode == "distill":
            # a distill_ns head adds the ltrb branch: (feats, cls, reg_lrtb, reg_dist)
            ns = len(outputs) == 4
            with torch.no_grad(), _batch_stats_frozen(teacher.train()):
                t_out = teacher(imgs)
            return detection_loss_distill(
                (feats, outputs[1], outputs[-1]), (t_out[0], t_out[-2], t_out[-1]), *gt,
                feat_shapes, epoch, max_epoch,
                loss_cfg._replace(warmup_epoch=0) if ns else loss_cfg,
                temperature=temperature, distill_feat=distill_feat,
                reg_lrtb=outputs[2] if ns else None)
        return detection_loss(outputs, *gt, feat_shapes, epoch, loss_cfg)

    def apply_update(state: TrainState) -> TrainState:
        """The optimizer step on the gradients left by ``backward``, then
        the EMA blend (on every call, microsteps included)."""
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in state.model.named_parameters()}
        state.opt_state.update(grads)
        if update_ema:
            state.ema = ema_update(state.ema, state.model)
        state.step += 1
        return state

    def train_step(state: TrainState, batch: Batch, epoch: int):
        if getattr(state.model, "dtype", torch.float32) != torch.float32:
            raise NotImplementedError(
                "a bfloat16 train step is not ported (ROADMAP M20: K3 in bf16)")
        batch = batch_on_device(batch, device)
        imgs = images_of(batch)
        model = state.model.train()
        model.zero_grad(set_to_none=True)
        loss, parts = loss_fn(model, imgs, batch, epoch)
        loss.backward()
        state = apply_update(state)
        parts = {k: v.detach() for k, v in parts.items()}
        parts["loss"] = loss.detach()
        return state, parts

    train_step.rep_fn = rep_fn
    train_step.warp = warp
    train_step.images_of = images_of
    train_step.loss_fn = loss_fn
    train_step.apply_update = apply_update
    return train_step


@contextlib.contextmanager
def _batch_stats_frozen(model: nn.Module):
    """A train-mode forward of ``model`` inside normalises by batch
    statistics and leaves the running statistics and counters as they
    were: every BatchNorm stops tracking them for the while."""
    bns = [m for m in model.modules()
           if isinstance(m, nn.modules.batchnorm._BatchNorm) and m.track_running_stats]
    for m in bns:
        m.track_running_stats = False
    try:
        yield
    finally:
        for m in bns:
            m.track_running_stats = True


def make_eval_step(model: nn.Module, representation: Optional[str] = None,
                   rep_hw: Tuple[int, int] = (240, 304), img_size: int = 640, device="cuda"):
    """``eval_step(variables, batch) -> (B, A, 5 + nc)`` decoded predictions
    of ``model`` in eval mode, with ``variables`` (a state dict such as
    ``state.ema.variables``) in place of the model's own tensors, or the
    model's own with ``variables=None``."""
    device = resolve_device(device)
    H, W = rep_hw
    learned = representation == LEARNED
    rep_fn = (batched_representation(representation, H, W)
              if representation and not learned else None)

    @torch.inference_mode()
    def eval_step(variables: Optional[Dict[str, torch.Tensor]], batch: Batch):
        batch = batch_on_device(batch, device)
        model.eval()
        if learned:  # the quantization layer inside the model; no /255
            x = batch.events
        else:
            if batch.images is not None:
                imgs = batch.images
            else:
                imgs = letterbox_image(rep_fn(batch.events), img_size) / 255.0
            x = imgs.permute(0, 3, 1, 2)
        if variables is None:
            return model(x)
        return torch.func.functional_call(model, variables, (x,), strict=False)

    return eval_step


def init_train_state(model: nn.Module, tx, generator: Optional[torch.Generator] = None
                     ) -> TrainState:
    """The state of a fresh run: ``model`` initialised from ``generator``
    (Flax's init rules) when one is given, the optimizer ``tx`` built on
    it, and an EMA copy of its state."""
    if generator is not None:
        init_weights_(model, generator)
    return TrainState(model, tx, ema_init(model), 0)
