"""Training and eval steps (the JAX package's ``parallel/train_step.py``):
one device, or this rank's part of a data-parallel step (below).

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

A bfloat16 model (``Detector(dtype=torch.bfloat16)``: autocast over float32
weights) trains as the JAX package's bf16 step does: the warp gathers its
source in bf16 (the separable warp's two rolls run K3's bf16
instantiation), and the detector's outputs are widened to float32 before
the assigners and the loss. Weights, gradients and the optimizer stay
float32.

:func:`make_multi_train_step` runs K steps a call on a batch stacked by
:func:`stack_batches` (the JAX package's ``lax.scan`` dispatch), with the
EMA blended every step or once a call.

Data parallel (``group``, the process group of a mesh's "data" axis; M11):
each rank steps on its share of the global batch, and the step computes
the GLOBAL batch's step, as JAX's sharded jit does:
- the loss normalisers are the global batch's (``train/losses.py``), so
  each rank's loss is its share of the global loss;
- the gradients are SUMMED over the group, in one all-reduce of a flat
  buffer, before the optimizer: the sum of the shares' gradients is the
  global gradient, with no ``loss * world_size`` factor;
- with more than one rank, every BatchNorm (the teacher's too) normalises
  by the global batch's statistics (``parallel/batch_norm.py``), and the
  running statistics follow them, identically on every rank;
- the returned parts are summed over the group: the global batch's loss;
- on its first call with a model, the step copies rank 0's parameters,
  buffers and EMA to every rank (what DDP does when it wraps a model).
The step all-reduces the gradients itself rather than wrapping the model in
``DistributedDataParallel``: the state keeps the bare module, whose names
the optimizer, the EMA and the checkpoints key on; an unused parameter
(none is, in any mode) has a zero gradient here, where DDP would need
``find_unused_parameters``; the teacher is never wrapped; and DDP's
averaging would need a world-size factor in the loss. Every rank's model
updates identically, so the EMA of the bare module is the same on every
rank.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from .. import resolve_device
from ..events.core import EventBlock
from ..models.yolo import init_weights_
from ..ops.image import letterbox_image
from ..ops.warp import AugPlan, compose_warp, compose_warp_separable
from ..reps.dispatch import batched_representation
from ..reps.event_mosaic import mosaic_event_rep, supports_event_mosaic
from ..train.ema import EMAState, ema_init, ema_update, ema_update_k
from ..train.losses import LossConfig, detection_loss
from ..train.losses_variants import detection_loss_distill, detection_loss_fuseab
from ..utils.profiling import span
from .batch_norm import convert_global_batch_norm
from .dist import all_reduce, group_size


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


def _map_batch(fn, *batches: Batch) -> Batch:
    """``fn`` over the same leaf of each of ``batches`` (a field that is
    None stays None)."""
    out = []
    for vals in zip(*batches):
        v0 = vals[0]
        if v0 is None:
            out.append(None)
        elif isinstance(v0, EventBlock):
            out.append(EventBlock(**{f.name: fn(*(getattr(v, f.name) for v in vals))
                                     for f in dataclasses.fields(v0)}))
        elif isinstance(v0, AugPlan):
            out.append(AugPlan(*(None if a is None else fn(*(v[j] for v in vals))
                                 for j, a in enumerate(v0))))
        else:
            out.append(fn(*vals))
    return Batch(*out)


def stack_batches(batches) -> Batch:
    """Batches of one shape stacked along a new leading K axis, every leaf
    (event-block and plan fields included): NumPy leaves (the loader's) stay
    NumPy, tensors become a tensor. :func:`make_multi_train_step` moves the
    stack to the device in one go."""
    def stack(*xs):
        if all(torch.is_tensor(x) for x in xs):
            return torch.stack(xs)
        return np.stack([np.asarray(x) for x in xs])

    return _map_batch(stack, *batches)


def _bf16(model: nn.Module) -> bool:
    return getattr(model, "dtype", torch.float32) == torch.bfloat16


def _float32(outputs):
    """A nested tuple/list of outputs with every bf16 tensor widened to
    float32 (float32 and float64 ones as they are)."""
    if isinstance(outputs, (list, tuple)):
        return type(outputs)(_float32(o) for o in outputs)
    return outputs.float() if outputs.dtype == torch.bfloat16 else outputs


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
    group=None,
):
    """Build ``train_step(state, batch, epoch) -> (state, parts)`` on
    ``device`` (``cuda`` unless the caller asks for ``cpu``). With
    ``representation`` the step builds it from the batch's raw events;
    ``parts`` holds the loss and its weighted terms as 0-d tensors.
    ``mode``, ``teacher`` (the distillation teacher, a model on ``device``
    with its weights), ``max_epoch``, ``temperature`` and ``distill_feat``
    as the module docstring says. A bfloat16 model in the state takes the
    bf16 step (module docstring). With ``group`` the step is this rank's
    part of a data-parallel step over the group (module docstring); every
    rank of the group calls it on its own batch of one shape.

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
    global_bn = group_size(group) > 1
    if teacher is not None and global_bn:
        convert_global_batch_norm(teacher, group)
    synced = []  # the model whose state was copied from rank 0

    @torch.no_grad()
    def images_of(batch: Batch, gather_dtype: Optional[torch.dtype] = None):
        """(B, C, S, S) model input on the 0..1 scale (an NCHW view of an
        NHWC tensor), the warp's source gathered in ``gather_dtype``;
        nothing upstream of the detector needs a gradient. With the learned
        representation, the raw events."""
        if learned:
            return batch.events
        n_out = batch.gt_labels.shape[0]
        if batch.images is not None:
            img = batch.images
            if batch.aug is not None:
                img = warp(img, batch.aug, img_size, gather_dtype=gather_dtype)[:n_out] / 255.0
        elif batch.aug is not None and aug_mode == "event":
            img = mosaic_event_rep(batch.events, batch.aug, representation, (H, W),
                                   img_size)[:n_out] / 255.0
        else:
            img = letterbox_image(rep_fn(batch.events), img_size)
            if batch.aug is not None:
                # every pool row is composed (mixup partners need their own
                # composed output); only the labelled rows are emitted
                img = warp(img, batch.aug, img_size, gather_dtype=gather_dtype)[:n_out]
            img = img / 255.0
        return img.permute(0, 3, 1, 2)

    def loss_fn(model: nn.Module, imgs, batch: Batch, epoch: int):
        # a bf16 model's outputs reach the assigners and the loss in float32
        outputs = _float32(model(imgs))
        feats = outputs[0]
        feat_shapes = [tuple(f.shape[2:]) for f in feats]
        gt = (batch.gt_labels, batch.gt_bboxes, batch.gt_mask)
        if mode == "fuseab":
            _, cls_ab, reg_ab, cls, reg = outputs
            loss, parts = detection_loss((feats, cls, reg), *gt, feat_shapes, epoch, loss_cfg,
                                         group=group)
            loss_ab, parts_ab = detection_loss_fuseab(cls_ab, reg_ab, *gt, feat_shapes,
                                                      loss_cfg, na=model.head.na, group=group)
            return loss + loss_ab, dict(parts, **parts_ab)
        if mode == "distill":
            # a distill_ns head adds the ltrb branch: (feats, cls, reg_lrtb, reg_dist)
            ns = len(outputs) == 4
            with torch.no_grad(), _batch_stats_frozen(teacher.train()):
                t_out = _float32(teacher(imgs))
            return detection_loss_distill(
                (feats, outputs[1], outputs[-1]), (t_out[0], t_out[-2], t_out[-1]), *gt,
                feat_shapes, epoch, max_epoch,
                loss_cfg._replace(warmup_epoch=0) if ns else loss_cfg,
                temperature=temperature, distill_feat=distill_feat,
                reg_lrtb=outputs[2] if ns else None, group=group)
        return detection_loss(outputs, *gt, feat_shapes, epoch, loss_cfg, group=group)

    def apply_update(state: TrainState) -> TrainState:
        """The optimizer step on the gradients left by ``backward``, then
        the EMA blend (on every call, microsteps included)."""
        with span("step/update"):
            grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                     for n, p in state.model.named_parameters()}
            if group is not None:
                grads = _summed(grads, group)
            state.opt_state.update(grads)
        if update_ema:
            state.ema = ema_update(state.ema, state.model)
        state.step += 1
        return state

    def join(state: TrainState) -> None:
        """Once per model: global BatchNorm, and rank 0's state everywhere."""
        if group is None or (synced and synced[0] is state.model):
            return
        if global_bn:
            convert_global_batch_norm(state.model, group)
        _broadcast_state(state, group)
        synced[:] = [state.model]

    def train_step(state: TrainState, batch: Batch, epoch: int):
        with span("step"):
            join(state)
            with span("step/input"):
                batch = batch_on_device(batch, device)
                # a bf16 model: the warp's source in bf16 (JAX: _warp_gd)
                imgs = images_of(batch, torch.bfloat16 if _bf16(state.model) else None)
            model = state.model.train()
            model.zero_grad(set_to_none=True)
            with span("step/loss"):
                loss, parts = loss_fn(model, imgs, batch, epoch)
            with span("step/backward"):
                loss.backward()
            state = apply_update(state)
            parts = {k: v.detach() for k, v in parts.items()}
            parts["loss"] = loss.detach()
            if group is not None:  # the global batch's: the sum of the shares
                keys = list(parts)
                total = all_reduce(torch.stack([parts[k].float() for k in keys]), group)
                parts = dict(zip(keys, total.unbind()))
            return state, parts

    train_step.device = device
    train_step.rep_fn = rep_fn
    train_step.warp = warp
    train_step.images_of = images_of
    train_step.loss_fn = loss_fn
    train_step.apply_update = apply_update
    return train_step


def make_multi_train_step(loss_cfg: LossConfig, k: int, ema_cadence: str = "step", **kwargs):
    """K train steps a call (the JAX package's ``make_multi_train_step``;
    there one ``lax.scan`` dispatch). ``kwargs`` are
    :func:`make_train_step`'s (``mode``, ``teacher``, ``device`` ...); the
    model and the optimizer travel in the state, as for
    :func:`make_train_step`.

    ``multi_step(state, stacked, epoch) -> (state, parts)``: ``stacked`` is
    :func:`stack_batches` of K batches, moved to the step's device once;
    the K per-batch steps run in order on it, and each value of ``parts``
    is a (K,) tensor on the device. Nothing is read back to the host.
    ``ema_cadence="step"`` blends the EMA in every step; ``"dispatch"``
    blends it once at the end with :func:`..train.ema.ema_update_k` (the
    product of the K decays; the counter advances by K)."""
    if ema_cadence not in ("step", "dispatch"):
        raise ValueError(f"unknown ema_cadence {ema_cadence!r}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    step = make_train_step(loss_cfg, update_ema=ema_cadence == "step", **kwargs)

    def leading_k(a):
        if a.shape[0] != k:
            raise ValueError(f"stacked batch has leading dim {a.shape[0]}, "
                             f"expected steps_per_dispatch={k}")
        return a

    def multi_step(state: TrainState, stacked: Batch, epoch: int):
        stacked = batch_on_device(_map_batch(leading_k, stacked), step.device)
        parts = []
        for i in range(k):
            state, p = step(state, _map_batch(lambda a: a[i], stacked), epoch)
            parts.append(p)
        if ema_cadence == "dispatch":
            state.ema = ema_update_k(state.ema, state.model, k)
        return state, {key: torch.stack([p[key] for p in parts]) for key in parts[0]}

    multi_step.step = step
    return multi_step


def _summed(grads: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """The gradients summed over ``group`` in one all-reduce of a flat
    float32 buffer; the returned tensors are views of it."""
    names = list(grads)
    flat = torch.cat([grads[n].reshape(-1).float() for n in names])
    all_reduce(flat, group)
    views = flat.split([grads[n].numel() for n in names])
    return {n: v.view_as(grads[n]) for n, v in zip(names, views)}


@torch.no_grad()
def _broadcast_state(state: TrainState, group) -> None:
    """Rank 0's parameters, buffers and EMA on every rank of ``group``."""
    src = dist.get_global_rank(group, 0)
    for t in [*state.model.state_dict().values(), *state.ema.variables.values()]:
        dist.broadcast(t, src, group=group)


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
