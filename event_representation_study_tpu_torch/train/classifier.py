"""Classification trainer (the JAX package's ``train/classifier.py``, the
equivalent of the n_imagenet ``base`` framework + ``CNNTrainer``,
n_imagenet/base/train/*, real_cnn_model/train/trainer.py): cross-entropy +
Adam/SGD, top-1/top-5 accuracy, an epoch loop with val accuracy as the
checkpoint criterion. The representation is built on the device for the
whole batch (``batched_representation``: ERGO-12 on kernel K1) where the
reference burns CPU workers per item (imagenet.py loader fns).

Optimizers follow the JAX package's optax chains: Adam is ``optax.adam``
(no weight decay), SGD is ``add_decayed_weights`` then momentum ``sgd``
(torch's ``SGD`` with ``weight_decay`` and ``momentum`` is the same
update). Frozen parameters (``freeze_labels``) get no update; the
BatchNorm statistics still move in train mode, as Flax's do.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..data.nimagenet import IMAGE_H, IMAGE_W, NImageNetDataset
from ..events.core import EventBlock
from ..models.resnet import init_weights_
from ..reps.dispatch import batched_representation
from ..utils.profiling import span

FREEZE_MODES = ("none", "all_except_fc", "all_except_conv1_fc")


def freeze_labels(model: nn.Module, mode: str) -> Dict[str, str]:
    """Parameter freeze options (model_container.py:70-87): 'none',
    'all_except_fc' (linear probe), 'all_except_conv1_fc' (stem + head);
    parameter name -> "train" | "frozen", by its top-level module."""
    if mode not in FREEZE_MODES:
        raise ValueError(f"unknown freeze mode: {mode}")
    keep = {"none": None, "all_except_fc": ("fc",),
            "all_except_conv1_fc": ("fc", "conv1", "bn1")}[mode]
    return {name: "train" if keep is None or name.split(".")[0] in keep else "frozen"
            for name, _ in model.named_parameters()}


class PlateauScheduler:
    """ReduceLROnPlateau with torch-exact semantics, as the reference
    installs it (n_imagenet base/train/common_trainer.py:75-77:
    ``ReduceLROnPlateau(optimizer, "max", patience=3)``): scale lr by
    ``factor`` once MORE than ``patience`` consecutive epochs pass without
    relative improvement (torch's default rel threshold 1e-4:
    a > best * (1 + 1e-4) in max mode)."""

    def __init__(self, lr: float, mode: str = "max", factor: float = 0.1,
                 patience: int = 3, min_lr: float = 0.0,
                 threshold: float = 1e-4):
        self.lr = lr
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.threshold = threshold
        self.best = -np.inf if mode == "max" else np.inf
        self.bad = 0

    def step(self, metric: float) -> float:
        if self.mode == "max":
            improved = metric > self.best * (1.0 + self.threshold) \
                if np.isfinite(self.best) else True
        else:
            improved = metric < self.best * (1.0 - self.threshold) \
                if np.isfinite(self.best) else True
        if improved:
            self.best = metric
            self.bad = 0
        else:
            self.bad += 1
            if self.bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad = 0
        return self.lr


def topk_accuracy(logits: np.ndarray, labels: np.ndarray, k: int = 1) -> float:
    """top-k accuracy (n_imagenet trainer ``accuracy``)."""
    topk = np.argsort(-logits, axis=-1)[:, :k]
    return float(np.mean((topk == labels[:, None]).any(-1)))


def _blocks(ev: np.ndarray, num: np.ndarray) -> EventBlock:
    """The batched :class:`EventBlock` of ``(B, 4, N)`` int32 events."""
    return EventBlock(x=ev[:, 0], y=ev[:, 1], t=ev[:, 2], p=ev[:, 3], num=num)


class ClassifierTrainer:
    def __init__(
        self,
        model: nn.Module,
        representation: Optional[str],
        num_classes: int,
        optimizer: str = "Adam",
        lr: float = 3e-4,
        momentum: float = 0.9,
        weight_decay: float = 1e-4,
        seed: int = 1,
        freeze: str = "none",
        plateau: bool = False,
        device="cuda",
    ):
        """``representation=None`` runs the prebuilt-image path (the original
        host loader types, nimagenet_loaders.py). ``freeze`` picks the
        model_container.py:70-87 options; ``plateau`` installs
        ReduceLROnPlateau driven by val top-1 (call :meth:`plateau_step`).
        ``seed`` seeds the model's initialisation (:meth:`init`) and the
        epoch shuffle. Runs on ``device`` (``cuda`` unless the caller passes
        ``"cpu"``)."""
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.representation = representation
        self.num_classes = num_classes
        self.plateau = PlateauScheduler(lr) if plateau else None
        self.optimizer_name = optimizer
        self.lr, self.momentum, self.weight_decay = lr, momentum, weight_decay
        self.freeze = freeze_labels(model, freeze)
        self.rep_fn = (batched_representation(representation, IMAGE_H, IMAGE_W)
                       if representation else None)
        self.seed = seed
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.step = 0

    def init(self) -> None:
        """Draw the model's weights (Flax's default initialisation, from a
        generator seeded with ``seed``) and build the optimizer over the
        parameters that are not frozen."""
        init_weights_(self.model, torch.Generator(device=self.device).manual_seed(self.seed))
        params = []
        for name, p in self.model.named_parameters():
            p.requires_grad_(self.freeze[name] == "train")
            if p.requires_grad:
                params.append(p)
        if self.optimizer_name.lower() == "adam":
            self.optimizer = torch.optim.Adam(params, lr=self.lr)
        else:
            self.optimizer = torch.optim.SGD(params, lr=self.lr, momentum=self.momentum,
                                             weight_decay=self.weight_decay)
        self.step = 0

    def images_of(self, batch) -> torch.Tensor:
        """(B, C, H, W) float32 model input: the representation of a batched
        :class:`EventBlock` / 255, or prebuilt host images as they are."""
        imgs = batch if self.rep_fn is None else self.rep_fn(batch) / 255.0
        return imgs.permute(0, 3, 1, 2)

    def train_step(self, batch, labels: torch.Tensor):
        """One update; returns (loss, logits) of the batch before it."""
        with span("classify/step"):
            self.model.train()
            logits = self.model(self.images_of(batch))
            loss = F.cross_entropy(logits, labels)
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            self.optimizer.step()
            self.step += 1
            return loss.detach(), logits.detach()

    @torch.no_grad()
    def eval_step(self, batch) -> torch.Tensor:
        self.model.eval()
        return self.model(self.images_of(batch))

    # -- checkpointing (trainer.py:145-218 save-by-epoch tars) -------------
    def save(self, path, epoch: int = 0):
        from .checkpoint import save_model_checkpoint

        save_model_checkpoint(path, self.model, self.optimizer, self.step, epoch)

    def load(self, path) -> int:
        from .checkpoint import restore_model_checkpoint

        self.step, start_epoch = restore_model_checkpoint(path, self.model, self.optimizer)
        return start_epoch

    def plateau_step(self, val_metric: float):
        """Apply ReduceLROnPlateau: writes the (possibly reduced) lr into the
        optimizer."""
        if self.plateau is None:
            return None
        new_lr = self.plateau.step(val_metric)
        for group in self.optimizer.param_groups:
            group["lr"] = new_lr
        return new_lr

    @staticmethod
    def _collate(samples):
        ev = np.stack([s.events for s in samples])
        num = np.array([s.num_events for s in samples], np.int32)
        labels = np.array([s.label for s in samples], np.int64)
        return _blocks(ev, num), labels

    def _batch_of(self, ds, indices):
        """The batch on the device and its labels on the host, assembled on
        the dataset module's worker processes (``NImageNetDataset.batch``)."""
        if self.rep_fn is None:
            imgs = ds.host_images(indices)
            labels = np.array([ds.labels[int(i)] for i in indices], np.int64)
            return torch.from_numpy(imgs).to(self.device), labels
        ev, num, labels = ds.batch(indices)
        return _blocks(ev, num).to(self.device), labels

    def run_epoch(self, ds: NImageNetDataset, batch_size: int, train: bool = True,
                  rng: np.random.Generator = None) -> Dict[str, float]:
        """One pass over ``ds``. Returns top1/top5 (+ loss when training)
        plus the reference's load-vs-infer timing split: n_imagenet's
        MiniBatchTracker brackets data loading and inference with separate
        timers (base/utils/tracker.py:1-60, minibatch_trainer.py's
        start_load_timing/start_infer_timing); here ``load_s`` is the step
        thread's wall time on the host batch (its wait on the workers'
        decode and prep, the copy to the device) and
        ``infer_s`` the device step including the readback that forces
        completion."""
        rng = rng or np.random.default_rng(self.seed)
        order = np.arange(len(ds))
        if train:
            rng.shuffle(order)
        losses, top1, top5, seen = [], 0.0, 0.0, 0
        load_s = infer_s = 0.0
        for b0 in range(0, len(order), batch_size):
            sel = order[b0: b0 + batch_size]
            real = len(sel)
            if real < batch_size:
                if train:
                    break  # training drops the tail (reference drop_last)
                # eval pads the tail batch to the batch shape and counts
                # only the real rows: common_trainer evaluates every sample
                sel = np.concatenate([sel, np.repeat(sel[-1:], batch_size - real)])
            t0 = time.perf_counter()
            batch, labels = self._batch_of(ds, sel)
            t1 = time.perf_counter()
            load_s += t1 - t0
            if train:
                loss, logits = self.train_step(
                    batch, torch.from_numpy(labels).to(self.device))
            else:
                logits = self.eval_step(batch)
            with span("classify/readback"):  # readback = device sync
                if train:
                    losses.append(float(loss))
                lg = logits[:real].cpu().numpy()
            infer_s += time.perf_counter() - t1
            labels = labels[:real]
            top1 += topk_accuracy(lg, labels, 1) * real
            top5 += topk_accuracy(lg, labels, min(5, self.num_classes)) * real
            seen += real
        out = {
            "top1": top1 / seen if seen else float("nan"),
            "top5": top5 / seen if seen else float("nan"),
            "load_s": round(load_s, 4),
            "infer_s": round(infer_s, 4),
        }
        if losses:
            out["loss"] = float(np.mean(losses))
        return out
