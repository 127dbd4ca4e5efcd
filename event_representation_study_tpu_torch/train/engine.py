"""Training engine (the JAX package's ``train/engine.py::Trainer`` on one
device; the equivalent of ev-YOLOv6/yolov6/core/engine.py).

Per epoch: the loader's batches go through the train step (events ->
augmented representation -> forward -> assign -> loss -> backward -> SGD ->
EMA, all on the device), loss parts are logged every ``log_interval`` steps,
and the reference's eval cadence applies: every epoch for the first
``eval_interval_first`` epochs, then every ``eval_interval``-th and the last
(engine.py:165-195). Evaluation runs on the EMA weights and writes the
``last_ckpt`` and, on a better AP, the ``best_ckpt`` (engine.py:272-318).

The JAX Trainer's variants: ``fuse_ab`` (the anchor-base auxiliary head and
loss), ``distill`` (a frozen teacher of the same config, loaded from
``teacher_ckpt`` or, without one, initialised from ``seed + 1``; the
nano/small models, ``model.type`` YOLOv6n/s, take the distill_ns head),
``quant_calib`` (:meth:`Trainer.calibrate`: PTQ instead of training) and the
learned representation (raw events into the detector; flips only).

With ``steps_per_dispatch`` K > 1 an epoch groups K loader batches, stacks
them and trains each group in one K-step call (the JAX Trainer's
``lax.scan`` dispatch; ``parallel/train_step.py::make_multi_train_step``),
with the EMA blended every step (``ema_cadence="step"``) or once a call
(``"dispatch"``); the fewer than K batches left at the end of an epoch go
through the per-batch step, which blends the EMA itself. Metrics go to
``metrics.jsonl`` and, with the config's ``use_tensorboard`` /
``use_wandb``, to TensorBoard event files and a wandb run
(``utils/observability.py``).
"""
from __future__ import annotations

import pathlib
import time
from typing import Dict, Optional

import torch

from .. import resolve_device
from ..data.gen1 import Gen1H5
from ..data.loader import EventBatchLoader
from ..models import build_model
from ..models.yolo import init_weights_
from ..ops.warp import separable_hyp_eligible
from ..parallel.train_step import (
    LEARNED,
    init_train_state,
    make_multi_train_step,
    make_train_step,
    stack_batches,
)
from ..reps.dispatch import REPRESENTATION_CHANNELS
from ..reps.event_mosaic import supports_event_mosaic
from ..utils.logging import get_logger
from ..utils.observability import MultiWriter
from ..utils.profiling import get_model_info
from .checkpoint import (
    load_model_variables,
    load_teacher_variables,
    save_checkpoint,
    save_quantized_checkpoint,
)
from .evaler import Evaler
from .losses import LossConfig
from .optim import SolverConfig, accumulation_steps, build_optimizer, with_accumulation

LOGGER = get_logger("engine")


def _unported(data_type: str, representation: Optional[str], fuse_ab: bool, distill: bool,
              augment: bool, plot_images: bool) -> None:
    if distill and fuse_ab:
        # engine.py:78-80: "Distill models should turn off the fuse_ab"
        raise ValueError("distill and fuse_ab are mutually exclusive")
    if representation == LEARNED and augment:
        raise ValueError("strong aug warps representation images; the learned "
                         "representation consumes raw events (use flips only)")
    if data_type == "images":
        raise NotImplementedError("image-folder datasets are not ported (ROADMAP M19)")
    if plot_images:
        raise NotImplementedError("train/val plots are not ported (ROADMAP M19, utils/viz)")


class Trainer:
    def __init__(
        self,
        cfg: Dict,
        data_root,
        batch_size: int = 32,
        epochs: int = 100,
        img_size: Optional[int] = None,
        output_dir: str = "runs/train/exp",
        eval_interval: int = 10,
        eval_interval_first: int = 20,
        num_events: Optional[int] = None,
        seed: int = 0,
        augment: bool = False,
        stop_aug_last_n_epoch: int = 15,
        nominal_batch_size: int = 64,
        plot_images: bool = False,
        partner_pool: int = 0,
        steps_per_dispatch: int = 1,
        fuse_ab: bool = False,
        distill: bool = False,
        distill_feat: bool = False,
        temperature: float = 20.0,
        teacher_ckpt: Optional[str] = None,
        quant_calib: bool = False,
        aug_mode: str = "auto",
        ema_cadence: str = "step",
        eval_task: str = "val",  # "test" for --testing (engine.py:603-623)
        device="cuda",
    ):
        """The JAX Trainer's arguments, plus ``device`` (``cuda`` unless the
        caller asks for ``cpu``); ``img_size`` defaults to the config's
        ``data.img_size`` (640, or 576 for the ResNet and Swin configs)."""
        data = cfg.get("data", {})
        self.data_type = data.get("type", "gen1")
        self.representation = data.get("representation", "OptimizedRepresentation")
        _unported(self.data_type, self.representation, fuse_ab, distill, augment, plot_images)
        self.learned = self.representation == LEARNED
        self.quant_calib = quant_calib
        self.device = resolve_device(device)
        self.cfg = cfg
        self.epochs = epochs
        self.img_size = img_size = img_size or data.get("img_size", 640)
        self.output_dir = pathlib.Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.eval_interval = eval_interval
        self.eval_interval_first = eval_interval_first
        self.stop_aug_last_n_epoch = stop_aug_last_n_epoch

        nc = data.get("num_classes", 2)
        ne = num_events or data.get("num_events", 50000)
        aug = cfg.get("data_aug", {})
        self.train_ds = Gen1H5(data_root, task="train", num_events=ne)
        self.val_ds = Gen1H5(data_root, task=eval_task, num_events=ne)
        # --augment enables the full recipe (mosaic/affine/flips/mixup),
        # planned on the host and executed on the device
        self.train_loader = EventBatchLoader(
            self.train_ds, batch_size, img_size=img_size, shuffle=True, seed=seed,
            flipud=aug.get("flipud", 0.0), fliplr=aug.get("fliplr", 0.0),
            hyp=dict(aug) if augment else None,
            # dataset-wide mosaic/mixup partner draws (0 = in-batch)
            partner_pool=partner_pool if augment else 0,
        )
        self.val_loader = EventBatchLoader(self.val_ds, batch_size, img_size=img_size,
                                           shuffle=False, drop_last=False)

        solver = cfg.get("solver", {})
        # gradient accumulation to the nominal effective batch (engine.py:526:
        # accumulate = max(1, round(64/batch))); the schedules count optimizer
        # updates, so steps_per_epoch shrinks by k
        self.accumulate = accumulation_steps(batch_size, nominal_batch_size)
        self.solver_cfg = SolverConfig(
            lr0=solver.get("lr0", 0.0032),
            lrf=solver.get("lrf", 0.12),
            momentum=solver.get("momentum", 0.843),
            weight_decay=solver.get("weight_decay", 0.00036),
            warmup_epochs=solver.get("warmup_epochs", 2.0),
            warmup_momentum=solver.get("warmup_momentum", 0.5),
            warmup_bias_lr=solver.get("warmup_bias_lr", 0.05),
            epochs=epochs,
            steps_per_epoch=max(len(self.train_loader) // self.accumulate, 1),
            momentum_dtype=solver.get("momentum_dtype", "float32"),
        )
        head = cfg["model"]["head"]
        self.loss_cfg = LossConfig(
            num_classes=nc,
            strides=tuple(head.get("strides", (8, 16, 32, 64))),
            reg_max=head.get("reg_max", 16),
            use_dfl=head.get("use_dfl", True),
            iou_type=head.get("iou_type", "giou"),
            warmup_epoch=head.get("atss_warmup_epoch", 4),
        )
        # the reference ramps accumulate 1 -> 64/bs over the warmup
        # (engine.py:528-534); the ramp counts microsteps (batches), unlike
        # the update-counted LR and momentum schedules
        self.accum_warmup_steps = max(
            round(self.solver_cfg.warmup_epochs * len(self.train_loader)), 1000)

        if aug_mode == "auto":
            aug_mode = ("event" if not self.learned and supports_event_mosaic(self.representation)
                        else "image")
            LOGGER.info("aug_mode auto -> %s", aug_mode)
        self.aug_mode = aug_mode
        # image executor: the separable two-pass warp whenever the hyp ranges
        # fit its static roll pad; extreme hyps keep the exact routed gather
        warp_impl = "exact"
        if aug_mode == "image" and augment:
            if separable_hyp_eligible(dict(aug), img_size):
                warp_impl = "separable"
            LOGGER.info("image warp executor: %s", warp_impl)
        self.warp_impl = warp_impl

        generator = torch.Generator(device=self.device).manual_seed(seed)
        channels = REPRESENTATION_CHANNELS.get(self.representation, 12)  # the input follows the rep
        # the distill_ns head only for the nano/small families (engine.py:69-73)
        self.distill_ns = bool(distill and cfg["model"].get("type") in ("YOLOv6n", "YOLOv6s"))
        model_kw = dict(num_classes=nc, num_channels=channels, device=self.device,
                        representation=self.representation, img_size=img_size)
        self.model = build_model(cfg, generator=generator, fuse_ab=fuse_ab,
                                 distill_ns=self.distill_ns, **model_kw)
        # the frozen teacher: the same config with the plain head, in
        # batch-statistics mode with its statistics left as they are
        # (get_teacher_model, engine.py:660-673)
        self.teacher = None
        if distill:
            self.teacher = build_model(cfg, **model_kw)
            if teacher_ckpt:
                load_model_variables(self.teacher,
                                     load_teacher_variables(teacher_ckpt, self.device))
            else:
                LOGGER.warning("distill without --teacher-ckpt: the teacher is a fresh init "
                               "(seed + 1; fixture/debug mode only)")
                init_weights_(self.teacher,
                              torch.Generator(device=self.device).manual_seed(seed + 1))
            self.teacher.requires_grad_(False)
        self.train_mode = "distill" if distill else "fuseab" if fuse_ab else "plain"
        step_kwargs = dict(
            representation=self.representation,
            rep_hw=(self.train_ds.height, self.train_ds.width), img_size=img_size,
            mode=self.train_mode, aug_mode=aug_mode, warp_impl=warp_impl, device=self.device,
            teacher=self.teacher, max_epoch=epochs, temperature=temperature,
            distill_feat=distill_feat,
        )
        self.train_step = make_train_step(self.loss_cfg, **step_kwargs)
        # K steps a call; 1 = the per-batch step alone
        self.steps_per_dispatch = max(1, int(steps_per_dispatch))
        if self.steps_per_dispatch > 1:
            self.multi_step = make_multi_train_step(
                self.loss_cfg, self.steps_per_dispatch, ema_cadence=ema_cadence, **step_kwargs)
        tx = with_accumulation(build_optimizer(self.model, self.solver_cfg), self.accumulate,
                               warmup_steps=self.accum_warmup_steps)
        self.state = init_train_state(self.model, tx)
        # the reference's thop model_info line; the learned representation
        # takes event blocks, where the image probe does not apply
        if self.learned:
            n_params = sum(p.numel() for p in self.model.parameters())
            LOGGER.info("Model Summary: Params: %.2fM", n_params / 1e6)
        else:
            LOGGER.info("Model Summary: %s",
                        get_model_info(self.model, img_size=img_size, channels=channels))

        self.evaler = Evaler(self.model, self.val_loader, nc, self.representation, img_size,
                             device=self.device)
        self.best_ap = -1.0
        self.start_epoch = 0
        self.writer = MultiWriter.default(
            self.output_dir, config={"representation": self.representation},
            use_wandb=bool(cfg.get("use_wandb")),
            use_tensorboard=bool(cfg.get("use_tensorboard")),
        )
        self.log_interval = 200  # loss every 200 steps (engine.py:264-265)

    def should_eval(self, epoch: int) -> bool:
        return (
            epoch <= self.eval_interval_first
            or epoch % self.eval_interval == 0
            or epoch == self.epochs - 1
        )

    def prepare_for_epoch(self, epoch: int):
        """Stop strong aug (mosaic/mixup) for the last N epochs: the
        reference rebuilds the dataloader with zeroed hyp
        (engine.py:475-480); the loader reads the hyp per batch, so zeroing
        it in place suffices."""
        if (
            epoch == self.epochs - self.stop_aug_last_n_epoch
            and self.train_loader.hyp is not None
        ):
            self.train_loader.hyp["mosaic"] = 0.0
            self.train_loader.hyp["mixup"] = 0.0
            LOGGER.info("epoch %d: strong aug (mosaic/mixup) stopped", epoch)

    def calibrate(self, num_batches: int = 4, percentile: Optional[float] = None):
        """In-trainer PTQ (the reference's --quant --calib flow,
        engine.py:916-942, train.py:258-259): the decoded head output's
        range over ``num_batches`` training batches, the weights quantized
        to int8 per output channel (``ptq.sensitive_layers_skip`` of the
        config skipped by Flax path), the model evaluated with the
        fake-quantised weights, and ``ptq_ckpt`` written with the quantized
        state, the ranges and the metrics. Returns (ranges, stats)."""
        from ..utils.quantize import calibrate_activations, fake_quant_params, quantize_params

        sensitive = set(self.cfg.get("ptq", {}).get("sensitive_layers_skip", []) or [])

        def skip(name: str) -> bool:
            return any(s in name for s in sensitive)

        batches = []
        for i, (batch, _) in enumerate(self.train_loader):
            if i >= num_batches:
                break
            batches.append(batch)
        eval_step = self.evaler._eval_step
        ranges = calibrate_activations(lambda v, b: {"head_out": eval_step(v, b)}, None,
                                       batches, percentile=percentile)
        qstate, _ = quantize_params(self.model, skip=skip)
        stats = self.evaler.run(fake_quant_params(self.model, skip=skip))
        LOGGER.info("PTQ calibrated: %d activation ranges, eval %s", len(ranges), stats)
        save_quantized_checkpoint(self.output_dir / "ptq_ckpt", qstate, extra={
            "activation_ranges": ranges,
            "metrics": {k: float(v) for k, v in stats.items() if isinstance(v, (int, float))}})
        return ranges, stats

    def train(self):
        """Train for the epochs left; with ``quant_calib``, calibrate
        instead and return :meth:`calibrate`'s result."""
        if self.quant_calib:  # --quant --calib: calibrate and exit (train.py:258-259)
            return self.calibrate()
        for epoch in range(self.start_epoch, self.epochs):
            self.prepare_for_epoch(epoch)
            t0 = time.time()
            if self.steps_per_dispatch > 1:
                parts = self._train_epoch_scanned(epoch)
            else:
                parts = self._train_epoch(epoch)
            if parts is not None:
                last = {k: float(v) for k, v in parts.items()}
                LOGGER.info(
                    "epoch %d done in %.1fs loss=%.4f (iou %.3f dfl %.3f cls %.3f)",
                    epoch, time.time() - t0, last["loss"], last["iou"], last["dfl"],
                    last["cls"],
                )
            if self.should_eval(epoch):
                stats = self.eval_and_save(epoch)
                LOGGER.info("epoch %d eval: %s", epoch, stats)

    def _train_epoch(self, epoch: int):
        """The per-batch epoch; returns the last step's parts."""
        parts = None
        for batch, _ in self.train_loader:
            self.state, parts = self.train_step(self.state, batch, epoch)
            # the host-side step count: reading a device value here would
            # wait for every step
            if self.state.step % self.log_interval == 0:
                self.writer.log({k: float(v) for k, v in parts.items()}, self.state.step)
        return parts

    def _train_epoch_scanned(self, epoch: int):
        """The K-steps-a-call epoch: K loader batches stacked into one
        ``multi_step`` call; the remainder (< K batches) through the
        per-batch step, which logs only through the returned parts, as in
        the JAX Trainer. Returns the last step's parts."""
        k = self.steps_per_dispatch
        group, parts = [], None
        for batch, _ in self.train_loader:
            group.append(batch)
            if len(group) < k:
                continue
            self.state, stacked_parts = self.multi_step(self.state, stack_batches(group), epoch)
            group = []
            parts = {key: v[-1] for key, v in stacked_parts.items()}
            if self.state.step % self.log_interval < k:  # the call crossed a log step
                self.writer.log({key: float(v) for key, v in parts.items()}, self.state.step)
        for batch in group:
            self.state, parts = self.train_step(self.state, batch, epoch)
        return parts

    def eval_and_save(self, epoch: int) -> Dict[str, float]:
        stats = self.evaler.run(self.state.ema.variables)
        self.writer.log({f"val/{k}": v for k, v in stats.items()
                         if isinstance(v, (int, float))}, self.state.step)
        save_checkpoint(self.output_dir / "last_ckpt", self.state, epoch)
        if stats.get("AP", -1) > self.best_ap:
            self.best_ap = stats["AP"]
            save_checkpoint(self.output_dir / "best_ckpt", self.state, epoch)
        return stats
