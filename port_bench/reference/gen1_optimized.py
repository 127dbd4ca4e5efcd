"""Plain reference of the ``gen1_optimized`` configuration: the paper's
ERGO-12 detector (CSPBackboneP6 + CSPRepBiFPANNeck_P6 + EffiDeHead) on Gen1
windows, in float32 PyTorch.

It runs the frozen copies under ``frozen/`` of the port's plain modules
(taken at the commit that added this benchmark; none imports the port): the
event mosaic and ERGO-12 with the plain segment reduction (``index_add_`` /
``scatter_reduce_``) in place of kernel K1, the letterbox, the detector,
the TAL/ATSS assigners and the VFL + GIoU + DFL loss; the judge follows
the port's NMS choices over its boxes and scores (``judge.py``). The
optimizer, its schedule, the accumulation and the EMA are written out here
from the configuration's solver, one tensor at a time. It takes from the
port nothing but the outputs it judges: it rebuilds the loader's batch
order, augmentation plans and labels from the same seeds and the same
synthetic split, and the weights from the same seed.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .frozen.data.augment import plan_augment_batch
from .frozen.events.core import EventBlock
from .frozen.models.yolo import build_model
from .frozen.ops.image import letterbox_image, letterbox_labels
from .frozen.ops.nms import IOU_THRES, MAX_DET
from .frozen.ops.warp import AugPlan
from .frozen.reps.event_mosaic import mosaic_event_rep
from .frozen.reps.fused_mdes import ergo12_fused_batched
from .frozen.train.losses import LossConfig, detection_loss

REPRESENTATION = "OptimizedRepresentation"
CHANNELS = 12
IOU_THRES, MAX_DET = IOU_THRES, MAX_DET  # the port's NMS defaults, which the judge uses
# ev-YOLOv6's ModelEMA: the u-th blend's decay is DECAY * (1 - exp(-u / TAU)),
# over every floating entry of the state dict, on every microstep
EMA_DECAY, EMA_TAU = 0.9999, 2000.0
SERVE_BLOCK = 1  # windows a forward of the serving reference, as the port serves them
FAULTS = ("half_batch", "ema_skip")


def model(cfg: Dict, device) -> torch.nn.Module:
    """The detector of ``cfg`` (the config file's ``program`` dict)."""
    return build_model(cfg, cfg["data"]["num_classes"], CHANNELS, device=device)


def loss_config(cfg: Dict) -> LossConfig:
    hd = cfg["model"]["head"]
    return LossConfig(num_classes=cfg["data"]["num_classes"], strides=tuple(hd["strides"]),
                      reg_max=hd["reg_max"], use_dfl=hd["use_dfl"], iou_type=hd["iou_type"],
                      warmup_epoch=hd["atss_warmup_epoch"])


# -- the loader's batches, rebuilt --------------------------------------------
def loader_batches(ds, batch_size: int, img_size: int, hyp: Dict, loader_seed: int,
                   n_batches: int, loader_epoch: int = 0):
    """The first ``n_batches`` strong-augmentation batches that
    ``EventBatchLoader(ds, batch_size, img_size, shuffle=True,
    seed=loader_seed, hyp=hyp)`` yields in its epoch ``loader_epoch``
    (no partner pool): the shuffled order from ``seed + epoch``, the plans
    from ``seed + 777`` in batch order. Yields (events (B, 4, N) int32,
    num (B,), plan dict, labels (B, cap, 5), label counts (B,))."""
    order = np.arange(len(ds))
    np.random.default_rng(loader_seed + loader_epoch).shuffle(order)
    aug_rng = np.random.default_rng(loader_seed + 777)
    for b in range(n_batches):
        samples = [ds[int(i)] for i in order[b * batch_size:(b + 1) * batch_size]]
        ev = np.stack([s.events for s in samples])
        abs_labels = [letterbox_labels(s.labels[:s.num_labels], ds.height, ds.width, img_size)
                      for s in samples]
        cap = samples[0].labels.shape[0]
        cap *= 4 if hyp.get("mosaic", 0.0) > 0 else 1
        cap *= 2 if hyp.get("mixup", 0.0) > 0 else 1
        plan, labels, nl = plan_augment_batch(abs_labels, img_size, hyp, aug_rng, cap,
                                              n_out=len(samples))
        num = np.array([s.num_events for s in samples], np.int32)
        yield ev, num, plan, labels, nl


# -- the solver, written out --------------------------------------------------
def _cosine_lf(epoch: float, epochs: int, lrf: float) -> float:
    return (1 - math.cos(epoch * math.pi / epochs)) / 2 * (lrf - 1) + 1


def sgd_schedule(solver: Dict, update: int, group: str):
    """(learning rate, momentum) of update number ``update`` for a
    parameter ``group`` (weight / bias / bn): linear warmup over
    max(warmup_epochs x steps_per_epoch, 1000) updates, then the per-epoch
    cosine staircase; the momentum ramps from ``warmup_momentum``."""
    spe = solver["steps_per_epoch"]
    warm = max(round(solver["warmup_epochs"] * spe), 1000)
    base = solver["lr0"] * _cosine_lf(update // spe, solver["epochs"], solver["lrf"])
    if update >= warm:
        return base, solver["momentum"]
    start = solver["warmup_bias_lr"] if group == "bias" else 0.0
    mom = solver["warmup_momentum"] + (solver["momentum"] - solver["warmup_momentum"]) * (
        update / warm)
    return start + (base - start) * (update / warm), mom


def accumulation_table(k: int, warmup_microsteps: int) -> List[int]:
    """Microsteps a update accumulates, by update number (the last entry
    holds from there on): the window ramps from 1 to ``k`` over
    ``warmup_microsteps`` microsteps, each update's window taken where it
    starts (the reference's engine.py:528-534 ramp)."""
    if k <= 1:
        return [1]
    ks, m = [], 0
    while m < warmup_microsteps:
        ki = int(max(1, np.round(np.interp(m, [0, warmup_microsteps], [1, k]))))
        ks.append(ki)
        m += ki
    return ks + [k]


def param_group(name: str, p: torch.Tensor) -> str:
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "bias":
        return "bias"
    return "bn" if leaf == "weight" and p.ndim == 1 else "weight"


@torch.no_grad()
def sgd_update(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
               momentum_bufs: Dict[str, torch.Tensor], solver: Dict, update: int) -> None:
    """One nesterov SGD update in place: in group ``weight`` g += wd p;
    m = g + mu m; p -= lr (g + mu m)."""
    for name, p in params.items():
        group = param_group(name, p)
        lr, mu = sgd_schedule(solver, update, group)
        g = grads[name]
        if group == "weight" and solver["weight_decay"] > 0:
            g = g + solver["weight_decay"] * p
        m = momentum_bufs[name]
        m.mul_(mu).add_(g)
        p.sub_(lr * (g + mu * m))


# -- training -----------------------------------------------------------------
def resume_point(traffic: Dict, cfg: Dict, length: int) -> Dict:
    """The optimizer settings of a run resumed at the start of epoch
    ``traffic['epoch']``, by the Trainer's rules (train/engine.py):
    accumulation to the nominal batch, updates counted per epoch of
    ``length // batch`` microsteps, the accumulation ramp over
    max(warmup_epochs x microsteps an epoch, 1000) microsteps, and the
    microsteps done, which the EMA has blended."""
    bsz = traffic["batch_size"]
    accumulate = max(1, round(traffic["nominal_batch_size"] / bsz))
    micro = length // bsz
    spe = max(micro // accumulate, 1)
    sol = cfg["solver"]
    solver = {k: sol[k] for k in ("lr0", "lrf", "momentum", "weight_decay", "warmup_epochs",
                                  "warmup_momentum", "warmup_bias_lr")}
    solver.update(epochs=traffic["epochs"], steps_per_epoch=spe,
                  update=traffic["epoch"] * spe)
    return {"solver": solver, "accumulate": accumulate,
            "accumulate_warmup": max(round(sol["warmup_epochs"] * micro), 1000),
            "microsteps": traffic["epoch"] * micro}


def ema_decay(u: int) -> float:
    """The decay of the EMA's ``u``-th blend."""
    return EMA_DECAY * (1.0 - math.exp(-u / EMA_TAU))


def train_readings(cfg: Dict, state: Dict[str, torch.Tensor], ds, resume: Dict,
                   batch_size: int, img_size: int, loader_seed: int, epoch: int,
                   n_steps: int, device, fault: Optional[str] = None) -> Dict:
    """The reference's first ``n_steps`` microsteps from ``state``: each
    step's loss, every leaf's gradient of the first step (the mean that
    the accumulation hands the optimizer starts as it), every leaf's
    change after the steps, and the change of every BatchNorm statistic
    and of every entry of the EMA. ``resume`` (:func:`resume_point`) holds
    the SGD settings with ``steps_per_epoch``, ``epochs`` and ``update``
    (the updates done before, as in the resumed port), the accumulation,
    which ramps to ``accumulate`` over ``accumulate_warmup`` microsteps
    (:func:`accumulation_table`), and the ``microsteps`` done before, which
    set the EMA's decay; the EMA starts at ``state``. ``fault`` plants one
    of :data:`FAULTS` for the check's own readings: ``half_batch``, the
    loss of the first half of each batch's rows only; ``ema_skip``, the
    first step's EMA blend left out. Returns plain floats a leaf."""
    if fault not in (None, *FAULTS):
        raise ValueError(f"unknown fault {fault!r}")
    solver = resume["solver"]
    net = model(cfg, device)
    net.load_state_dict(state)
    net.train()
    params = dict(net.named_parameters())
    p0 = {k: v.detach().clone() for k, v in params.items()}
    floating = {k: v for k, v in net.state_dict().items() if v.is_floating_point()}
    ema = {k: v.detach().clone() for k, v in floating.items()}
    buffers = {k: v for k, v in net.named_buffers() if v.is_floating_point()}
    b0 = {k: v.detach().clone() for k, v in buffers.items()}
    blends = resume["microsteps"]
    acc = {k: torch.zeros_like(v) for k, v in params.items()}
    mom = {k: torch.zeros_like(v) for k, v in params.items()}
    lcfg = loss_config(cfg)
    H, W = ds.height, ds.width
    losses: List[float] = []
    grad1 = {}
    update = solver["update"]
    table = accumulation_table(resume["accumulate"], resume["accumulate_warmup"])
    mini = 0
    for k, (ev, num, plan, labels, nl) in enumerate(loader_batches(
            ds, batch_size, img_size, dict(cfg["data_aug"]), loader_seed, n_steps)):
        ev_t = torch.as_tensor(ev, device=device)
        blocks = EventBlock(x=ev_t[:, 0], y=ev_t[:, 1], t=ev_t[:, 2], p=ev_t[:, 3],
                            num=torch.as_tensor(num, device=device))
        aug = AugPlan(**plan).to(device)
        with torch.no_grad():
            imgs = mosaic_event_rep(blocks, aug, REPRESENTATION, (H, W), img_size)
            imgs = (imgs[:len(num)] / 255.0).permute(0, 3, 1, 2)
        mask = (np.arange(labels.shape[1])[None] < nl[:, None]).astype(np.float32)
        gt = (torch.as_tensor(labels[..., 0], dtype=torch.int64, device=device),
              torch.as_tensor(labels[..., 1:5], dtype=torch.float32, device=device),
              torch.as_tensor(mask, device=device))
        net.zero_grad(set_to_none=True)
        outputs = net(imgs)
        shapes = [tuple(f.shape[2:]) for f in outputs[0]]
        if fault == "half_batch":
            h = len(num) // 2
            outputs = ([f[:h] for f in outputs[0]], outputs[1][:h], outputs[2][:h])
            gt = tuple(g[:h] for g in gt)
        loss, _ = detection_loss(outputs, *gt, shapes, epoch, lcfg)
        loss.backward()
        losses.append(float(loss.detach()))
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        if k == 0:
            grad1 = {n: float(torch.linalg.vector_norm(g.double())) for n, g in grads.items()}
        with torch.no_grad():
            for n in params:
                acc[n].add_((grads[n] - acc[n]) / (mini + 1))
            mini += 1
            if mini == table[min(update, len(table) - 1)]:
                sgd_update(params, acc, mom, solver, update)
                update += 1
                mini = 0
                for a in acc.values():
                    a.zero_()
            if not (fault == "ema_skip" and k == 0):
                blends += 1
                d = ema_decay(blends)
                for n, e in ema.items():
                    e.mul_(d).add_(floating[n], alpha=1.0 - d)

    def norms(now, then):
        return {n: float(torch.linalg.vector_norm((now[n].detach() - then[n]).double()))
                for n in now}

    return {"losses": losses, "grad1": grad1, "change": norms(params, p0),
            "buffers": norms(buffers, b0), "ema": norms(ema, state)}


# -- serving ------------------------------------------------------------------
def _images(events: Sequence[np.ndarray], img_size: int, height: int, width: int, device):
    """ERGO-12 -> letterbox -> /255 of full windows (4, N), as NCHW."""
    ev = torch.as_tensor(np.stack(events), device=device)
    blocks = EventBlock(x=ev[:, 0], y=ev[:, 1], t=ev[:, 2], p=ev[:, 3],
                        num=torch.full((len(ev),), ev.shape[2], dtype=torch.int32,
                                       device=device))
    rep = ergo12_fused_batched(blocks, height, width) * 255.0  # the 0..255 scale
    return (letterbox_image(rep, img_size) / 255.0).permute(0, 3, 1, 2)


@torch.no_grad()
def calibrated_state(cfg: Dict, state: Dict[str, torch.Tensor], events: Sequence[np.ndarray],
                     img_size: int, height: int, width: int, device) -> Dict[str, torch.Tensor]:
    """``state`` with every BatchNorm's running statistics set to those of
    one train-mode pass over ``events``, as a trained detector's hold its
    data's: with the initial mean 0 and variance 1 a deep random network's
    eval activations fade, and every score would be the class bias's."""
    net = model(cfg, device)
    net.load_state_dict(state)
    bns = [m for m in net.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for m in bns:
        m.momentum = 1.0
    net.train()
    net(_images(events, img_size, height, width, device))
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


@torch.no_grad()
def serve_answers(cfg: Dict, state: Dict[str, torch.Tensor], events: Sequence[np.ndarray],
                  img_size: int, height: int, width: int, device):
    """For each window (4, N) of ``events``, every (anchor, class) pair of
    the eval forward as [x1 y1 x2 y2 score cls], on the host: ERGO-12 ->
    letterbox -> /255 -> the detector, :data:`SERVE_BLOCK` windows a
    forward. The
    judge (``judge.py::detection_gaps``) follows the port's suppression
    over them."""
    net = model(cfg, device)
    net.load_state_dict(state)
    net.eval()
    out = []
    for b0 in range(0, len(events), SERVE_BLOCK):
        preds = net(_images(events[b0:b0 + SERVE_BLOCK], img_size, height, width, device))
        for p in preds:
            xyxy = torch.cat([p[:, :2] - p[:, 2:4] / 2, p[:, :2] + p[:, 2:4] / 2], dim=1)
            scores = p[:, 5:] * p[:, 4:5]
            a, c = torch.nonzero(torch.ones_like(scores, dtype=torch.bool), as_tuple=True)
            out.append(torch.cat([xyxy[a], scores[a, c, None], c[:, None].to(p.dtype)],
                                 dim=1).cpu())
    return out
