"""Plain reference of the ``gen1_swinvit`` configuration: the genuine
Swin-V2-L transformer (``frozen/models/swin_vit.py``) in front of the
frozen ``CSPRepBiFPANNeck`` and 3-level DFL ``EffiDeHead``, on ERGO-12
windows of Gen1 at 576², in float32 PyTorch.

Everything but the backbone is ``gen1_optimized``'s reference, imported
from ``gen1_optimized.py``: the loader's batches rebuilt from the same
seeds, the event mosaic and ERGO-12 with the plain segment reduction, the
letterbox, the TAL/ATSS assigners and the VFL + GIoU + DFL loss, the
resume point, the accumulation ramp and the SGD update, whose groups are
the port's rule (``train/optim.py::param_groups``): every ``bias`` in
``bias``, every 1-d ``weight`` (a BatchNorm's or LayerNorm's scale) in
``bn``, everything else in ``weight`` (decayed), the Swin's ``logit_scale``
(heads, 1, 1) among them. The accumulation and the EMA are written out here
as there. Nothing of the port is imported.

The EMA's decay is ev-YOLOv6's ``ModelEMA``'s, 0.9999 (1 - exp(-u / 2000))
at the u-th blend, computed in float32 as the JAX package (and so the port)
computes it, where ev-YOLOv6 computes it in Python's float64 (DEPARTURE):
the blend applies it to float32 tensors either way, and one decay on both
sides keeps the blend's rounding out of the comparison of the EMA's change
(a leaf of large entries and a small change, such as a temperature at 2.3,
would otherwise read the two decays' rounding).

The Swin blocks are recomputed in the backward pass (``checkpoint``), so
that the reference fits on the card at the cell's batch after the port's
state is freed; the recomputation repeats the same operations.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from .frozen.events.core import EventBlock
from .frozen.models.heads import EffiDeHead
from .frozen.models.swin_vit import SwinTransformerV2
from .frozen.models.yolo import NECKS, _scale
from .frozen.ops.warp import AugPlan
from .frozen.reps.event_mosaic import mosaic_event_rep
from .frozen.train.losses import detection_loss
from .gen1_optimized import (  # noqa: F401  (resume_point: the driver's)
    CHANNELS,
    EMA_DECAY,
    EMA_TAU,
    REPRESENTATION,
    accumulation_table,
    loader_batches,
    loss_config,
    resume_point,
    sgd_update,
)

# ``half_batch``: the loss of the first half of each batch's rows only;
# ``ema_skip``: the first step's EMA blend left out; ``no_shift_mask``: the
# shifted blocks attend without the -100 mask
FAULTS = ("half_batch", "ema_skip", "no_shift_mask")


class SwinDetector(nn.Module):
    """backbone -> neck -> head, named as the port's ``Detector``."""

    def __init__(self, cfg: Dict, masked: bool = True):
        super().__init__()
        m = cfg["model"]
        bb, nk, hd = m["backbone"], m["neck"], m["head"]
        depth, width = m.get("depth_multiple", 1.0), m.get("width_multiple", 1.0)
        channels = [_scale(c, width) for c in list(bb["out_channels"]) + list(nk["out_channels"])]
        repeats = [max(round(r * depth), 1) if r > 1 else r
                   for r in list(bb["num_repeats"]) + list(nk["num_repeats"])]
        self.backbone = SwinTransformerV2(CHANNELS, masked=masked)  # the fixed 'large' preset
        self.neck = NECKS[nk["type"]](self.backbone.out_channels, channels, repeats,
                                      cfg.get("training_mode", "conv_silu"), nk.get("csp_e", 0.5))
        self.head = EffiDeHead(cfg["data"]["num_classes"],
                               [_scale(c, width) for c in hd["in_channels"]],
                               self.neck.out_channels, tuple(hd["strides"]), hd["reg_max"],
                               hd["use_dfl"])

    def forward(self, x):
        return self.head(self.neck(self.backbone(x)))


def model(cfg: Dict, device, fault: Optional[str] = None) -> SwinDetector:
    """The detector of ``cfg`` (the config file's ``program`` dict) on
    ``device`` (``meta`` builds shapes only); ``no_shift_mask`` plants that
    fault."""
    with torch.device(device):
        return SwinDetector(cfg, masked=fault != "no_shift_mask")


def ema_decay(u: int) -> np.float32:
    """The decay of the EMA's ``u``-th blend, in float32 (module docstring)."""
    return np.float32(EMA_DECAY) * (np.float32(1) - np.exp(-np.float32(u) / np.float32(EMA_TAU)))


def train_readings(cfg: Dict, state: Dict[str, torch.Tensor], ds, resume: Dict,
                   batch_size: int, img_size: int, loader_seed: int, epoch: int,
                   n_steps: int, device, fault: Optional[str] = None) -> Dict:
    """The reference's first ``n_steps`` microsteps from ``state``, read as
    ``gen1_optimized.train_readings`` reads them: each step's loss, every
    leaf's first gradient, every leaf's change after the steps, and the
    change of every BatchNorm statistic and of every entry of the EMA.
    ``fault`` plants one of :data:`FAULTS`. Returns plain floats a leaf."""
    if fault not in (None, *FAULTS):
        raise ValueError(f"unknown fault {fault!r}")
    solver = resume["solver"]
    net = model(cfg, device, fault)
    net.load_state_dict(state)
    net.backbone.checkpoint = True
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
        with torch.no_grad():
            imgs = mosaic_event_rep(blocks, AugPlan(**plan).to(device), REPRESENTATION,
                                    (ds.height, ds.width), img_size)
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
        del outputs, loss
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
                    e.mul_(float(d)).add_(floating[n], alpha=float(np.float32(1) - d))

    def norms(now, then):
        return {n: float(torch.linalg.vector_norm((now[n].detach() - then[n]).double()))
                for n in now}

    return {"losses": losses, "grad1": grad1, "change": norms(params, p0),
            "buffers": norms(buffers, b0), "ema": norms(ema, state)}
