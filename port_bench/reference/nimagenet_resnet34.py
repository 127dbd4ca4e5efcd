"""Plain reference of the ``nimagenet_resnet34`` configuration: Mini
N-ImageNet classification with a ResNet34 (stem kernel 14, 12 channels) on
ERGO-12 at 224², cross-entropy and Adam, in float32 PyTorch.

It runs the frozen copies under ``frozen/`` of the port's plain modules
(none imports the port): the N-ImageNet sample reader (coordinate reshape,
random slice, augmentation; its own ``np.random.default_rng(0)``, as the
port's dataset is built by ``cli/classify.py``), ERGO-12 with the plain
segment reduction in place of kernel K1, and the ResNet. Adam is written
out here, one tensor at a time. It rebuilds each step's batch from the
same files, the same epoch order and the same sample draws, and the
weights from the same seed.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .frozen.data.nimagenet import IMAGE_H, IMAGE_W, NImageNetDataset
from .frozen.events.core import EventBlock
from .frozen.models.resnet import EventResNet
from .frozen.reps.fused_mdes import ergo12_fused_batched

BETAS = (0.9, 0.999)  # torch.optim.Adam's defaults, which the port keeps
EPS = 1e-8


def model(cfg: Dict, device) -> torch.nn.Module:
    """The classifier of ``cfg`` (the config file's ``program`` dict)."""
    with torch.device(device):
        return EventResNet(num_classes=int(cfg["num_classes"]), arch=cfg["model"],
                           stem_kernel=int(cfg["kernel_size"]),
                           in_channels=int(cfg["channel_size"]))


def dataset(cfg: Dict, files: Sequence[str], labels: Sequence[int]) -> NImageNetDataset:
    return NImageNetDataset(files, labels, loader_type=cfg["loader_type"],
                            slice_length=int(cfg["slice_length"]),
                            reshape_method=cfg["reshape_method"],
                            augment=cfg["augment"] == "True")


def batches(ds: NImageNetDataset, order_seed: int, batch_size: int, n_batches: int):
    """The first ``n_batches`` training batches of ``run_epoch`` under a
    generator ``np.random.default_rng(order_seed)``: (events (B, 4, N),
    num (B,), labels (B,))."""
    order = np.arange(len(ds))
    np.random.default_rng(order_seed).shuffle(order)
    for b in range(n_batches):
        samples = [ds[int(i)] for i in order[b * batch_size:(b + 1) * batch_size]]
        yield (np.stack([s.events for s in samples]),
               np.array([s.num_events for s in samples], np.int32),
               np.array([s.label for s in samples], np.int64))


@torch.no_grad()
def adam_update(params, grads, m, v, step: int, lr: float) -> None:
    """torch's Adam (no weight decay, not amsgrad) in place."""
    b1, b2 = BETAS
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    for n, p in params.items():
        g = grads[n]
        m[n].mul_(b1).add_(g, alpha=1 - b1)
        v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
        denom = (v[n].sqrt() / math.sqrt(bc2)).add_(EPS)
        p.addcdiv_(m[n], denom, value=-lr / bc1)


def train_readings(cfg: Dict, state: Dict[str, torch.Tensor], files, labels,
                   order_seed: int, n_steps: int, device, half_batch: bool = False) -> Dict:
    """The reference's first ``n_steps`` steps from ``state``: each step's
    loss, every leaf's first gradient and every leaf's change after the
    steps (norms, plain floats). ``half_batch`` plants a fault for the
    check's own test: the loss of the first half of each batch only."""
    if cfg["optimizer"].lower() != "adam":
        raise ValueError("the reference writes out Adam only")
    net = model(cfg, device)
    net.load_state_dict(state)
    net.train()
    params = dict(net.named_parameters())
    p0 = {k: v.detach().clone() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    ds = dataset(cfg, files, labels)
    losses: List[float] = []
    grad1 = {}
    for k, (ev, num, y) in enumerate(batches(ds, order_seed, int(cfg["batch_size"]), n_steps)):
        ev_t = torch.as_tensor(ev, device=device)
        blocks = EventBlock(x=ev_t[:, 0], y=ev_t[:, 1], t=ev_t[:, 2], p=ev_t[:, 3],
                            num=torch.as_tensor(num, device=device))
        with torch.no_grad():
            imgs = (ergo12_fused_batched(blocks, IMAGE_H, IMAGE_W) * 255.0 / 255.0)
        logits = net(imgs.permute(0, 3, 1, 2))
        y_t = torch.as_tensor(y, device=device)
        if half_batch:
            logits, y_t = logits[:len(y) // 2], y_t[:len(y) // 2]
        loss = F.cross_entropy(logits, y_t)
        net.zero_grad(set_to_none=True)
        loss.backward()
        losses.append(float(loss.detach()))
        grads = {n: p.grad for n, p in params.items()}
        if k == 0:
            grad1 = {n: float(torch.linalg.vector_norm(g.double())) for n, g in grads.items()}
        adam_update(params, grads, m, v2, k + 1, float(cfg["learning_rate"]))
    change = {n: float(torch.linalg.vector_norm((params[n].detach() - p0[n]).double()))
              for n in params}
    return {"losses": losses, "grad1": grad1, "change": change}
