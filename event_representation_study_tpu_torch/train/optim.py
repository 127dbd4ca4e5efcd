"""Optimizer and LR schedule (the JAX package's ``train/optim.py``): the
reference's 3-group nesterov SGD with a per-epoch cosine staircase, the
warmup of LR and momentum, and gradient accumulation.

Groups, by module: a BatchNorm's ``weight`` (Flax ``scale``) is group
``bn``, every ``bias`` is group ``bias``, everything else (convolution
kernels, BottleRep's ``alpha``) is group ``weight``, the only one with
weight decay. Schedules are functions of the number of completed
*updates*; with accumulation (:class:`MultiSteps`) an update fires every
k-th microstep, as ``optax.MultiSteps`` does.

Updates run in place on the model's parameters, per group with
``torch._foreach_*`` (a few launches per group, not per tensor).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Union

import numpy as np
import torch
from torch import nn


class SolverConfig(NamedTuple):
    lr0: float = 0.0032
    lrf: float = 0.12
    momentum: float = 0.843
    weight_decay: float = 0.00036
    warmup_epochs: float = 2.0
    warmup_momentum: float = 0.5
    warmup_bias_lr: float = 0.05
    epochs: int = 100
    steps_per_epoch: int = 1000


GROUPS = ("weight", "bias", "bn")


def cosine_lf(epoch: float, epochs: int, lrf: float) -> float:
    return (1 - math.cos(epoch * math.pi / epochs)) / 2 * (lrf - 1) + 1


def param_groups(model: nn.Module) -> Dict[str, List[str]]:
    """Parameter names per group: ``bn`` for BatchNorm weights, ``bias``
    for every bias, ``weight`` for the rest."""
    groups = {g: [] for g in GROUPS}
    for mod_name, mod in model.named_modules():
        for leaf, _ in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            if leaf == "bias":
                groups["bias"].append(name)
            elif isinstance(mod, nn.modules.batchnorm._BatchNorm) and leaf == "weight":
                groups["bn"].append(name)
            else:
                groups["weight"].append(name)
    return groups


def _schedules(cfg: SolverConfig):
    """(lr_for(group)(update), momentum(update)): the per-epoch cosine
    staircase, linear warmup over max(warmup_epochs * steps_per_epoch, 1000)
    updates (bias LR from ``warmup_bias_lr``, the others from 0) and the
    momentum ramp from ``warmup_momentum``."""
    warmup_steps = max(round(cfg.warmup_epochs * cfg.steps_per_epoch), 1000)

    def lr_for(group: str):
        def sched(step: int) -> float:
            base = cfg.lr0 * cosine_lf(step // cfg.steps_per_epoch, cfg.epochs, cfg.lrf)
            if step >= warmup_steps:
                return base
            start = cfg.warmup_bias_lr if group == "bias" else 0.0
            return start + (base - start) * (step / warmup_steps)

        return sched

    def momentum_sched(step: int) -> float:
        if step >= warmup_steps:
            return cfg.momentum
        return cfg.warmup_momentum + (cfg.momentum - cfg.warmup_momentum) * (step / warmup_steps)

    return lr_for, momentum_sched


class FusedSGD:
    """The 3-group nesterov SGD: per parameter, with g += wd * p in group
    ``weight``: m = g + mu * m; p -= lr * (g + mu * m). ``count`` is the
    number of completed updates, ``decay_m`` the momentum of the latest."""

    def __init__(self, model: nn.Module, cfg: SolverConfig):
        self.cfg = cfg
        self.params = dict(model.named_parameters())
        self.groups = param_groups(model)
        lr_for, self.momentum_sched = _schedules(cfg)
        self.lr_fns = {g: lr_for(g) for g in GROUPS}
        self.momentum = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.count = 0
        self.decay_m = self.momentum_sched(0)

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor]) -> None:
        """Apply one update from ``grads`` (name -> tensor) in place."""
        mom = self.momentum_sched(self.count)
        wd = self.cfg.weight_decay
        for group, names in self.groups.items():
            if not names:
                continue
            ps = [self.params[n] for n in names]
            ms = [self.momentum[n] for n in names]
            gs = [grads[n] for n in names]
            if group == "weight" and wd > 0:
                gs = torch._foreach_add(gs, ps, alpha=wd)
            torch._foreach_mul_(ms, mom)
            torch._foreach_add_(ms, gs)
            u = torch._foreach_add(gs, ms, alpha=mom)  # nesterov
            torch._foreach_add_(ps, u, alpha=-self.lr_fns[group](self.count))
        self.count += 1
        self.decay_m = mom


class MultiSteps:
    """Gradient accumulation as ``optax.MultiSteps``: the running mean of
    the microstep gradients; the inner optimizer updates every k-th
    microstep, with k = ``every_k_schedule(completed updates)``."""

    def __init__(self, inner: FusedSGD, every_k_schedule: Union[int, Callable[[int], int]]):
        self.inner = inner
        self.every_k = (every_k_schedule if callable(every_k_schedule)
                        else lambda _: every_k_schedule)
        self.acc = {n: torch.zeros_like(p) for n, p in inner.params.items()}
        self.mini_step = 0
        self.gradient_step = 0

    @property
    def count(self) -> int:
        return self.inner.count

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor]) -> None:
        k = self.every_k(self.gradient_step)
        names = list(self.acc)
        accs = [self.acc[n] for n in names]
        delta = torch._foreach_sub([grads[n] for n in names], accs)
        torch._foreach_div_(delta, float(self.mini_step + 1))
        torch._foreach_add_(accs, delta)  # acc += (g - acc) / (n + 1)
        if self.mini_step == k - 1:
            self.inner.update(self.acc)
            torch._foreach_zero_(accs)
            self.gradient_step += 1
        self.mini_step = (self.mini_step + 1) % k


def build_optimizer(model: nn.Module, cfg: SolverConfig) -> FusedSGD:
    return FusedSGD(model, cfg)


def accumulation_steps(batch_size: int, nominal: int = 64) -> int:
    """Effective batch ``nominal`` through accumulation."""
    return max(1, round(nominal / batch_size))


def with_accumulation(tx: FusedSGD, k: int, warmup_steps: int = 0):
    """Average gradients over ``k`` microsteps and update every k-th. With
    ``warmup_steps`` > 0 the window ramps from 1 to k over that many
    microsteps; the per-update k is a host table (window-start semantics)."""
    if k <= 1:
        return tx
    if warmup_steps <= 0:
        return MultiSteps(tx, k)
    ks, m = [], 0
    while m < warmup_steps:
        ki = int(max(1, np.round(np.interp(m, [0, warmup_steps], [1, k]))))
        ks.append(ki)
        m += ki
    table = ks + [k]
    return MultiSteps(tx, lambda update: table[min(update, len(table) - 1)])
