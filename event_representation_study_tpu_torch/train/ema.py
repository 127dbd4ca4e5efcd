"""Exponential moving average of the model state (the JAX package's
``train/ema.py``): decay(u) = 0.9999 * (1 - exp(-u / 2000)) at the u-th
blend, over every floating tensor of the state dict (parameters and
BatchNorm statistics), as the reference EMAs its whole state_dict.
:func:`ema_update_k` stands in for k consecutive blends (the K-step call's
``ema_cadence="dispatch"``).
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch
from torch import nn


class EMAState(NamedTuple):
    variables: Dict[str, torch.Tensor]
    updates: int


def _floating_state(model: nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in model.state_dict().items() if v.is_floating_point()}


def ema_init(model: nn.Module) -> EMAState:
    return EMAState({k: v.detach().clone() for k, v in _floating_state(model).items()}, 0)


@torch.no_grad()
def ema_update(state: EMAState, model: nn.Module, base_decay: float = 0.9999) -> EMAState:
    """Blend the model's current state into the EMA in place; the decay is
    computed in float32, as in the JAX package."""
    u = state.updates + 1
    d = np.float32(base_decay) * (np.float32(1) - np.exp(-np.float32(u) / np.float32(2000)))
    _blend_(state.variables, model, d)
    return EMAState(state.variables, u)


@torch.no_grad()
def ema_update_k(state: EMAState, model: nn.Module, k: int,
                 base_decay: float = 0.9999) -> EMAState:
    """One blend standing in for ``k`` consecutive :func:`ema_update` calls:
    the decay is the float32 product D of the k per-step decays
    base * (1 - exp(-(u0 + i) / 2000)), i = 1..k, and the counter advances
    by k (so a later per-step blend, or a resume, keeps the warmup
    schedule). On constant parameters this equals the k blends; on a moving
    trajectory it leaves out the intermediate states' weights (~1e-4 each
    at base 0.9999), as the JAX package's ``ema_update_k`` does."""
    i = np.arange(1, k + 1, dtype=np.float32)
    d = np.float32(base_decay) * (np.float32(1) - np.exp(-(np.float32(state.updates) + i)
                                                         / np.float32(2000)))
    _blend_(state.variables, model, np.prod(d, dtype=np.float32))
    return EMAState(state.variables, state.updates + k)


def _blend_(variables: Dict[str, torch.Tensor], model: nn.Module, d: np.float32) -> None:
    """variables = d * variables + (1 - d) * the model's state, in place."""
    new = _floating_state(model)
    names = list(variables)
    es = [variables[k] for k in names]
    torch._foreach_mul_(es, float(d))
    torch._foreach_add_(es, [new[k].detach() for k in names], alpha=float(np.float32(1) - d))
