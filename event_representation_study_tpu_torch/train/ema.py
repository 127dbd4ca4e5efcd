"""Exponential moving average of the model state (the JAX package's
``train/ema.py``): decay(u) = 0.9999 * (1 - exp(-u / 2000)) at the u-th
blend, over every floating tensor of the state dict (parameters and
BatchNorm statistics), as the reference EMAs its whole state_dict.
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
    new = _floating_state(model)
    names = list(state.variables)
    es = [state.variables[k] for k in names]
    torch._foreach_mul_(es, float(d))
    torch._foreach_add_(es, [new[k].detach() for k in names], alpha=float(np.float32(1) - d))
    return EMAState(state.variables, u)
