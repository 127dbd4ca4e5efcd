"""Seeded weights that the benchmark makes itself and loads into both the
port and the reference, on the card in one normal draw.

Every convolution and linear kernel is normal with std sqrt(1/fan_in)
(lecun normal; a grouped convolution's fan-in counts its group), biases 0,
BatchNorm and LayerNorm scale 1, shift 0, running mean 0, variance 1,
residual scales (``alpha``) 1. ``overrides`` re-draws named leaves: a
glob pattern of leaf names (``fnmatch``) mapped to ``{"std_scale": s}``
(the leaf times s) or ``{"fill": v}`` (a constant).
"""
from __future__ import annotations

import fnmatch
import math
from typing import Dict, Mapping, Optional

import torch
from torch import nn

SEED_MASK = 2 ** 63 - 1


def torch_seed(seed: int) -> int:
    """A seed ``torch.Generator.manual_seed`` takes for any whole number."""
    return int(seed) & SEED_MASK


def seeded_state(model: nn.Module, seed: int, device, overrides: Optional[Mapping] = None
                 ) -> Dict[str, torch.Tensor]:
    """A full state dict for ``model`` (any device; ``meta`` is enough:
    only names, shapes and module types are read), drawn from ``seed``."""
    overrides = dict(overrides or {})
    kernels, state = [], {}
    for mod_name, mod in model.named_modules():
        prefix = f"{mod_name}." if mod_name else ""
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = mod.weight
            fan_in = (w.shape[0] * w[0, 0].numel() if isinstance(mod, nn.ConvTranspose2d)
                      else w[0].numel())
            kernels.append((prefix + "weight", tuple(w.shape), math.sqrt(1.0 / fan_in)))
            if mod.bias is not None:
                state[prefix + "bias"] = torch.zeros(mod.bias.shape, device=device)
        elif isinstance(mod, (nn.BatchNorm2d, nn.LayerNorm)):
            if mod.weight is not None:
                state[prefix + "weight"] = torch.ones(mod.weight.shape, device=device)
                state[prefix + "bias"] = torch.zeros(mod.bias.shape, device=device)
            if isinstance(mod, nn.BatchNorm2d) and mod.track_running_stats:
                state[prefix + "running_mean"] = torch.zeros(mod.running_mean.shape,
                                                             device=device)
                state[prefix + "running_var"] = torch.ones(mod.running_var.shape, device=device)
                state[prefix + "num_batches_tracked"] = torch.zeros((), dtype=torch.long,
                                                                    device=device)
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed))
    total = sum(math.prod(shape) for _, shape, _ in kernels)
    flat = torch.randn(total, generator=gen, device=device)
    at = 0
    for name, shape, std in kernels:
        n = math.prod(shape)
        state[name] = flat[at:at + n].view(shape) * std
        at += n
    for name, p in model.named_parameters():
        if name not in state:  # residual scales and other learned constants
            state[name] = torch.ones(p.shape, device=device)
    for name, b in model.named_buffers():
        if name not in state:
            state[name] = torch.zeros(b.shape, dtype=b.dtype, device=device)
    for pattern, rule in overrides.items():
        hit = fnmatch.filter(state, pattern)
        if not hit:
            raise KeyError(f"weight override {pattern!r} names no leaf")
        for n in hit:
            if "fill" in rule:
                state[n] = torch.full_like(state[n], float(rule["fill"]))
            else:
                state[n] = state[n] * float(rule["std_scale"])
    return state
