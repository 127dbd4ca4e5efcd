"""Post-training quantization (the JAX package's ``utils/quantize.py``; the
reference's PTQ path, ev-YOLOv6/yolov6/core/engine.py:916-942):

- int8 weights, symmetric per output channel: every ``nn.Conv2d``,
  ``nn.ConvTranspose2d`` and ``nn.Linear`` weight (the leaves that Flax
  names ``kernel``; BatchNorm and LayerNorm weights never) is stored as
  int8 with a float32 scale a channel. The output channel is axis 0 of a
  conv or linear weight and axis 1 of a transpose conv's, where the Flax
  layouts hold it last; rounding is half to even, as ``np.round``'s, and
  every division is correctly rounded, so the card gives the CPU's bits.
- activation calibration: the largest absolute value (or a percentile) of
  each output of ``apply_fn`` over calibration batches.

:func:`quantize_params` / :func:`dequantize_params` round-trip a state
dict; :func:`fake_quant_params` gives float32 weights that carry the int8
error, so the normal forward measures the accuracy PTQ costs. ``skip``
sees each weight's Flax path (``backbone/stem/conv/kernel``, through
``utils/convert.py``), so one ``ptq.sensitive_layers_skip`` list skips the
same layers in both packages.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .convert import flax_param_path

QUANTIZED_MODULES = (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)


def _quantizable(model: nn.Module) -> Dict[str, int]:
    """State-dict name -> output-channel axis of every weight to quantize."""
    return {f"{name}.weight" if name else "weight": 1 if isinstance(m, nn.ConvTranspose2d) else 0
            for name, m in model.named_modules() if isinstance(m, QUANTIZED_MODULES)}


def quantize_params(model: nn.Module, bits: int = 8,
                    skip: Optional[Callable[[str], bool]] = None) -> Tuple[Dict, Dict]:
    """``model``'s state dict with each weight to quantize replaced by
    ``{"q": int8, "scale": float32 (out,), "axis": int}``, and the metadata
    of those weights by Flax path, ``{"bits", "scale_shape"}``."""
    qmax = 2 ** (bits - 1) - 1
    targets = _quantizable(model)
    out, meta = {}, {}
    for name, w in model.state_dict().items():
        axis = targets.get(name)
        flax = None if axis is None else flax_param_path(name, w.dim())
        if axis is None or (skip is not None and skip(flax)):
            out[name] = w
            continue
        w = w.detach().to(torch.float32)
        dims = [d for d in range(w.dim()) if d != axis]
        amax = w.abs().amax(dim=dims).clamp_min(1e-12)
        # a tensor divisor: CUDA divides by a Python scalar through its
        # reciprocal, which is not correctly rounded
        scale = amax / torch.full_like(amax, qmax)
        shape = [1] * w.dim()
        shape[axis] = -1
        q = torch.round(w / scale.view(shape)).clamp(-qmax - 1, qmax).to(torch.int8)
        out[name] = {"q": q, "scale": scale, "axis": axis}
        meta[flax] = {"bits": bits, "scale_shape": tuple(scale.shape)}
    return out, meta


def dequantize_params(qstate: Dict) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`quantize_params`: a plain state dict, each
    quantized weight back to float32."""
    out = {}
    for name, v in qstate.items():
        if isinstance(v, dict):
            shape = [1] * v["q"].dim()
            shape[v["axis"]] = -1
            v = v["q"].to(torch.float32) * v["scale"].view(shape)
        out[name] = v
    return out


def fake_quant_params(model: nn.Module, bits: int = 8,
                      skip: Optional[Callable[[str], bool]] = None) -> Dict[str, torch.Tensor]:
    """``model``'s state dict with float32 weights that carry the int8
    error: feed it to the normal forward to measure the PTQ accuracy drop."""
    return dequantize_params(quantize_params(model, bits, skip)[0])


def _flatten(tree, prefix=""):
    """(name, tensor) of a dict / sequence / tensor tree, named as JAX's key
    paths print: dict keys joined by "/", sequence items ``[i]``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}/[{i}]" if prefix else f"[{i}]")
    else:
        yield prefix, tree


def calibrate_activations(apply_fn: Callable, variables, batches: Iterable,
                          percentile: Optional[float] = None) -> Dict[str, float]:
    """Per-output activation ranges over the calibration ``batches``:
    ``apply_fn(variables, batch)`` returns the activations to calibrate (a
    tensor or a dict/list tree of them); each range is the largest absolute
    value over all batches, or its ``percentile``."""
    seen: Dict[str, list] = {}
    for batch in batches:
        for name, v in _flatten(apply_fn(variables, batch)):
            seen.setdefault(name, []).append(
                torch.as_tensor(v).detach().abs().reshape(-1).cpu().numpy())
    out = {}
    for name, chunks in seen.items():
        allv = np.concatenate(chunks)
        out[name] = float(np.percentile(allv, percentile) if percentile else allv.max())
    return out
