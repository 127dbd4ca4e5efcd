"""Carry weights between the JAX package and this port (the detector,
``models/resnet.py``'s classifier):
``flax_to_torch(variables) -> state_dict`` and, for comparing tensors leaf
by leaf (weights, gradients, EMA), :func:`to_flax_leaves`, its inverse.

``variables`` is the JAX ``Detector``'s ``{"params", "batch_stats"}`` as
nested dicts of numpy arrays. The torch submodules carry the Flax names, so
conversion is a flatten (``a/b/c`` -> ``a.b.c``) plus the layout rules, the
inverse of the JAX package's ``utils/torch_convert.py``:

- Conv kernel HWIO -> OIHW
- Dense kernel (in, out) -> Linear weight (out, in)
- ConvTranspose kernel (kh, kw, I, O) -> (I, O, kh, kw) with a spatial flip
  (Flax applies the kernel unflipped, torch's transpose conv flipped)
- BatchNorm scale/bias -> weight/bias; batch_stats mean/var ->
  running_mean/running_var, plus a zero ``num_batches_tracked``
- everything else (conv biases, BottleRep ``alpha`` (1,)) as is

The result loads with ``model.load_state_dict(sd, strict=True)``.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, dtype=np.float32)


def flax_to_torch(variables: Dict) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(variables["params"]):
        mod, leaf = list(path[:-1]), path[-1]
        if leaf == "kernel":
            if arr.ndim not in (2, 4):
                raise ValueError(f"unexpected {arr.ndim}-d kernel at {'/'.join(path)}")
            if arr.ndim == 2:  # Dense
                arr = arr.T
            elif mod[-2:] == ["upsample", "upsample"]:  # Transpose/ConvTranspose
                arr = arr.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
            else:
                arr = arr.transpose(3, 2, 0, 1)
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        sd[".".join(mod + [leaf])] = torch.from_numpy(np.ascontiguousarray(arr))
    stats = {"mean": "running_mean", "var": "running_var"}
    for path, arr in _flatten(variables.get("batch_stats", {})):
        mod = ".".join(path[:-1])
        sd[f"{mod}.{stats[path[-1]]}"] = torch.from_numpy(np.ascontiguousarray(arr))
        sd[f"{mod}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    return sd


def to_flax_leaves(tensors: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Port tensors named as in ``state_dict()`` or ``named_parameters()``
    (parameters, their gradients, BatchNorm statistics, EMA entries) ->
    flat ``{"params/a/b/kernel": array, "batch_stats/a/b/mean": array}`` in
    Flax layouts. ``num_batches_tracked`` has no Flax counterpart and is
    skipped."""
    out: Dict[str, np.ndarray] = {}
    for name, t in tensors.items():
        *mod, leaf = name.split(".")
        arr = t.detach().cpu().to(torch.float32).numpy()
        coll = "params"
        if leaf == "num_batches_tracked":
            continue
        if leaf in ("running_mean", "running_var"):
            coll, leaf = "batch_stats", leaf[len("running_"):]
        elif leaf == "weight" and arr.ndim == 4:
            if mod[-2:] == ["upsample", "upsample"]:  # transpose conv
                arr = arr[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
            else:
                arr = arr.transpose(2, 3, 1, 0)
            leaf = "kernel"
        elif leaf == "weight" and arr.ndim == 2:  # Linear
            arr, leaf = arr.T, "kernel"
        elif leaf == "weight":  # the only 1-d weights are BatchNorm scales
            leaf = "scale"
        out["/".join([coll, *mod, leaf])] = np.ascontiguousarray(arr)
    return out
