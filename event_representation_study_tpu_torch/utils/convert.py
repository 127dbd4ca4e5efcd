"""Carry detector weights from the JAX package to this port:
``flax_to_torch(variables) -> state_dict``.

``variables`` is the JAX ``Detector``'s ``{"params", "batch_stats"}`` as
nested dicts of numpy arrays. The torch submodules carry the Flax names, so
conversion is a flatten (``a/b/c`` -> ``a.b.c``) plus the layout rules, the
inverse of the JAX package's ``utils/torch_convert.py``:

- Conv kernel HWIO -> OIHW
- ConvTranspose kernel (kh, kw, I, O) -> (I, O, kh, kw) with a spatial flip
  (Flax applies the kernel unflipped, torch's transpose conv flipped)
- BatchNorm scale/bias -> weight/bias; batch_stats mean/var ->
  running_mean/running_var, plus a zero ``num_batches_tracked``
- everything else (conv biases, BottleRep ``alpha`` (1,)) as is

The result loads with ``Detector.load_state_dict(sd, strict=True)``.
"""
from __future__ import annotations

from typing import Dict

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
            if arr.ndim != 4:
                raise ValueError(f"unexpected {arr.ndim}-d kernel at {'/'.join(path)}")
            if mod[-2:] == ["upsample", "upsample"]:  # Transpose/ConvTranspose
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
