"""Carry weights between the JAX package and this port (the detector zoo,
``models/resnet.py``'s classifier):
``flax_to_torch(variables) -> state_dict`` and, for comparing tensors leaf
by leaf (weights, gradients, EMA), :func:`to_flax_leaves`, its inverse.

``variables`` is the JAX model's ``{"params", "batch_stats"}`` as nested
dicts of numpy arrays. The torch submodules carry the Flax names, so
conversion is a flatten (``a/b/c`` -> ``a.b.c``) plus the layout rules, the
inverse of the JAX package's ``utils/torch_convert.py``:

- Conv kernel HWIO -> OIHW (a grouped or depthwise conv's I is
  in / groups in both)
- Dense kernel (in, out) -> Linear weight (out, in) (Swin's ``qkv``,
  ``proj``, ``cpb_mlp_*``, ``mlp_fc*``, ``reduction``; CBAM's MLP)
- ConvTranspose kernel (kh, kw, I, O) -> (I, O, kh, kw) with a spatial flip
  (Flax applies the kernel unflipped, torch's transpose conv flipped); the
  transpose convs are the modules named ``upsample`` (``Transpose``'s,
  inside ``upsample``, ``upsample0`` ... of every neck)
- BatchNorm and LayerNorm scale/bias -> weight/bias; batch_stats mean/var ->
  running_mean/running_var, plus a zero ``num_batches_tracked``
- everything else (biases, BottleRep ``alpha`` (1,), Swin ``logit_scale``
  (h, 1, 1)) as is

The variant heads and the learned representation need no rules of their
own: the fuse-ab head's ``cls_pred_ab_i`` / ``reg_pred_ab_i`` and the
distill_ns head's ``reg_pred_dist_i`` are 1x1 convs, and the quantization
layer's ``quantization/value_layer/mlp_i`` are Dense layers.

The result loads with ``model.load_state_dict(sd, strict=True)``.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _param_to_torch(path, arr) -> Tuple[str, np.ndarray]:
    """One Flax param leaf -> (state-dict name, a view in torch layout)."""
    mod, leaf = list(path[:-1]), path[-1]
    if leaf == "kernel":
        if arr.ndim not in (2, 4):
            raise ValueError(f"unexpected {arr.ndim}-d kernel at {'/'.join(path)}")
        if arr.ndim == 2:  # Dense
            arr = arr.T
        elif mod[-1] == "upsample":  # Transpose's ConvTranspose
            arr = arr.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
        else:
            arr = arr.transpose(3, 2, 0, 1)
        leaf = "weight"
    elif leaf == "scale":
        leaf = "weight"
    return ".".join(mod + [leaf]), arr


def _converted(variables, leaf_fn):
    """(name, array view) of every leaf, ``leaf_fn`` making the array."""
    for path, v in _flatten(variables["params"]):
        yield _param_to_torch(path, leaf_fn(v))
    stats = {"mean": "running_mean", "var": "running_var"}
    for path, v in _flatten(variables.get("batch_stats", {})):
        mod = ".".join(path[:-1])
        yield f"{mod}.{stats[path[-1]]}", leaf_fn(v)
        yield f"{mod}.num_batches_tracked", None


def flax_to_torch(variables: Dict) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for name, arr in _converted(variables, lambda v: np.asarray(v, dtype=np.float32)):
        sd[name] = (torch.tensor(0, dtype=torch.int64) if arr is None
                    else torch.from_numpy(np.ascontiguousarray(arr)))
    return sd


def _to_flax(name: str, arr: np.ndarray):
    """(Flax path ``params/a/b/kernel`` or ``batch_stats/a/b/mean``, the
    array in Flax layout) of one port tensor; (None, arr) for
    ``num_batches_tracked``, which has no Flax counterpart."""
    *mod, leaf = name.split(".")
    coll = "params"
    if leaf == "num_batches_tracked":
        return None, arr
    if leaf in ("running_mean", "running_var"):
        coll, leaf = "batch_stats", leaf[len("running_"):]
    elif leaf == "weight" and arr.ndim == 4:
        if mod[-1] == "upsample":  # transpose conv
            arr = arr[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
        else:
            arr = arr.transpose(2, 3, 1, 0)
        leaf = "kernel"
    elif leaf == "weight" and arr.ndim == 2:  # Linear
        arr, leaf = arr.T, "kernel"
    elif leaf == "weight":  # the only 1-d weights are BatchNorm and LayerNorm scales
        leaf = "scale"
    return "/".join([coll, *mod, leaf]), arr


def flax_param_path(name: str, ndim: int) -> str:
    """The Flax path within ``params`` (``a/b/kernel``) of the port
    parameter ``name`` (``a.b.weight``) of ``ndim`` dimensions: the names a
    config's ``ptq.sensitive_layers_skip`` matches in both packages."""
    return _to_flax(name, np.zeros((1,) * ndim, np.float32))[0].split("/", 1)[1]


def to_flax_leaves(tensors: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Port tensors named as in ``state_dict()`` or ``named_parameters()``
    (parameters, their gradients, BatchNorm statistics, EMA entries) ->
    flat ``{"params/a/b/kernel": array, "batch_stats/a/b/mean": array}`` in
    Flax layouts. ``num_batches_tracked`` has no Flax counterpart and is
    skipped."""
    out: Dict[str, np.ndarray] = {}
    for name, t in tensors.items():
        path, arr = _to_flax(name, t.detach().cpu().to(torch.float32).numpy())
        if path is not None:
            out[path] = np.ascontiguousarray(arr)
    return out
