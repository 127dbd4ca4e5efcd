"""Reference-checkpoint import (the JAX package's ``utils/torch_convert.py``):
a reference ev-YOLOv6 ``state_dict`` -> this port's ``Detector``
``state_dict``.

The reference publishes torch pickles of its detector (``best_ckpt.pt``, the
EMA in half precision; engine.py:291-318). The port's submodules carry the
Flax names of the JAX package (``utils/convert.py``), so the import is the
JAX package's name map, joined with dots, and no layout transform: both
sides are torch, so Conv2d weights stay OIHW, the neck's ConvTranspose2d
weights stay IOHW unflipped, and BatchNorm keeps weight / bias /
running_mean / running_var.

Name map (reference -> here):
  backbone.stem.block.*                  -> backbone.stem.*
  backbone.ERBlock_{k}.0.block.*         -> backbone.down_{k-1}.*
  backbone.ERBlock_{k}.1.<bepc3>         -> backbone.stage_{k-1}.<bepc3>
  backbone.ERBlock_{k}.2.sppf.*          -> backbone.sppf.*
  neck.reduce_layer{i}.block.*           -> neck.reduce_layer{i}.*
  neck.Bifusion{i}.cv{j}.block.*         -> neck.Bifusion{i}.cv{j}.*
  neck.Bifusion{i}.upsample.upsample_transpose.* -> neck.Bifusion{i}.upsample.upsample.*
  neck.Bifusion{i}.downsample.block.*    -> neck.Bifusion{i}.downsample.*
  neck.Rep_{x}.<bepc3>                   -> neck.Rep_{x}.<bepc3>
  neck.downsample{i}.block.*             -> neck.downsample{i}.*
  detect.stems.{i}.block.*               -> head.stem_{i}.*
  detect.{cls,reg}_convs.{i}.block.*     -> head.{cls,reg}_conv_{i}.*
  detect.{cls,reg}_preds.{i}.*           -> head.{cls,reg}_pred_{i}.*
with <bepc3>: cv{j}.block.* -> cv{j}.*; m.conv1.conv{j}.block.* ->
m.conv1.conv{j}.*; m.conv1.alpha -> m.conv1.alpha; m.block.{j}.conv{k}.block.*
-> m.block_{j}.conv{k}.*; RepVGG's rbr_dense.conv / rbr_dense.bn /
rbr_1x1.conv / rbr_1x1.bn -> rbr_dense_conv / ... ; a leading ``module.``
(a DataParallel pickle) dropped.

Skipped, as in the JAX package: ``detect.proj`` and ``detect.proj_conv``
(the DFL projection 0..reg_max, which the port's head computes as a
constant, ``models/heads.py``). ``num_batches_tracked``, which the JAX
package drops (Flax has no such leaf), is kept: every BatchNorm of the port
is a ``torch.nn.BatchNorm2d`` with that buffer. Floating tensors become
float32 (the published EMA is half precision); ``alpha`` becomes shape (1,).
"""
from __future__ import annotations

import re
from typing import Dict, List, Tuple

import torch

LEAVES = ("weight", "bias", "alpha", "running_mean", "running_var", "num_batches_tracked")


def _rewrite_name(key: str) -> str:
    k = key
    k = re.sub(r"^module\.", "", k)
    k = re.sub(r"^backbone\.ERBlock_(\d+)\.0\.", lambda m: f"backbone.down_{int(m.group(1))-1}.", k)
    k = re.sub(r"^backbone\.ERBlock_(\d+)\.1\.", lambda m: f"backbone.stage_{int(m.group(1))-1}.", k)
    k = re.sub(r"^backbone\.ERBlock_\d+\.2\.sppf\.", "backbone.sppf.", k)
    # RepVGG branch conv/bn pairs: torch Sequential children -> flat names
    k = k.replace(".rbr_dense.conv.", ".rbr_dense_conv.")
    k = k.replace(".rbr_dense.bn.", ".rbr_dense_bn.")
    k = k.replace(".rbr_1x1.conv.", ".rbr_1x1_conv.")
    k = k.replace(".rbr_1x1.bn.", ".rbr_1x1_bn.")
    # RepBlock's sequential tail (block.0, block.1, ...) -> block_{i}
    k = re.sub(r"\.block\.(\d+)\.", lambda m: f".block_{m.group(1)}.", k)
    k = re.sub(r"^detect\.stems\.(\d+)\.", lambda m: f"head.stem_{m.group(1)}.", k)
    k = re.sub(r"^detect\.cls_convs\.(\d+)\.", lambda m: f"head.cls_conv_{m.group(1)}.", k)
    k = re.sub(r"^detect\.reg_convs\.(\d+)\.", lambda m: f"head.reg_conv_{m.group(1)}.", k)
    k = re.sub(r"^detect\.cls_preds\.(\d+)\.", lambda m: f"head.cls_pred_{m.group(1)}.", k)
    k = re.sub(r"^detect\.reg_preds\.(\d+)\.", lambda m: f"head.reg_pred_{m.group(1)}.", k)
    k = k.replace(".upsample.upsample_transpose.", ".upsample.upsample.")
    k = re.sub(r"\.m\.block\.(\d+)\.", lambda m: f".m.block_{m.group(1)}.", k)
    k = k.replace(".block.conv.", ".conv.").replace(".block.bn.", ".bn.")
    return k


def convert_state_dict(torch_state: Dict[str, torch.Tensor]
                       ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """A reference name -> tensor (or NumPy array) mapping -> (the port's
    state dict, the reference keys it could not place). Load the result with
    ``model.load_state_dict(sd)``; :func:`verify_against_tree` lists what
    does not fit a model."""
    out: Dict[str, torch.Tensor] = {}
    unmatched = []
    for key, val in torch_state.items():
        if "proj" in key:  # detect.proj / detect.proj_conv: constants here
            continue
        name = _rewrite_name(key)
        leaf = name.rsplit(".", 1)[-1]
        t = torch.as_tensor(val).detach().cpu()
        if leaf not in LEAVES or (leaf == "weight" and t.dim() not in (1, 2, 4)):
            unmatched.append(key)
            continue
        if leaf == "num_batches_tracked":
            out[name] = t.to(torch.int64).clone()
            continue
        t = t.to(torch.float32).clone()
        out[name] = t.reshape(1) if leaf == "alpha" else t
    return out, unmatched


def verify_against_tree(converted: Dict[str, torch.Tensor],
                        reference: Dict[str, torch.Tensor], prefix: str = ""):
    """Shape-check a converted state dict against a model's
    (``model.state_dict()``); returns (name, got, want) for each mismatch,
    with ``got`` None and ``want`` "missing" for a name it lacks."""
    problems = []
    for name, want in reference.items():
        path = prefix + name
        if name not in converted:
            problems.append((path, None, "missing"))
        elif tuple(converted[name].shape) != tuple(want.shape):
            problems.append((path, tuple(converted[name].shape), tuple(want.shape)))
    return problems


def reference_state_dict(state_dict: Dict[str, torch.Tensor], reg_max: int = 16
                         ) -> Dict[str, torch.Tensor]:
    """The inverse map: a port ``Detector`` state dict under the reference's
    names, with the reference head's ``detect.proj`` and
    ``detect.proj_conv.weight`` added; for checking the import where no
    published weights are at hand."""
    out: Dict[str, torch.Tensor] = {}
    for name, val in state_dict.items():
        k = name
        k = re.sub(r"^backbone\.down_(\d+)\.", lambda m: f"backbone.ERBlock_{int(m.group(1))+1}.0.", k)
        k = re.sub(r"^backbone\.stage_(\d+)\.", lambda m: f"backbone.ERBlock_{int(m.group(1))+1}.1.", k)
        k = re.sub(r"^backbone\.sppf\.", "backbone.ERBlock_6.2.sppf.", k)
        for ours, theirs in (("stem", "stems"), ("cls_conv", "cls_convs"), ("reg_conv", "reg_convs"),
                             ("cls_pred", "cls_preds"), ("reg_pred", "reg_preds")):
            k = re.sub(rf"^head\.{ours}_(\d+)\.", lambda m: f"detect.{theirs}.{m.group(1)}.", k)
        k = k.replace(".upsample.upsample.", ".upsample.upsample_transpose.")
        k = re.sub(r"\.block_(\d+)\.", lambda m: f".block.{m.group(1)}.", k)
        k = re.sub(r"\.(conv|bn)\.([a-z_]+)$", r".block.\1.\2", k)
        for pair in ("rbr_dense", "rbr_1x1"):
            k = k.replace(f".{pair}_conv.", f".{pair}.conv.").replace(f".{pair}_bn.", f".{pair}.bn.")
        out[k] = val
    out["detect.proj"] = torch.linspace(0, reg_max, reg_max + 1)
    out["detect.proj_conv.weight"] = out["detect.proj"].view(1, reg_max + 1, 1, 1).clone()
    return out
