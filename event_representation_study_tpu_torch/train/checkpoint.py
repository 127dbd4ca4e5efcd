"""Checkpoint save/resume (the JAX package's ``train/checkpoint.py``, the
equivalent of ev-YOLOv6/yolov6/utils/checkpoint.py) on ``torch.save`` /
``torch.load(weights_only=True)``.

A train checkpoint is one file holding ``{"model", "optimizer", "ema",
"step", "epoch", "extra"}``: the model's state dict (parameters and
BatchNorm statistics), the optimizer's whole state (momentum buffers, update
count and momentum of ``FusedSGD``; the accumulators and micro-step counters
of ``MultiSteps``), the EMA (variables and update count), the step count and
the epoch, like the reference's {model, ema, updates, optimizer, epoch}
dict (engine.py:291-297). :func:`strip_optimizer` rewrites one to the EMA
variables only, ``{"variables"}``, for deployment (checkpoint.py:50-64).
"""
from __future__ import annotations

import os
import pathlib
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..parallel.train_step import TrainState
from .ema import EMAState


def _save(obj, path) -> None:
    """Write through a temporary file, so a crash mid-write leaves the old
    checkpoint in place."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_checkpoint(path, state: TrainState, epoch: int, extra: Optional[dict] = None) -> None:
    _save({
        "model": state.model.state_dict(),
        "optimizer": state.opt_state.state_dict(),
        "ema": {"variables": state.ema.variables, "updates": state.ema.updates},
        "step": state.step,
        "epoch": epoch,
        "extra": extra or {},
    }, path)


def load_checkpoint(path, map_location="cpu") -> dict:
    return torch.load(path, map_location=map_location, weights_only=True)


def restore_train_state(path, state: TrainState) -> Tuple[TrainState, int]:
    """Resume: load a train checkpoint into ``state`` in place (model,
    optimizer, EMA, step) and return ``(state, start_epoch)``, the epoch
    after the saved one (engine.py:98-108 resume semantics)."""
    device = next(state.model.parameters()).device
    ckpt = load_checkpoint(path, map_location=device)
    state.model.load_state_dict(ckpt["model"], strict=True)
    state.opt_state.load_state_dict(ckpt["optimizer"])
    with torch.no_grad():
        for k, v in state.ema.variables.items():
            v.copy_(ckpt["ema"]["variables"][k])
    state.ema = EMAState(state.ema.variables, int(ckpt["ema"]["updates"]))
    state.step = int(ckpt["step"])
    return state, int(ckpt["epoch"]) + 1


def model_variables(ckpt: dict) -> Dict[str, torch.Tensor]:
    """The weights to evaluate or serve from a loaded checkpoint: a stripped
    one's variables, else a train checkpoint's EMA (as eval does)."""
    if "variables" in ckpt:
        return ckpt["variables"]
    return ckpt["ema"]["variables"]


def load_model_variables(model: nn.Module, variables: Dict[str, torch.Tensor]) -> nn.Module:
    """Load EMA or stripped variables into ``model``: every floating tensor
    of its state dict must be there (``num_batches_tracked`` has no EMA)."""
    missing, unexpected = model.load_state_dict(variables, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"checkpoint does not fit the model: missing {missing[:5]}, "
                       f"unexpected {unexpected[:5]}")
    return model


def strip_optimizer(path, out_path) -> None:
    """Keep only the EMA variables (deploy checkpoint), like
    checkpoint.py:50-64."""
    _save({"variables": load_checkpoint(path)["ema"]["variables"]}, out_path)
