"""Profiling utilities (the JAX package's ``utils/profiling.py`` in torch):
the reference's split wall-clock accounting (torch_utils.py:31-35
``time_sync`` and the evaler.py:138-177 speed slots), its "Model Summary"
(thop's ``model_info``, torch_utils.py:97-112), and traces of
``torch.profiler`` where the JAX package takes ``jax.profiler``'s.
"""
from __future__ import annotations

import contextlib
import os
import pathlib
import socket
import time
from typing import Dict

import numpy as np
import torch
from torch import nn

PROBE = 64  # the side of the image that get_model_info counts on


def _wait(value=None) -> None:
    """Wait for ``value`` (a tensor, or anything NumPy can read) to be
    computed; without one, for every kernel queued on the card."""
    if torch.is_tensor(value):
        if value.is_cuda:
            torch.cuda.synchronize(value.device)
    elif value is not None:
        np.asarray(value)
    elif torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class SpeedMeter:
    """The reference's speed slots (count / pre / infer / post): each
    :meth:`measure` adds a block's host time to its slot, after waiting for
    ``sync_value`` or, without one, for the card (``time_sync``)."""

    def __init__(self):
        self.n = 0
        self.slots: Dict[str, float] = {}

    @contextlib.contextmanager
    def measure(self, slot: str, sync_value=None):
        t0 = time.perf_counter()
        yield
        _wait(sync_value)
        self.slots[slot] = self.slots.get(slot, 0.0) + (time.perf_counter() - t0) * 1e3

    def add_samples(self, n: int):
        self.n += n

    def summary(self) -> Dict[str, float]:
        if not self.n:
            return {}
        return {f"{k}_ms_per_sample": v / self.n for k, v in self.slots.items()}


def model_flops(model: nn.Module, x: torch.Tensor) -> int:
    """Floating-point operations of ``model``'s eval forward on ``x``, as
    ``torch.utils.flop_counter.FlopCounterMode`` counts them: 2 per
    multiply-add of the convolutions and matmuls, elementwise work not at
    all."""
    from torch.utils.flop_counter import FlopCounterMode

    was_training = model.training
    counter = FlopCounterMode(display=False)
    try:
        with torch.no_grad(), counter:
            model.eval()(x)
    finally:
        model.train(was_training)
    return counter.get_total_flops()


def get_model_info(model: nn.Module, img_size: int = 640, channels: int = 12) -> str:
    """Parameters and GFLOPs, the reference's "Model Summary": the eval
    forward of a 1 x ``channels`` x 64 x 64 probe on the model's device,
    counted by :func:`model_flops` and scaled to ``img_size`` by
    (img_size / 64)², as thop's count is scaled (``flops *= img_size^2 /
    stride^2``; thop counts multiply-adds and the reference doubles them,
    the convention of :func:`model_flops`)."""
    n_params = sum(p.numel() for p in model.parameters())
    p = next(model.parameters())
    probe = torch.zeros((1, channels, PROBE, PROBE), device=p.device)
    gflops = model_flops(model, probe) / 1e9 * (img_size / PROBE) ** 2
    return f"Params: {n_params / 1e6:.2f}M, Gflops: {gflops:.2f}"


@contextlib.contextmanager
def profile_trace(log_dir):
    """Profile the block with ``torch.profiler`` (the CPU, and the card when
    there is one) and write its Chrome trace into ``log_dir`` (viewable in
    Perfetto or ``chrome://tracing``). Yields the profiler, whose
    ``key_averages()`` the caller may read after the block."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = pathlib.Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / (
        f"{socket.gethostname()}.{os.getpid()}.{time.time_ns()}.pt.trace.json")))


def annotate(name: str):
    """A named span on the profiler's timeline."""
    return torch.profiler.record_function(name)
