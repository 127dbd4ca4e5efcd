"""Profiling utilities (the JAX package's ``utils/profiling.py`` in torch):
the reference's "Model Summary" (thop's ``model_info``,
torch_utils.py:97-112), traces of ``torch.profiler`` where the JAX package
takes ``jax.profiler``'s, and the program's own spans and counters.

:func:`span` names a stretch of the program's host time and :func:`count`
adds to a named counter. Both do nothing unless a ``torch.profiler`` is
recording (:func:`profile_trace`, or a caller's own profiler): then a span
is a range ``ers/<name>`` on the profiler's timeline, beside the kernels it
launched, and its calls and host seconds add up in :func:`span_totals`;
counters add up in :func:`counters`. Both tables are process-wide and keep
what every recorded window of the process added.
"""
from __future__ import annotations

import contextlib
import json
import os
import pathlib
import socket
import threading
import time
from typing import Dict, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler
from torch import nn

PREFIX = "ers/"  # of every span's range on the profiler's timeline
_NOOP = contextlib.nullcontext()
_LOCK = threading.Lock()  # spans and counts may come from several threads
_COUNTS: Dict[str, int] = {}
_SPANS: Dict[str, Tuple[int, float]] = {}  # name -> (calls, host seconds)


class _Span:
    """A range of the FUNCTION scope (``_RecordFunctionFast``), which the
    profiler does not mirror onto the device's timeline: a
    ``record_function`` range is mirrored there as a user annotation, which
    a reader of the device timeline would take for device work. It also
    costs ~1 us a range under the profiler against ~11 us (H100 machine,
    torch 2.11)."""

    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name
        self._range = torch._C._profiler._RecordFunctionFast(PREFIX + name)

    def __enter__(self):
        self._range.__enter__()
        self._t0 = time.perf_counter()

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self._t0
        self._range.__exit__(*exc)
        with _LOCK:
            calls, total = _SPANS.get(self.name, (0, 0.0))
            _SPANS[self.name] = (calls + 1, total + seconds)
        return False


def span(name: str):
    """The ``with`` block as the span ``name``; one shared no-op unless a
    profiler is recording (the profiler's own flag, ~0.1 us to read). A
    span adds no synchronisation: its host time is the block's on the host,
    launches included, and the device time of what it launched is on the
    profiler's timeline."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NOOP
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler is recording."""
    if _autograd_profiler._is_profiler_enabled:
        with _LOCK:
            _COUNTS[name] = _COUNTS.get(name, 0) + n


def counters() -> Dict[str, int]:
    """A copy of every counter."""
    with _LOCK:
        return dict(_COUNTS)


def span_totals() -> Dict[str, Tuple[int, float]]:
    """A copy of every span's (calls, host seconds)."""
    with _LOCK:
        return dict(_SPANS)


PROBE = 64  # the side of the image that get_model_info counts on


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
    Perfetto or ``chrome://tracing``), and beside it, as
    ``<trace>.counters.json``, what the block added to the counters and to
    the spans' calls and host seconds. Yields the profiler, whose
    ``key_averages()`` the caller may read after the block."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = pathlib.Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    counts0, spans0 = counters(), span_totals()
    with profile(activities=activities) as prof:
        yield prof
    counts1, spans1 = counters(), span_totals()
    stem = f"{socket.gethostname()}.{os.getpid()}.{time.time_ns()}.pt.trace"
    prof.export_chrome_trace(str(log_dir / f"{stem}.json"))
    added = {
        "counters": {k: v - counts0.get(k, 0) for k, v in counts1.items()
                     if v != counts0.get(k, 0)},
        "spans": {k: {"calls": c - spans0.get(k, (0, 0.0))[0],
                      "host_s": s - spans0.get(k, (0, 0.0))[1]}
                  for k, (c, s) in spans1.items() if c != spans0.get(k, (0, 0.0))[0]},
    }
    (log_dir / f"{stem}.counters.json").write_text(json.dumps(added, indent=1, sort_keys=True))
