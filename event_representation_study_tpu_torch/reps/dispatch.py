"""Representation dispatcher (port of the JAX package's ``reps/dispatch.py``).

- :func:`build_representation`: one block (leaves ``(N,)``) -> (H, W, C)
  float32 on the per-sample segment primitives (``ops/scatter.py``),
  scaled by 255 like every reference branch.
- :func:`batched_representation`: name -> batched function
  ``EventBlock (B, N) -> (B, H, W, C)`` on the fused segment reduce (K1/K2
  on CUDA tensors, their plain version on CPU tensors), as the JAX package
  runs it on the TPU; TORE, which has no fused form, runs one segmented
  top-k for the batch.
- :func:`get_item_transform`: the reference's host API: a NumPy structured
  event array in, a NumPy (H, W, C) array out, with TORE's dynamic
  event-bounding-box frame.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from .. import resolve_device
from ..events.core import EventBlock, from_structured
from .ergo12 import ergo12
from .event_stack import event_stack
from .fused_mdes import ergo12_fused_batched
from .fused_reps import (
    event_stack_fused_batched,
    histogram_fused_batched,
    time_surface_fused_batched,
    voxel_grid_fused_batched,
)
from .histogram import event_histogram
from .time_surface import time_surface
from .tore import tore
from .voxel_grid import voxel_grid

# channel counts per representation (SURVEY §2.1)
REPRESENTATION_CHANNELS: Dict[str, int] = {
    "VoxelGrid": 12,
    "MixedDensityEventStack": 12,
    "OptimizedRepresentation": 12,
    "EventStack": 12,
    "EventHistogram": 2,
    "TORE": 12,
    "TimeSurface": 12,
    # model-side trainable quantization (models/learned_repr.py): 2*6 bins
    "LearnedRepresentation": 12,
}


def _kind(name: str) -> str:
    """The representation a name selects, in the reference's order of tests
    ("MixedDensityEventStack" holds "EventStack")."""
    if "ToVoxelGrid" in name or name == "VoxelGrid":
        return "voxel_grid"
    if "MixedDensityEventStack" in name or name in ("OptimizedRepresentation", "ERGO12"):
        return "ergo12"
    if "EventStack" in name:
        return "event_stack"
    if "ToImage" in name or name == "EventHistogram":
        return "histogram"
    if "TORE" in name.upper():
        return "tore"
    if "ToTimesurface" in name or name == "TimeSurface":
        return "time_surface"
    raise ValueError(f"unknown representation: {name}")


_KIND_CHANNELS = {"voxel_grid": 12, "ergo12": 12, "event_stack": 12, "histogram": 2, "tore": 12,
                  "time_surface": 12}


def representation_channels(name: str) -> int:
    """Channels of a representation name, by the name rules of
    :func:`batched_representation` (the reference's ``ToImage`` is the
    2-channel histogram)."""
    if name in REPRESENTATION_CHANNELS:
        return REPRESENTATION_CHANNELS[name]
    return _KIND_CHANNELS[_kind(name)]


_PER_SAMPLE = {
    "voxel_grid": lambda b, h, w: voxel_grid(b, h, w, n_time_bins=12),
    "ergo12": ergo12,
    "event_stack": lambda b, h, w: event_stack(b, h, w, stack_size=12),
    "histogram": event_histogram,
    "tore": lambda b, h, w: tore(b, h, w, k=6),
    "time_surface": lambda b, h, w: time_surface(b, h, w, tau=50000.0),
}

_BATCHED = {
    "voxel_grid": voxel_grid_fused_batched,
    "ergo12": ergo12_fused_batched,
    "event_stack": event_stack_fused_batched,
    "histogram": histogram_fused_batched,
    "tore": tore,  # batched leaves: one sort for the batch
    "time_surface": time_surface_fused_batched,
}


def build_representation(name: str, block: EventBlock, height: int, width: int) -> torch.Tensor:
    """(H, W, C) float32 of one block, scaled by 255."""
    return _PER_SAMPLE[_kind(name)](block.as_int32(), height, width) * 255.0


def batched_representation(name: str, height: int, width: int) -> Callable:
    """Batched function ``EventBlock (B, N) -> (B, H, W, C)``, scaled by 255.
    Histogram and voxel grid launch K2 once a call on CUDA tensors, ERGO-12,
    event stack and time surface K1 once, TORE neither."""
    fused = _BATCHED[_kind(name)]

    def fn(blocks: EventBlock):
        return fused(blocks.as_int32(), height, width) * 255.0

    return fn


def get_item_transform(
    reshaped_return_data: np.ndarray,
    representation_name: str,
    transform=None,
    height: int = 240,
    width: int = 304,
    num_events: int = 50000,
    time_window: int = 1000000,
    device="cuda",
) -> np.ndarray:
    """The reference's host API (gen1_transforms.py:12-89): a structured
    array with fields x, y, t, p (p in {-1, +1}) in, float32 (H, W, C) out.
    ``transform`` and ``time_window`` are accepted for the signature and
    ignored (the name selects the function). Runs on ``device`` (``cuda``
    unless the caller asks for ``cpu``)."""
    del transform, time_window
    device = resolve_device(device)
    ev = reshaped_return_data
    n = len(ev)
    capacity = max(num_events, n)

    if _kind(representation_name) == "tore":
        # the reference computes TORE on the event bounding box: x, y shifted
        # by their minima, the frame sized by the shifted maxima
        # (gen1_transforms.py:57-64)
        x = np.asarray(ev["x"]).astype(np.int64)
        y = np.asarray(ev["y"]).astype(np.int64)
        x, y = x - x.min(), y - y.min()
        fh, fw = int(y.max()) + 1, int(x.max()) + 1

        def pad(a):
            return torch.from_numpy(np.pad(a, (0, capacity - n)).astype(np.int32))

        block = EventBlock(x=pad(x), y=pad(y),
                           t=pad(np.asarray(ev["t"]).astype(np.int64) - int(ev["t"][0])),
                           p=pad(np.asarray(ev["p"])),
                           num=torch.tensor(n, dtype=torch.int32)).to(device)
        rep = tore(block, fh, fw, k=6) * 255.0
    else:
        block = from_structured(ev, capacity).to(device)
        rep = build_representation(representation_name, block, height, width)
    return rep.cpu().numpy().astype(np.float32)
