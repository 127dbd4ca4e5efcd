"""Representation dispatcher: name -> batched builder
``EventBlock (B, N) -> (B, H, W, C)`` float32, scaled by 255 like every
reference branch (the JAX package's ``reps/dispatch.py``)."""
from __future__ import annotations

from typing import Callable

from ..events.core import EventBlock
from .fused_mdes import ergo12_fused_batched


def _is_ergo12(name: str) -> bool:
    return "MixedDensityEventStack" in name or name in ("OptimizedRepresentation", "ERGO12")


def batched_representation(name: str, height: int, width: int) -> Callable:
    """Batched builder. MDES/ERGO-12 run on the fused segment-reduce kernel
    (its plain version for CPU tensors); the other representations are
    ROADMAP item M12."""
    if not _is_ergo12(name):
        raise NotImplementedError(
            f"representation {name!r} is not ported yet (ROADMAP M12); "
            "this port builds MixedDensityEventStack/OptimizedRepresentation/ERGO12"
        )

    def fn(blocks: EventBlock):
        return ergo12_fused_batched(blocks.as_int32(), height, width) * 255.0

    return fn
