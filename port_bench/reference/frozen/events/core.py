"""Core event-stream structure: :class:`EventBlock`, a fixed-capacity,
mask-padded struct of torch tensors (counterpart of the JAX package's
``events/core.py``).

Conventions:
- x, y: int32 pixel coordinates, 0 <= x < W, 0 <= y < H
- t:    int32 microseconds, offset so the first valid event is at t=0
- p:    int32 polarity in {-1, +1}
- valid events occupy the first ``num`` slots; padding fills the tail.

Leaves are ``(N,)`` with ``num`` a 0-d tensor for one window, or ``(B, N)``
with ``num (B,)`` for a batch (:func:`stack_blocks`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class EventBlock:
    x: torch.Tensor  # int32 (..., N); int16 on the host->device wire
    y: torch.Tensor  # int32 (..., N); int16 on the wire
    t: torch.Tensor  # int32 (..., N) microseconds, window-relative
    p: torch.Tensor  # int32 (..., N) in {-1, +1}; int8 on the wire
    num: torch.Tensor  # int32 (...,) number of valid events

    def as_int32(self) -> "EventBlock":
        """Upcast a compact wire-format block (x/y int16, p int8) to the
        int32 every rep kernel computes in. int32 is load-bearing:
        ``y * width + x`` overflows int16 at 240x304. The single upcast site;
        returns self for blocks that are already int32."""
        leaves = (self.x, self.y, self.t, self.p, self.num)
        if all(a.dtype == torch.int32 for a in leaves):
            return self
        return EventBlock(*(a.to(torch.int32) for a in leaves))

    @property
    def mask(self) -> torch.Tensor:
        """bool (..., N): True for valid events (the first ``num`` slots)."""
        idx = torch.arange(self.x.shape[-1], dtype=torch.int32, device=self.x.device)
        return idx < self.num[..., None]

    def index(self) -> torch.Tensor:
        """int32 (..., N): position of each event within the block."""
        return torch.arange(self.x.shape[-1], dtype=torch.int32,
                            device=self.x.device).expand(self.x.shape)

    def to(self, device) -> "EventBlock":
        """The block on ``device``; NumPy leaves (a loader's wire blocks)
        become tensors of the same dtype."""
        return EventBlock(
            *(torch.as_tensor(a).to(device) for a in (self.x, self.y, self.t, self.p, self.num))
        )


def pad_events(x, y, t, p, capacity: int) -> EventBlock:
    """Pack host NumPy event arrays into a fixed-capacity :class:`EventBlock`.

    Keeps the **last** ``capacity`` events when the input is longer (the
    reference's fixed-size windows end at the label timestamp). Timestamps
    are re-offset so the first kept event is at t=0.
    """
    n = len(x)
    if n > capacity:
        x, y, t, p = x[-capacity:], y[-capacity:], t[-capacity:], p[-capacity:]
        n = capacity
    t = np.asarray(t, dtype=np.int64)
    if n > 0:
        t = t - t[0]

    def _pad(a):
        out = np.zeros(capacity, dtype=np.int32)
        out[:n] = a
        return torch.from_numpy(out)

    return EventBlock(
        x=_pad(x), y=_pad(y), t=_pad(t), p=_pad(p),
        num=torch.tensor(n, dtype=torch.int32),
    )


def from_structured(events: np.ndarray, capacity: int) -> EventBlock:
    """Build a block from a structured array with fields ``x, y, t, p``."""
    return pad_events(events["x"], events["y"], events["t"], events["p"], capacity)


def stack_blocks(blocks) -> EventBlock:
    """Stack same-capacity blocks into a batched block (leading axis B)."""
    return EventBlock(
        *(
            torch.stack([getattr(b, f.name) for b in blocks], dim=0)
            for f in dataclasses.fields(EventBlock)
        )
    )


def normalize_polarity(p: np.ndarray) -> np.ndarray:
    """Map {0,1} polarities to the canonical {-1,+1}."""
    p = np.asarray(p)
    if p.size and p.min() >= 0:
        return 2 * p.astype(np.int32) - 1
    return p.astype(np.int32)
