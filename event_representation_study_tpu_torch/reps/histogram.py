"""2-channel polarity event histogram ("ToImage"): per-pixel event counts
split by polarity, channel 0 negative, channel 1 positive (port of the JAX
package's ``reps/histogram.py``; the reference maps polarities to {0, 1}
and applies tonic's ``ToImage((W, H, 2))``)."""
from __future__ import annotations

import torch

from ..events.core import EventBlock
from ..ops import scatter


def event_histogram(block: EventBlock, height: int, width: int) -> torch.Tensor:
    """(H, W, 2) float32 counts; ch0 = p<=0 events, ch1 = p>0 events."""
    seg = scatter.flat_pixel_index(block.x, block.y, width)
    mask = block.mask
    n = height * width
    c_neg = scatter.segment_count(seg, mask & (block.p <= 0), n).reshape(height, width)
    c_pos = scatter.segment_count(seg, mask & (block.p > 0), n).reshape(height, width)
    return torch.stack([c_neg, c_pos], dim=-1)
