"""TORE, Time-Ordered Recent Events (port of the JAX package's
``reps/tore.py``).

Per pixel and polarity, the k=6 smallest time-deltas ``sampleTime - t`` among
events with ``t < sampleTime`` (strict: the events at the sample time are
left out), log-scaled as ``clamp(log(dt + 1) - log(151), min=0)`` with dt
clamped to 500e6 us. Positive polarity is ``p > 0``; channels are k positive
then k negative.

The stream is time-sorted, so the k smallest deltas are the k most recent
qualifying events: one sorted segmented top-k
(:func:`..ops.scatter.segment_topk_recent_values`). The k slots hold the
deltas sorted ascending (most recent first), as in the JAX package; the
reference keeps ``np.partition``'s unspecified order, the same set of values.
It has no kernel: a batch is one sort over all its events, each sample's
segments offset by its row.
"""
from __future__ import annotations

import math

import torch

from ..events.core import EventBlock
from ..ops import scatter

K_DEFAULT = 6
MIN_TIME = 150.0
MAX_TIME = 500e6


def tore(block: EventBlock, height: int, width: int, k: int = K_DEFAULT) -> torch.Tensor:
    """(..., H, W, 2k) float32 log-scaled TORE volume on the full grid, for
    leaves ``(N,)`` or ``(B, N)``."""
    lead = block.x.shape[:-1]
    n_rows = math.prod(lead)
    last = torch.clamp(block.num - 1, min=0).to(torch.int64)[..., None]
    t_last = block.t.gather(-1, last)
    sample_time = t_last.to(torch.float32)
    qualifies = block.mask & (block.t < t_last)  # strict (tore.py:17)

    hw = height * width
    pix = scatter.flat_pixel_index(block.x, block.y, width)
    seg = torch.where(block.p > 0, pix, hw + pix)  # [pos plane | neg plane]
    rows = torch.arange(n_rows, dtype=torch.int32, device=seg.device).reshape(*lead, 1)
    tvals = scatter.segment_topk_recent_values(
        block.index().reshape(-1), (seg + rows * 2 * hw).reshape(-1), qualifies.reshape(-1),
        block.t.reshape(-1), n_rows * 2 * hw, k, fill=-float("inf"),
    ).reshape(*lead, 2 * hw * k)
    dts = torch.clamp(sample_time - tvals, max=MAX_TIME)  # empty slots: dt = +inf
    vals = torch.clamp(torch.log(dts + 1.0) - math.log(MIN_TIME + 1.0), min=0.0)
    vals = vals.reshape(*lead, 2, height, width, k)
    return torch.cat([vals[..., 0, :, :, :], vals[..., 1, :, :, :]], dim=-1)
