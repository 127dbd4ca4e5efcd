"""Stacked-Based-on-Number (SBN) binary event stack (port of the JAX
package's ``reps/event_stack.py``).

Stack 0 sees all N events, stack i the suffix left after dropping
``floor(N / 2^j)`` events for j = 1..i (the reference's halving loop). Each
stack is a last-write-wins polarity image: the polarity in {-1, 0, +1} of the
last event of each pixel within the suffix window.
"""
from __future__ import annotations

import torch

from ..events.core import EventBlock
from ..ops import scatter

STACK_SIZE = 12


def suffix_starts(num: torch.Tensor, stack_size: int = STACK_SIZE) -> torch.Tensor:
    """Start offset of each stack's suffix window, int32 ``(..., stack_size)``
    for ``num (...)``: o_0 = 0, o_{i+1} = o_i + floor(num / 2^{i+1})."""
    shifts = 2 ** torch.arange(1, stack_size, dtype=torch.int32, device=num.device)
    drops = num.to(torch.int32)[..., None] // shifts
    zero = torch.zeros((*num.shape, 1), dtype=torch.int32, device=num.device)
    return torch.cat([zero, torch.cumsum(drops, dim=-1, dtype=torch.int32)], dim=-1)


def event_stack(block: EventBlock, height: int, width: int,
                stack_size: int = STACK_SIZE) -> torch.Tensor:
    """(H, W, stack_size) float32; channel i = polarity of the last event of
    each pixel within suffix window i (0 where no event)."""
    starts = suffix_starts(block.num, stack_size)
    seg = scatter.flat_pixel_index(block.x, block.y, width)
    order = block.index()
    pol = torch.where(block.p > 0, 1.0, -1.0)
    stacks = torch.stack([
        scatter.scatter_last(pol, seg, block.mask & (order >= start), height * width)
        for start in starts
    ])
    return stacks.reshape(stack_size, height, width).permute(1, 2, 0)
