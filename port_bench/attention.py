"""The least work of one forward of a Swin-V2 window attention, from its
shapes alone, for ``attn_roofline.swin``: whatever computes the attention
(the port's plain matmuls today, a fused kernel later), it is judged by
the same count.

FLOPs, 2 per multiply-add of the matrix products only: qkv (C -> 3C) and
proj (C -> C) over every token, q kᵀ and attn v over every window and head,
and the continuous position bias's MLP (2 -> hidden -> heads) over the
(2ws - 1)² offsets of the window, as the published block computes it.
Masking, softmax, norms and the 16·sigmoid are not counted; the count
equals ``torch.utils.flop_counter`` on the reference's attention
(``reference/frozen/models/swin_vit.py::WindowAttention``).

Bytes, float32, each read or written once: the tokens in and out, every
weight and bias of the attention, the CPB's table of offsets and its bias
table ((2ws - 1)² x heads), and the shift mask (windows x N x N) where the
block is masked.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

from .yardstick import HBM_BYTES_PER_S

F32 = 4


@dataclasses.dataclass(frozen=True)
class AttnCall:
    windows: int  # windows of the call: images x windows an image
    tokens: int  # tokens a window, ws²
    dim: int  # channels C
    heads: int
    window: int  # ws
    hidden: int  # the CPB MLP's hidden width
    mask_windows: int  # windows of the shift mask, 0 when unmasked


def call_of(module, x, ws: int, mask=None) -> AttnCall:
    """The shapes of one ``WindowAttentionV2.forward(x, ws, mask)`` call of
    the port (or of the reference's ``WindowAttention``), read without
    touching the device."""
    windows, tokens, dim = x.shape
    return AttnCall(int(windows), int(tokens), int(dim), int(module.num_heads), int(ws),
                    int(module.cpb_mlp_0.out_features),
                    0 if mask is None else int(mask.shape[0]))


def flops(c: AttnCall) -> int:
    offsets = (2 * c.window - 1) ** 2
    linear = 2 * c.windows * c.tokens * c.dim * (3 * c.dim + c.dim)  # qkv, proj
    scores = 2 * 2 * c.windows * c.tokens * c.tokens * c.dim  # q kᵀ, attn v (all heads)
    cpb = 2 * offsets * (2 * c.hidden + c.hidden * c.heads)
    return linear + scores + cpb


def least_bytes(c: AttnCall) -> int:
    offsets = (2 * c.window - 1) ** 2
    weights = (3 * c.dim * c.dim + 3 * c.dim + c.dim * c.dim + c.dim  # qkv, proj
               + 2 * c.hidden + c.hidden + c.hidden * c.heads + c.heads)  # CPB, logit_scale
    tables = offsets * 2 + offsets * c.heads + c.mask_windows * c.tokens * c.tokens
    return F32 * (2 * c.windows * c.tokens * c.dim + weights + tables)


def least_seconds(calls: Iterable[AttnCall], peak_flops: float) -> float:
    """Sum over ``calls`` of max(FLOPs / ``peak_flops``, least bytes / HBM
    rate): the least time the card could take for them."""
    return sum(max(flops(c) / peak_flops, least_bytes(c) / HBM_BYTES_PER_S) for c in calls)
