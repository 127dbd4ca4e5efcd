"""Swin Transformer V2 backbone in plain float32 PyTorch, for the plain
reference of the ``gen1_swinvit`` configuration.

Written from the published block (Liu et al., *Swin Transformer V2: Scaling
Up Capacity and Resolution*, CVPR 2022, arXiv:2111.09883) as ev-YOLOv6
carries it (``yolov6/models/swin_transformer_v2.py:659-862``,
``swin_transformerv2('large')``: embed 192, depths 2/2/18/2, heads
6/12/24/48, window 12, patch 4), not copied from the port: the continuous
position bias is computed on the (2ws - 1)² table of offsets and gathered
by a relative-position index, the shift mask from the region map, as the
published code does. It imports nothing of the port or of JAX, and runs
under the TF32 switches the harness sets (off for this configuration).

The port follows the JAX package, which departs from the published block
in the places marked DEPARTURE below; this file computes what the port
computes there, so that the benchmark compares like with like:

1. qkv bias: published, a learned q bias and v bias and no k bias; JAX, one
   learned bias over q, k and v.
2. q and k normalisation: published ``F.normalize`` (divide by max(norm,
   1e-12)); JAX, divide by norm + 1e-6.
3. LayerNorm: published eps 1e-5 (``nn.LayerNorm``); JAX, Flax's 1e-6.
4. GELU: published exact (erf); JAX, Flax's tanh approximation.
5. Padding: the published block needs maps that are window multiples; JAX
   pads the bottom and right with zeros to a multiple (stage 3 at 576²:
   18² to 24²), builds the shift mask over the padded map, and lets the
   padding take part in attention (only shift regions are masked).
6. Stage outputs: each stage's output after its patch merging (stages
   0-2), LayerNormed (``out_norm_<s>``) and pooled to the fixed grid
   ``FIXED_GRID`` over channels and space, as ev-YOLOv6's
   ``forward_features`` pools its four scales.
7. No dropout or drop path (the published preset trains with drop path).

Parameter names are the port's (``stage<s>_block<b>``, ``merge<s>``,
``cpb_mlp_0``, ...), so that one seeded state dict loads into both. No
buffers: the tables are made per device and window on first use.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .backbones import FIXED_GRID
from .layers import adaptive_avg_pool_chw

LN_EPS = 1e-6  # DEPARTURE 3
NORM_EPS = 1e-6  # DEPARTURE 2
MASK = -100.0
_TABLES: Dict = {}


def _cached(key, make):
    if key not in _TABLES:
        _TABLES[key] = make()
    return _TABLES[key]


def coords_table(ws: int, device) -> torch.Tensor:
    """((2ws - 1)², 2) log-spaced offsets (dy, dx), the CPB MLP's input
    (``relative_coords_table``, pretrained window 0)."""
    def make():
        r = torch.arange(-(ws - 1), ws, dtype=torch.float32, device=device)
        t = torch.stack(torch.meshgrid(r, r, indexing="ij"), dim=-1).reshape(-1, 2)
        t = t / max(ws - 1, 1) * 8.0
        return torch.sign(t) * torch.log2(t.abs() + 1.0) / math.log2(8)
    return _cached(("coords", ws, str(device)), make)


def relative_index(ws: int, device) -> torch.Tensor:
    """(N, N) index of token i's offset from token j in :func:`coords_table`
    (``relative_position_index``)."""
    def make():
        a = torch.arange(ws, device=device)
        coords = torch.stack(torch.meshgrid(a, a, indexing="ij")).flatten(1)  # (2, N)
        rel = coords[:, :, None] - coords[:, None, :] + (ws - 1)
        return rel[0] * (2 * ws - 1) + rel[1]
    return _cached(("index", ws, str(device)), make)


def partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * windows, ws * ws, C), windows in row order."""
    B, H, W, C = x.shape
    x = x.view(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, C)


def unpartition(w: torch.Tensor, ws: int, H: int, W: int) -> torch.Tensor:
    B = w.shape[0] // ((H // ws) * (W // ws))
    x = w.view(B, H // ws, W // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, -1)


def shift_mask(H: int, W: int, ws: int, shift: int, device) -> torch.Tensor:
    """(windows, N, N) additive mask of a block shifted by ``shift`` on an
    (H, W) map: 0 between tokens of one region of the rolled map, -100
    across regions."""
    def make():
        regions = torch.zeros((1, H, W, 1), device=device)
        cnt = 0
        for h in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            for w in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
                regions[:, h, w, :] = cnt
                cnt += 1
        win = partition(regions, ws).squeeze(-1)
        diff = win[:, None, :] - win[:, :, None]
        return torch.where(diff != 0, MASK, 0.0)
    return _cached(("mask", H, W, ws, shift, str(device)), make)


class WindowAttention(nn.Module):
    """Cosine attention in windows with the continuous position bias."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)  # DEPARTURE 1
        self.logit_scale = nn.Parameter(torch.full((num_heads, 1, 1), math.log(10.0)))
        self.cpb_mlp_0 = nn.Linear(2, 512)
        self.cpb_mlp_1 = nn.Linear(512, num_heads, bias=False)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, ws: int, mask=None) -> torch.Tensor:
        B_, N, C = x.shape
        h = self.num_heads
        q, k, v = self.qkv(x).reshape(B_, N, 3, h, C // h).permute(2, 0, 3, 1, 4)
        q = q / (q.norm(dim=-1, keepdim=True) + NORM_EPS)
        k = k / (k.norm(dim=-1, keepdim=True) + NORM_EPS)
        attn = (q @ k.transpose(-2, -1)) * self.logit_scale.clamp(max=math.log(100.0)).exp()
        table = self.cpb_mlp_1(F.relu(self.cpb_mlp_0(coords_table(ws, x.device))))  # (T, h)
        bias = table[relative_index(ws, x.device).reshape(-1)].view(N, N, h).permute(2, 0, 1)
        attn = attn + 16.0 * torch.sigmoid(bias)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.view(B_ // nw, nw, h, N, N) + mask[None, :, None]).view(B_, h, N, N)
        out = (attn.softmax(dim=-1) @ v).transpose(1, 2).reshape(B_, N, C)
        return self.proj(out)


class Block(nn.Module):
    """Post-norm Swin-V2 block: x + norm1(attention), then x + norm2(MLP)."""

    def __init__(self, dim: int, num_heads: int, window: int, shift: int, masked: bool):
        super().__init__()
        self.window, self.shift, self.masked = window, shift, masked
        self.attn = WindowAttention(dim, num_heads)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp_fc1 = nn.Linear(dim, 4 * dim)
        self.mlp_fc2 = nn.Linear(4 * dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        B, L, C = x.shape
        # a map no larger than the window: one window of the map, no shift
        ws = min(self.window, H, W)
        shift = self.shift if ws < min(H, W) else 0
        Hp, Wp = math.ceil(H / ws) * ws, math.ceil(W / ws) * ws
        y = F.pad(x.view(B, H, W, C), (0, 0, 0, Wp - W, 0, Hp - H))  # DEPARTURE 5
        mask = None
        if shift:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
            if self.masked:
                mask = shift_mask(Hp, Wp, ws, shift, x.device)
        y = unpartition(self.attn(partition(y, ws), ws, mask), ws, Hp, Wp)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + self.norm1(y[:, :H, :W].reshape(B, L, C))
        mlp = self.mlp_fc2(F.gelu(self.mlp_fc1(x), approximate="tanh"))  # DEPARTURE 4
        return x + self.norm2(mlp)


class PatchMerging(nn.Module):
    """2x2 neighbours concatenated (odd sides padded), then a bias-free
    linear 4C -> 2C and its LayerNorm (V2 normalises after the reduction)."""

    def __init__(self, dim: int):
        super().__init__()
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(2 * dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        B, L, C = x.shape
        y = F.pad(x.view(B, H, W, C), (0, 0, 0, W % 2, 0, H % 2))
        y = torch.cat([y[:, 0::2, 0::2], y[:, 1::2, 0::2], y[:, 0::2, 1::2], y[:, 1::2, 1::2]],
                      dim=-1)
        return self.norm(self.reduction(y.reshape(B, -1, 4 * C)))


class SwinTransformerV2(nn.Module):
    """Patch embedding, four stages of blocks (every second one shifted by
    half a window) with patch merging between them, and the four pooled
    outputs (DEPARTURE 6). ``masked`` False leaves the shift mask out (the
    reference's planted fault ``no_shift_mask``); ``checkpoint`` True
    recomputes each block in the backward pass (the same operations on the
    same inputs) instead of keeping its activations."""

    def __init__(self, in_channels: int, embed_dim: int = 192,
                 depths: Sequence[int] = (2, 2, 18, 2),
                 num_heads: Sequence[int] = (6, 12, 24, 48), window: int = 12,
                 patch: int = 4, masked: bool = True):
        super().__init__()
        self.depths = tuple(depths)
        self.checkpoint = False
        self.patch_embed = nn.Conv2d(in_channels, embed_dim, patch, patch)
        self.patch_norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        dim = embed_dim
        for s, depth in enumerate(self.depths):
            for b in range(depth):
                self.add_module(f"stage{s}_block{b}", Block(
                    dim, num_heads[s], window, window // 2 if b % 2 else 0, masked))
            if s < len(self.depths) - 1:
                self.add_module(f"merge{s}", PatchMerging(dim))
                dim *= 2
            self.add_module(f"out_norm_{s}", nn.LayerNorm(dim, eps=LN_EPS))
        self.out_channels = tuple(c for c, _, _ in FIXED_GRID)

    def forward(self, x: torch.Tensor):
        x = self.patch_embed(x)
        B, C, H, W = x.shape
        x = self.patch_norm(x.flatten(2).transpose(1, 2))
        outs = []
        for s, depth in enumerate(self.depths):
            for b in range(depth):
                block = getattr(self, f"stage{s}_block{b}")
                if self.checkpoint and torch.is_grad_enabled():
                    x = checkpoint(block, x, H, W, use_reentrant=False)
                else:
                    x = block(x, H, W)
            if s < len(self.depths) - 1:
                x = getattr(self, f"merge{s}")(x, H, W)
                H, W = (H + 1) // 2, (W + 1) // 2
            t = getattr(self, f"out_norm_{s}")(x)
            outs.append(adaptive_avg_pool_chw(t.transpose(1, 2).reshape(B, -1, H, W),
                                              *FIXED_GRID[s]))
        return tuple(outs)
