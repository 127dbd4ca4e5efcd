"""Genuine Swin Transformer V2 backbone (the JAX package's
``models/swin_vit.py``), distinct from the CSP conv network that shares its
name (:class:`.backbones.CSPBackboneP6`).

Swin-V2 as the JAX package writes it, on (B, L, C) token tensors:
- cosine attention (q and k divided by ``norm + 1e-6``) with a learnable
  temperature ``logit_scale`` (h, 1, 1), clamped at log 100 before ``exp``;
- a continuous relative position bias: a 2-layer MLP (``cpb_mlp_0`` 2->512
  with ReLU, ``cpb_mlp_1`` 512->h without bias) over log-spaced offsets,
  then ``16 * sigmoid``;
- post-norm residuals, Flax LayerNorm (eps 1e-6), Flax ``nn.gelu`` (the
  tanh approximation);
- shifted windows (shift 0 when the window is not smaller than the map)
  with the additive -100 mask, feature maps padded to window multiples;
- patch merging between stages; stages 0-2 emit the post-merge tensor.

The four outputs are LayerNormed and pooled to the fixed (C, H, W) grid
(:data:`.backbones.FIXED_GRID`).

Spans (``utils/profiling.py``; a flag read unless a profiler records):
``swin/attn`` around each window attention, ``swin/mlp`` around a block's
MLP, ``swin/merge`` around a patch merging; counters ``swin/windows``
(windows attended, images x windows an image) and ``swin/tokens`` (their
tokens, the padding included). The attention is plain ``matmul`` and
``softmax``: no fused attention kernel, whose additive bias and mask would
not be comparable bit for bit.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.profiling import count, span
from .backbones import FIXED_GRID
from .layers import adaptive_avg_pool_chw


def window_partition(x, ws: int):
    """(B, H, W, C) -> (B*nW, ws*ws, C)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, C)


def window_reverse(win, ws: int, H: int, W: int):
    """(B*nW, ws*ws, C) -> (B, H, W, C)."""
    B = win.shape[0] // ((H // ws) * (W // ws))
    x = win.reshape(B, H // ws, W // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, -1)


def _relative_coords_log(ws: int) -> np.ndarray:
    """Log-spaced normalised relative coordinates (N, N, 2) for the CPB MLP."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0).astype(np.float32)
    rel = rel / max(ws - 1, 1) * 8.0
    return (np.sign(rel) * np.log2(np.abs(rel) + 1.0) / np.log2(8)).astype(np.float32)


def _shift_mask(H: int, W: int, ws: int, shift: int) -> np.ndarray:
    """Additive attention mask (nW, N, N) for shifted windows: 0 within a
    region, -100 across regions."""
    img = np.zeros((1, H, W, 1))
    cnt = 0
    for h in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for w in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, h, w, :] = cnt
            cnt += 1
    win = img.reshape(1, H // ws, ws, W // ws, ws, 1).transpose(0, 1, 3, 2, 4, 5)
    win = win.reshape(-1, ws * ws)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


_CONSTANTS = {}


def _constant(fn, *args, device):
    """``fn(*args)`` (a NumPy table) on ``device``, made once per arguments
    and device, as a normal tensor even under ``inference_mode`` (a later
    train forward saves it for backward)."""
    key = (fn.__name__, args, str(device))
    if key not in _CONSTANTS:
        with torch.inference_mode(False):
            _CONSTANTS[key] = torch.from_numpy(fn(*args)).to(device)
    return _CONSTANTS[key]


class WindowAttentionV2(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.logit_scale = nn.Parameter(torch.full((num_heads, 1, 1), math.log(10.0)))
        self.cpb_mlp_0 = nn.Linear(2, 512)
        self.cpb_mlp_1 = nn.Linear(512, num_heads, bias=False)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, ws: int, mask=None):
        with span("swin/attn"):
            B_, N, C = x.shape
            count("swin/windows", B_)
            count("swin/tokens", B_ * N)
            h = self.num_heads
            q, k, v = self.qkv(x).reshape(B_, N, 3, h, C // h).permute(2, 0, 3, 1, 4)
            q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-6)
            k = k / (torch.linalg.vector_norm(k, dim=-1, keepdim=True) + 1e-6)
            scale = torch.exp(self.logit_scale.clamp(max=math.log(100.0)))
            attn = (q @ k.transpose(-2, -1)) * scale
            rel = _constant(_relative_coords_log, ws, device=x.device)
            bias = 16.0 * torch.sigmoid(self.cpb_mlp_1(F.relu(self.cpb_mlp_0(rel))))  # (N, N, h)
            attn = attn + bias.permute(2, 0, 1)[None]
            if mask is not None:
                nW = mask.shape[0]
                attn = (attn.reshape(B_ // nW, nW, h, N, N) + mask[None, :, None]).reshape(
                    B_, h, N, N)
            out = (torch.softmax(attn, dim=-1) @ v).transpose(1, 2).reshape(B_, N, C)
            return self.proj(out)


class SwinBlockV2(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int, shift: int,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.window_size = window_size
        self.shift = shift
        self.attn = WindowAttentionV2(dim, num_heads)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp_fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x, H: int, W: int):
        B, L, C = x.shape
        ws = min(self.window_size, H, W)
        shift = self.shift if ws < min(H, W) else 0
        y = x.reshape(B, H, W, C)
        Hp, Wp = -(-H // ws) * ws, -(-W // ws) * ws
        if (Hp, Wp) != (H, W):
            y = F.pad(y, (0, 0, 0, Wp - W, 0, Hp - H))
        mask = None
        if shift > 0:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
            mask = _constant(_shift_mask, Hp, Wp, ws, shift, device=x.device)
        y = window_reverse(self.attn(window_partition(y, ws), ws, mask), ws, Hp, Wp)
        if shift > 0:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        y = y[:, :H, :W].reshape(B, L, C)
        x = x + self.norm1(y)  # post-norm residuals
        with span("swin/mlp"):
            h = self.mlp_fc2(F.gelu(self.mlp_fc1(x), approximate="tanh"))
        return x + self.norm2(h)


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(2 * dim, eps=1e-6)

    def forward(self, x, H: int, W: int):
        with span("swin/merge"):
            B, L, C = x.shape
            y = x.reshape(B, H, W, C)
            if H % 2 or W % 2:  # pad odd sides
                y = F.pad(y, (0, 0, 0, W % 2, 0, H % 2))
            parts = [y[:, 0::2, 0::2], y[:, 1::2, 0::2], y[:, 0::2, 1::2], y[:, 1::2, 1::2]]
            y = torch.cat(parts, dim=-1).reshape(B, -1, 4 * C)
            return self.norm(self.reduction(y))


class SwinTransformerV2ViT(nn.Module):
    """4-stage Swin-V2; the defaults are the 'large' preset (embed 192,
    depths 2/2/18/2, heads 6/12/24/48, window 12, patch 4)."""

    def __init__(self, in_channels: int, embed_dim: int = 192,
                 depths: Sequence[int] = (2, 2, 18, 2),
                 num_heads: Sequence[int] = (6, 12, 24, 48), window_size: int = 12,
                 patch_size: int = 4):
        super().__init__()
        self.depths = tuple(depths)
        self.patch_embed = nn.Conv2d(in_channels, embed_dim, patch_size, patch_size, bias=True)
        self.patch_norm = nn.LayerNorm(embed_dim, eps=1e-6)
        dim = embed_dim
        for s, depth in enumerate(self.depths):
            for b in range(depth):
                self.add_module(f"stage{s}_block{b}", SwinBlockV2(
                    dim, num_heads[s], window_size, 0 if b % 2 == 0 else window_size // 2))
            if s < len(self.depths) - 1:
                self.add_module(f"merge{s}", PatchMerging(dim))
                dim *= 2
            self.add_module(f"out_norm_{s}", nn.LayerNorm(dim, eps=1e-6))
        self.out_channels = tuple(c for c, _, _ in FIXED_GRID)

    def forward(self, x):
        x = self.patch_embed(x)
        B, C, H, W = x.shape
        x = self.patch_norm(x.flatten(2).transpose(1, 2))
        feats = []
        for s, depth in enumerate(self.depths):
            for b in range(depth):
                x = getattr(self, f"stage{s}_block{b}")(x, H, W)
            if s < len(self.depths) - 1:
                x = getattr(self, f"merge{s}")(x, H, W)
                H, W = (H + 1) // 2, (W + 1) // 2
            t = getattr(self, f"out_norm_{s}")(x)
            t = t.transpose(1, 2).reshape(B, t.shape[-1], H, W)
            feats.append(adaptive_avg_pool_chw(t, *FIXED_GRID[s]))
        return tuple(feats)
