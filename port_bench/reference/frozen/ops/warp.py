"""Device-side geometric augmentation (the JAX package's ``ops/warp.py``):
affine warp, 4-tile mosaic composition and mixup blending of letterboxed
images, executing an :class:`AugPlan` planned on the host
(``data/augment.py::plan_augment_batch``).

Two executors of the same plan:
- :func:`compose_warp`, exact: every output pixel is mapped through the
  inverse affine into the mosaic canvas, routed to one of the 4 source tiles
  and bilinearly sampled (cv2.warpAffine semantics, pad 114).
- :func:`compose_warp_separable`: the warp factored into two 1-D passes
  over a statically composed 2x2 source grid. Each pass shifts every row by
  an integer (the roll, kernel K3 in ``ops/roll.py``) and then interpolates
  with 4 shared-index taps (``torch.index_select``). Valid when
  :func:`separable_eligible` accepts the plan.

Images are NHWC on the 0..255 scale, as at the JAX package's boundary.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F


PAD_VALUE = 114.0
WARP_SEP_PAD = 192  # static roll capacity (px); see separable_eligible


class AugPlan(NamedTuple):
    """Per-batch geometric plan. A plain random_affine sample is one tile
    covering the canvas, ``src_idx`` pointing at the sample itself and
    ``mix_r`` 1."""

    src_idx: torch.Tensor  # (B, 4) int: batch row feeding each mosaic tile
    inv_affine: torch.Tensor  # (B, 2, 3) f32: output px -> canvas px
    tile_boxes: torch.Tensor  # (B, 4, 4) f32: canvas-space [x1, y1, x2, y2]
    tile_offsets: torch.Tensor  # (B, 4, 2) f32: source px = canvas px - offset
    mix_idx: torch.Tensor  # (B,) int: batch row blended in by mixup
    mix_r: torch.Tensor  # (B,) f32: self weight (1 = no mixup)
    fwd_affine: Optional[torch.Tensor] = None  # (B, 2, 3) canvas px -> output px

    def to(self, device) -> "AugPlan":
        return AugPlan(*(None if v is None else torch.as_tensor(v).to(device) for v in self))


def identity_plan(batch_size: int, out_size: int) -> AugPlan:
    """A no-op plan (NumPy leaves): tile 0 covers the frame, tiles 1-3 are
    empty."""
    eye = np.tile(np.array([[1.0, 0, 0], [0, 1.0, 0]], np.float32), (batch_size, 1, 1))
    boxes = np.zeros((batch_size, 4, 4), np.float32)
    boxes[:, 0] = (0.0, 0.0, out_size, out_size)
    return AugPlan(
        src_idx=np.tile(np.arange(batch_size, dtype=np.int32)[:, None], (1, 4)),
        inv_affine=eye,
        tile_boxes=boxes,
        tile_offsets=np.zeros((batch_size, 4, 2), np.float32),
        mix_idx=np.arange(batch_size, dtype=np.int32),
        mix_r=np.ones((batch_size,), np.float32),
        fwd_affine=eye.copy(),
    )


def route_output_pixels(plan: AugPlan, out_size: int):
    """Map every output pixel through the inverse affine into canvas space,
    test the 4 disjoint tile boxes (first hit wins) and resolve the source
    position. Returns (sx, sy) source coordinates (B, S, S) f32, the routed
    source row (B, S, S) int64 and the any-tile coverage mask."""
    dev = plan.inv_affine.device
    B = plan.src_idx.shape[0]
    ys, xs = torch.meshgrid(torch.arange(out_size, dtype=torch.float32, device=dev),
                            torch.arange(out_size, dtype=torch.float32, device=dev),
                            indexing="ij")
    inv = plan.inv_affine[:, :, :, None, None]  # (B, 2, 3, 1, 1)
    cx = inv[:, 0, 0] * xs + inv[:, 0, 1] * ys + inv[:, 0, 2]
    cy = inv[:, 1, 0] * xs + inv[:, 1, 1] * ys + inv[:, 1, 2]
    box = plan.tile_boxes[:, :, :, None, None]  # (B, 4, 4, 1, 1)
    inside = ((cx[:, None] >= box[:, :, 0]) & (cx[:, None] < box[:, :, 2])
              & (cy[:, None] >= box[:, :, 1]) & (cy[:, None] < box[:, :, 3]))
    tile = inside.to(torch.uint8).argmax(1)  # (B, S, S), first hit
    covered = inside.any(1)

    def per_pixel(table):  # (B, 4) -> (B, S, S) selected by tile id
        out = table[:, 0, None, None].expand(B, out_size, out_size)
        for k in range(1, 4):
            out = torch.where(tile == k, table[:, k, None, None], out)
        return out

    sx = cx - per_pixel(plan.tile_offsets[:, :, 0])
    sy = cy - per_pixel(plan.tile_offsets[:, :, 1])
    src = per_pixel(plan.src_idx.to(torch.int64))
    return sx, sy, src, covered


def compose_warp(images: torch.Tensor, plan: AugPlan, out_size: int,
                 gather_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Exact executor: mosaic routing + bilinear affine sampling + mixup.
    ``images`` (P, H, W, C) may hold more rows than the plan (a partner
    pool); ``gather_dtype`` narrows the sampled source only. Returns
    (B, out_size, out_size, C) in the images' dtype."""
    P, H, W, C = images.shape
    sx, sy, src, covered = route_output_pixels(plan, out_size)
    x0, y0 = sx.floor(), sy.floor()
    wx, wy = sx - x0, sy - y0
    gathered = images if gather_dtype is None else images.to(gather_dtype)
    padded = F.pad(gathered, (0, 0, 1, 1, 1, 1))  # 1-px border: (P, H+2, W+2, C)
    yi = y0.clamp(-1, H - 1).to(torch.int64) + 1
    xi = x0.clamp(-1, W - 1).to(torch.int64) + 1

    acc_dtype = torch.promote_types(images.dtype, torch.float32)
    out = torch.zeros((src.shape[0], out_size, out_size, C), dtype=acc_dtype, device=images.device)
    for dy in (0, 1):
        for dx in (0, 1):
            w = ((1 - wx) if dx == 0 else wx) * ((1 - wy) if dy == 0 else wy)
            valid = ((x0 + dx >= 0) & (x0 + dx < W) & (y0 + dy >= 0) & (y0 + dy < H)
                     & covered)
            patch = padded[src, yi + dy, xi + dx]
            v = torch.where(valid[..., None], patch, torch.tensor(PAD_VALUE, dtype=patch.dtype,
                                                                  device=patch.device))
            out = out + w[..., None] * v.to(acc_dtype)
    r = plan.mix_r[:, None, None, None]
    return (r * out + (1.0 - r) * out[plan.mix_idx.to(torch.int64)]).to(images.dtype)


def separable_eligible(plan: AugPlan, out_size: int, pad: int = WARP_SEP_PAD) -> bool:
    """Host check that every sample's cross-terms fit the static roll pad
    (|d/a| * 2S and |b| * S bounded) and the x-slope is invertible."""
    inv = np.asarray(torch.as_tensor(plan.inv_affine).cpu(), np.float64)
    a, b = inv[:, 0, 0], inv[:, 0, 1]
    d = inv[:, 1, 0]
    if np.any(np.abs(a) < 1e-3):
        return False
    if float(np.max(np.abs(d / a))) * 2 * out_size + 2 > pad:
        return False
    if float(np.max(np.abs(b))) * out_size + 2 > pad:
        return False
    return True


def separable_hyp_eligible(hyp: dict, out_size: int, pad: int = WARP_SEP_PAD) -> bool:
    """Per-run eligibility from the hyp RANGES: bounds max |b| and |d/a| of
    every plan the hyp can emit over a dense grid of the angle/shear box at
    the scale extremes, with a x1.2 margin."""
    deg = math.radians(float(hyp.get("degrees", 0.0)))
    sh = math.radians(float(hyp.get("shear", 0.0)))
    s_lo = 1.0 - float(hyp.get("scale", 0.0))
    if s_lo < 1e-2:
        return False  # near-singular zoom: |d/a| unbounded
    th = np.linspace(-deg, deg, 41)[:, None, None]
    tx = np.tan(np.linspace(-sh, sh, 21))[None, :, None]
    ty = np.tan(np.linspace(-sh, sh, 21))[None, None, :]
    m00 = np.cos(th) - tx * np.sin(th)
    m01 = np.sin(th) + tx * np.cos(th)
    m10 = ty * np.cos(th) - np.sin(th)
    m11 = ty * np.sin(th) + np.cos(th)
    detn = m00 * m11 - m01 * m10
    a = m11 / (s_lo * detn)
    b = -m01 / (s_lo * detn)
    d_over_a = -m10 / np.where(np.abs(m11) < 1e-9, 1e-9, m11)
    if float(np.min(np.abs(a))) * s_lo / (1.0 + float(hyp.get("scale", 0.0))) \
            < 1e-3 or float(np.min(np.abs(m11))) < 1e-3:
        return False
    margin = 1.2
    if margin * float(np.max(np.abs(d_over_a))) * 2 * out_size + 2 > pad:
        return False
    if margin * float(np.max(np.abs(b))) * out_size + 2 > pad:
        return False
    return True


def _hat(t):
    return (1.0 - t.abs()).clamp(min=0.0)


def _tap_select(rolled, idx):
    """``rolled`` (B, R, W, C), ``idx`` (B, N) -> (B, R, N, C) with
    ``out[b] = rolled[b][:, idx[b]]``."""
    return torch.stack([rolled[b].index_select(1, idx[b]) for b in range(rolled.shape[0])])


def _resample_pass(rolled, slope, offset, frac, shift, lo, hi, n_out: int, pad: int, padv):
    """One pass of the separable warp over rolled rows ``rolled``
    (B, R, W + 3, C): output column j of row r samples rolled column
    ``slope * j + offset`` with the 4 hat-weighted taps around its floor,
    the sub-pixel roll remainder ``frac`` (B, R) folded into the weights.
    Taps outside [lo, hi) of the composed grid, or rows whose integer roll
    ``shift`` (B, R) overflowed the pad, read ``padv``. -> (B, R, n_out, C)."""
    B, R, W3, C = rolled.shape
    base = slope[:, None] * torch.arange(n_out, dtype=torch.float32, device=rolled.device) \
        + offset[:, None]  # (B, n_out)
    j = base.floor()
    g = base - j
    ji = j.to(torch.int64)
    acc = torch.zeros((B, R, n_out, C), dtype=torch.float32, device=rolled.device)
    for k in range(-1, 3):
        tap = _tap_select(rolled, (ji + (k + 1)).clamp(0, W3 - 1))  # (B, R, n_out, C)
        wgt = _hat(g[:, None, :] + frac[:, :, None] - k)  # (B, R, n_out)
        pos = j[:, None, :] + k + shift[:, :, None]
        # the |shift| <= pad-1 term degrades roll overflow (ineligible plans
        # that slipped through) to pad instead of silently wrong pixels
        valid = ((pos >= lo[:, None, None]) & (pos < hi[:, None, None])
                 & (shift.abs() <= pad - 1)[:, :, None])
        acc = acc + wgt[..., None] * torch.where(valid[..., None], tap.to(torch.float32), padv)
    return acc
