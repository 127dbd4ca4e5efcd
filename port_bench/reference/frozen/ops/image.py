"""Image geometry ops: device-side letterbox and the coordinate math of the
reference's cv2 pipeline (the JAX package's ``ops/image.py``).

``letterbox_image`` keeps the JAX layout, NHWC in and out; inside it works
on an NCHW view of the same memory.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

PAD_VALUE = 114.0


def letterbox_geometry(
    h0: int, w0: int, new_shape: int, scaleup: bool = True
) -> Tuple[float, Tuple[int, int], Tuple[float, float]]:
    """ratio, (new_h, new_w), (dw, dh) — letterbox(auto=False) semantics;
    without ``scaleup`` a frame smaller than ``new_shape`` keeps its size."""
    r = min(new_shape / h0, new_shape / w0)
    if not scaleup:
        r = min(r, 1.0)
    new_unpad = int(round(w0 * r)), int(round(h0 * r))  # (w, h)
    dw = (new_shape - new_unpad[0]) / 2
    dh = (new_shape - new_unpad[1]) / 2
    return r, (new_unpad[1], new_unpad[0]), (dw, dh)


def resize_weights(in_size: int, out_size: int, device=None) -> torch.Tensor:
    """(out_size, in_size) float32 weights of ``jax.image.resize``'s
    "linear" method along one axis: a triangle kernel at the half-pixel
    sample positions, widened by the downscale factor when downsampling
    (antialiasing), each row normalised to sum 1."""
    scale = out_size / in_size
    kernel_scale = max(1.0 / scale, 1.0)
    sample = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) / scale - 0.5
    x = (sample[:, None] - torch.arange(in_size, dtype=torch.float32, device=device)).abs()
    weights = (1.0 - x / kernel_scale).clamp_min(0.0)
    total = weights.sum(1, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return weights * inside[:, None]


def letterbox_image(img: torch.Tensor, new_shape: int,
                    pad_value: float = PAD_VALUE) -> torch.Tensor:
    """(H, W, C) or (B, H, W, C) -> square ``new_shape`` letterboxed, the
    border filled with ``pad_value`` (114 on the 0..255 scale; the learned
    representation pads with 0).

    The resize is ``jax.image.resize(..., "linear")``'s: when upsampling
    (the Gen1 path: 240x304 -> 505x640) that is bilinear with half-pixel
    centres, ``F.interpolate``; when downsampling (the 1 Mpx path:
    1280x720 -> 640x360) the triangle kernel widens by the factor, so each
    output averages the inputs under it, which ``F.interpolate`` does not:
    two products with :func:`resize_weights`."""
    batched = img.dim() == 4
    if not batched:
        img = img[None]
    _, h0, w0, _ = img.shape
    _, (nh, nw), (dw, dh) = letterbox_geometry(h0, w0, new_shape)
    x = img.permute(0, 3, 1, 2)  # NCHW view
    if nh >= h0 and nw >= w0:
        x = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False,
                          antialias=False)
    else:
        x = resize_weights(h0, nh, x.device).to(x.dtype) @ x
        x = x @ resize_weights(w0, nw, x.device).to(x.dtype).T
    top = int(round(dh - 0.1))
    bottom = new_shape - nh - top
    left = int(round(dw - 0.1))
    right = new_shape - nw - left
    x = F.pad(x, (left, right, top, bottom), value=pad_value)
    out = x.permute(0, 2, 3, 1)
    return out if batched else out[0]


def letterbox_labels(labels: np.ndarray, h0: int, w0: int, new_shape: int,
                     scaleup: bool = True) -> np.ndarray:
    """Host NumPy: (M, 5) [cls, cx, cy, w, h] normalised to (h0, w0) ->
    [cls, x1, y1, x2, y2] pixels in the letterboxed frame."""
    r, _, (dw, dh) = letterbox_geometry(h0, w0, new_shape, scaleup)
    out = labels.copy().astype(np.float32)
    cx, cy, w, h = out[:, 1] * w0, out[:, 2] * h0, out[:, 3] * w0, out[:, 4] * h0
    x1 = (cx - w / 2) * r + dw
    y1 = (cy - h / 2) * r + dh
    x2 = (cx + w / 2) * r + dw
    y2 = (cy + h / 2) * r + dh
    return np.stack([out[:, 0], x1, y1, x2, y2], axis=-1)


def scale_coords_back(
    coords: torch.Tensor,  # (N, 4) xyxy in the letterboxed frame
    letterboxed_shape: int,
    h0: int,
    w0: int,
) -> torch.Tensor:
    """Un-letterbox predictions back to the original frame."""
    gain = min(letterboxed_shape / h0, letterboxed_shape / w0)
    pad_w = (letterboxed_shape - w0 * gain) / 2
    pad_h = (letterboxed_shape - h0 * gain) / 2
    out = coords.clone()
    out[:, [0, 2]] = ((out[:, [0, 2]] - pad_w) / gain).clamp(0, w0)
    out[:, [1, 3]] = ((out[:, [1, 3]] - pad_h) / gain).clamp(0, h0)
    return out
