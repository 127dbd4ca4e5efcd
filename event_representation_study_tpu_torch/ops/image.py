"""Image geometry ops: device-side letterbox and the coordinate math of the
reference's cv2 pipeline (the JAX package's ``ops/image.py``).

``letterbox_image`` keeps the JAX layout, NHWC in and out; inside it works
on an NCHW view of the same memory.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

PAD_VALUE = 114.0


def letterbox_geometry(
    h0: int, w0: int, new_shape: int
) -> Tuple[float, Tuple[int, int], Tuple[float, float]]:
    """ratio, (new_h, new_w), (dw, dh) — letterbox(auto=False) semantics."""
    r = min(new_shape / h0, new_shape / w0)
    new_unpad = int(round(w0 * r)), int(round(h0 * r))  # (w, h)
    dw = (new_shape - new_unpad[0]) / 2
    dh = (new_shape - new_unpad[1]) / 2
    return r, (new_unpad[1], new_unpad[0]), (dw, dh)


def letterbox_image(img: torch.Tensor, new_shape: int) -> torch.Tensor:
    """(H, W, C) or (B, H, W, C) -> square ``new_shape`` letterboxed.

    Bilinear with half-pixel centres and no antialiasing, which equals
    ``jax.image.resize(..., "linear")`` when upsampling (the Gen1 path:
    240x304 -> 505x640)."""
    batched = img.dim() == 4
    if not batched:
        img = img[None]
    _, h0, w0, _ = img.shape
    _, (nh, nw), (dw, dh) = letterbox_geometry(h0, w0, new_shape)
    x = img.permute(0, 3, 1, 2)  # NCHW view
    x = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False,
                      antialias=False)
    top = int(round(dh - 0.1))
    bottom = new_shape - nh - top
    left = int(round(dw - 0.1))
    right = new_shape - nw - left
    x = F.pad(x, (left, right, top, bottom), value=PAD_VALUE)
    out = x.permute(0, 2, 3, 1)
    return out if batched else out[0]


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
