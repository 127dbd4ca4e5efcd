"""RepOpt-VGG gradient masks (the JAX package's ``train/rep_optimizer.py``;
ev-YOLOv6/yolov6/utils/RepOptimizer.py:94-246, RepVGGOptimizer).

RepOpt trains a plain conv network whose SGD trajectory equals training
the multi-branch RepVGG: each 3x3 kernel's gradient is multiplied
elementwise by a mask made from the branch scales, and the kernel starts as
the scale-weighted branch sum.

Kernels are torch's OIHW (out, in, 3, 3): the per-output-channel scales
broadcast on axis 0 and the centre tap is ``[:, :, 1, 1]`` (the JAX
package's HWIO kernels hold them on the last axis and at ``[1, 1]``).
:func:`repopt_grad_mask` multiplies the named parameters' gradients by
their masks during the backward pass, so any optimizer step after it sees
the masked gradients:

    handles = repopt_grad_mask(model, {"backbone.stem.conv.weight": mask})
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn


def grad_mask(kernel_shape: Tuple[int, int, int, int], scale_conv: np.ndarray,
              scale_1x1: np.ndarray, scale_identity: Optional[np.ndarray] = None) -> np.ndarray:
    """The CSLA gradient mask of an OIHW (out, in, 3, 3) kernel: conv-scale^2
    everywhere, plus 1x1-scale^2 at the centre, plus 1 at the centre of the
    diagonal (the identity branch, in == out) when present."""
    cout, cin, kh, kw = kernel_shape
    assert (kh, kw) == (3, 3)
    mask = np.ones(kernel_shape, np.float32) * (scale_conv ** 2).reshape(-1, 1, 1, 1)
    mask[:, :, 1, 1] += np.ones((cout, cin), np.float32) * (scale_1x1 ** 2).reshape(-1, 1)
    if scale_identity is not None:
        assert cin == cout
        ids = np.arange(cin)
        mask[ids, ids, 1, 1] += 1.0
    return mask


def reinit_kernel(kernel: np.ndarray, kernel_1x1: np.ndarray, scale_conv: np.ndarray,
                  scale_1x1: np.ndarray, scale_identity: Optional[np.ndarray] = None
                  ) -> np.ndarray:
    """The branch-sum initialisation (RepOptimizer.py:144-175) of an OIHW
    3x3 ``kernel`` with its (out, in, 1, 1) ``kernel_1x1``."""
    out = kernel * scale_conv.reshape(-1, 1, 1, 1)
    pad = np.zeros_like(kernel)
    pad[:, :, 1:2, 1:2] = kernel_1x1 * scale_1x1.reshape(-1, 1, 1, 1)
    out = out + pad
    if scale_identity is not None:
        cin = kernel.shape[1]
        ident = np.zeros_like(kernel)
        ident[np.arange(cin), np.arange(cin), 1, 1] = scale_identity
        out = out + ident
    return out


def repopt_grad_mask(model: nn.Module, masks: Dict[str, torch.Tensor]
                     ) -> List[torch.utils.hooks.RemovableHandle]:
    """Multiply the gradient of each parameter of ``model`` named in
    ``masks`` (state-dict names) by its mask; returns the hook handles
    (``handle.remove()`` undoes it). Every name must be a parameter."""
    params = dict(model.named_parameters())
    missing = sorted(set(masks) - set(params))
    if missing:
        raise KeyError(f"no parameters named {missing[:5]}")
    handles = []
    for name, m in masks.items():
        p = params[name]
        m = torch.as_tensor(m, dtype=p.dtype, device=p.device)
        if m.shape != p.shape:
            raise ValueError(f"mask of {name} has shape {tuple(m.shape)}, not {tuple(p.shape)}")
        handles.append(p.register_hook(lambda g, m=m: g * m))
    return handles
