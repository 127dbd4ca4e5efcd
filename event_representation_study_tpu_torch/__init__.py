"""PyTorch/CUDA port of the event-representation study framework.

The JAX package ``event_representation_study_tpu`` is the reference; this
package carries the same module layout and public layouts (representations
``(B, H, W, C)``, images NHWC at the serve boundary, detections
``(B, max_det, 6)`` plus counts ``(B,)``) so each module can be held against
its counterpart. It imports torch and numpy only, never JAX.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; they
raise when CUDA is requested and absent (:func:`resolve_device`).
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. ``cuda`` must exist: there is no
    silent fall-back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return device
