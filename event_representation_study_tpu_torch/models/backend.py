"""DetectBackend, the deploy-side inference wrapper (the JAX package's
``models/backend.py``; ev-YOLOv6/yolov6/layers/common.py:840-858): load a
checkpoint (a train checkpoint's EMA weights, or a stripped deploy
checkpoint's), build the detector of its experiment config, and offer
``__call__`` on preprocessed images and ``detect``, which adds NMS.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..ops import nms
from ..train.checkpoint import load_checkpoint, load_model_variables, model_variables
from ..utils.config import load_config
from .yolo import build_model


class DetectBackend:
    def __init__(self, checkpoint, cfg_path: str = "configs/gen1_optimized.py",
                 num_classes: int = 2, overrides: Sequence[str] = (),
                 dtype: torch.dtype = torch.float32, device="cuda"):
        """The detector of ``cfg_path`` (with ``overrides``) computing in
        ``dtype``, on ``device`` (``cuda`` unless the caller asks for
        ``cpu``), with the weights of ``checkpoint``."""
        self.device = resolve_device(device)
        cfg = load_config(cfg_path, overrides=list(overrides))
        self.model = build_model(cfg, num_classes=num_classes, device=self.device, dtype=dtype)
        load_model_variables(self.model, model_variables(load_checkpoint(checkpoint,
                                                                         self.device)))
        self.model.eval()

    @torch.inference_mode()
    def __call__(self, images) -> torch.Tensor:
        """(B, S, S, C) images in [0, 1] (an array or tensor) -> the decoded
        (B, A, 4 + 1 + nc) predictions; the detector gets a contiguous NCHW
        tensor."""
        x = torch.as_tensor(np.asarray(images) if not torch.is_tensor(images) else images,
                            dtype=torch.float32).to(self.device)
        return self.model(x.permute(0, 3, 1, 2).contiguous())

    @torch.inference_mode()
    def detect(self, images, conf_thres: float = 0.03, iou_thres: float = 0.65,
               max_det: int = nms.MAX_DET) -> Tuple[np.ndarray, np.ndarray]:
        """Decoded predictions through NMS: (B, max_det, 6) [x1 y1 x2 y2 conf
        cls] and the counts (B,), as host arrays. The greedy picks come in
        order, so a ``max_det`` below NMS's 300 keeps the first ones."""
        if not 0 < max_det <= nms.MAX_DET:
            raise ValueError(f"max_det must be in 1..{nms.MAX_DET}, got {max_det}")
        dets, counts = nms.non_max_suppression(self(images), conf_thres=conf_thres,
                                               iou_thres=iou_thres)
        return (dets[:, :max_det].cpu().numpy(),
                counts.clamp(max=max_det).cpu().numpy())
