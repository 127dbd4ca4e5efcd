"""Evaluation engine (the JAX package's ``train/evaler.py``, the equivalent
of ev-YOLOv6/yolov6/core/evaler.py).

Per batch: the eval step (events -> ERGO-12 on kernel K1 -> letterbox ->
detector, or an image loader's letterboxed images -> detector) and NMS on
the device, then on the host the detections are un-letterboxed to sensor
coordinates (scale_coords semantics, evaler.py:512-543; the identity for an
image folder, whose frame is the letterbox) and fed to the COCO evaluator,
with the reference's 4-slot speed accounting (samples / pre-process /
inference+NMS / post, evaler.py:138-177). With ``plot_dir``, the first
batch's letterboxed representation with its boxes and detections goes to
``val_pred.png`` (engine.py:782-913; event data only, as in the JAX
Evaler).
"""
from __future__ import annotations

import json
import pathlib
import time
from typing import Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..metrics.coco import CocoEvaluator
from ..metrics.det_metrics import PRMetric
from ..ops.image import letterbox_image, scale_coords_back
from ..ops.nms import non_max_suppression
from ..parallel.train_step import LEARNED, make_eval_step
from ..reps.dispatch import batched_representation


class Evaler:
    def __init__(
        self,
        model,
        loader,
        num_classes: int,
        representation: str,
        img_size: int = 640,
        conf_thres: float = 0.03,
        iou_thres: float = 0.65,
        device="cuda",
    ):
        """``model`` on ``device`` (``cuda`` unless the caller asks for
        ``cpu``), ``loader`` an ``EventBatchLoader`` over the eval split, or
        an ``ImageBatchLoader`` with ``representation`` None."""
        device = resolve_device(device)
        self.loader = loader
        self.num_classes = num_classes
        self.img_size = img_size
        self.conf_thres = conf_thres
        self.iou_thres = iou_thres
        ds = loader.ds
        self._eval_step = make_eval_step(model, representation, rep_hw=(ds.height, ds.width),
                                         img_size=img_size, device=device)
        # letterboxed 0..255 representations for the plots (engine.py:719-913)
        self._images = None
        if representation and representation != LEARNED:
            rep_fn = batched_representation(representation, ds.height, ds.width)

            @torch.inference_mode()
            def images(events):
                return letterbox_image(rep_fn(events.to(device).as_int32()), img_size)

            self._images = images

    def run(self, variables: Optional[Dict[str, torch.Tensor]], do_pr_metric: bool = False,
            speed_only: bool = False, plot_dir=None, predictions_json=None) -> Dict[str, float]:
        """COCO evaluation of ``variables`` (a state dict such as the EMA's;
        None for the model's own weights), with the speed slots per image:
        ``speed_pre_ms`` (batch fetch and queueing the device work),
        ``speed_infer_nms_ms`` (waiting for the detections) and
        ``speed_post_ms`` (host metric work).

        ``do_pr_metric`` adds the per-class PR/F1/confusion summary
        (evaler.py:179-337); ``speed_only`` skips the metrics (the speed
        task, evaler.py:491-501); ``predictions_json`` writes COCO-format
        prediction records (evaler.py:545-568); ``plot_dir`` draws the first
        batch (``val_pred.png``; event data only; needs matplotlib).

        The loop is software-pipelined: batch ``k``'s device work is queued
        before batch ``k-1``'s detections are read back, so host work (the
        loader's H5 reads, COCO matching) overlaps device compute. The
        detections stay on the device until the drain, whose ``.cpu()`` is
        the only synchronisation."""
        ds = self.loader.ds
        coco = CocoEvaluator(self.num_classes)
        pr = PRMetric(self.num_classes) if do_pr_metric else None
        speed = {"n": 0, "pre_ms": 0.0, "infer_ms": 0.0, "post_ms": 0.0}
        coco_records = [] if predictions_json else None
        plotted = plot_dir is None

        def drain(pending):
            nonlocal plotted
            dets_d, counts_d, host_batch, indices = pending
            t0 = time.perf_counter()
            dets = dets_d.cpu()  # waits for the device
            counts = counts_d.cpu()
            t1 = time.perf_counter()
            nb = dets.shape[0]
            if not plotted and self._images is not None:
                from ..utils.viz import plot_val_predictions

                plot_val_predictions(
                    self._images(host_batch.events).cpu().numpy(), dets.numpy(),
                    counts.numpy(), np.asarray(host_batch.gt_bboxes),
                    np.asarray(host_batch.gt_mask),
                    path=str(pathlib.Path(plot_dir) / "val_pred.png"))
                plotted = True
            if not speed_only:
                labels = np.asarray(host_batch.gt_labels)
                boxes = np.asarray(host_batch.gt_bboxes)
                mask = np.asarray(host_batch.gt_mask) > 0
                for i in range(nb):
                    d = dets[i, : int(counts[i])].clone()
                    d[:, :4] = scale_coords_back(d[:, :4], self.img_size, ds.height, ds.width)
                    d = d.numpy()
                    m = mask[i]
                    g = scale_coords_back(torch.from_numpy(boxes[i][m]), self.img_size,
                                          ds.height, ds.width).numpy()
                    gts = np.concatenate([labels[i][m][:, None].astype(np.float64), g], axis=1)
                    coco.add_image(d, gts)
                    if pr is not None:
                        pr.add_image(d, gts)
                    if coco_records is not None:
                        img_id = int(indices[i])
                        for x1, y1, x2, y2, score, cls in d:
                            coco_records.append({
                                "image_id": img_id,
                                "category_id": int(cls),
                                "bbox": [round(float(x1), 3), round(float(y1), 3),
                                         round(float(x2 - x1), 3), round(float(y2 - y1), 3)],
                                "score": round(float(score), 5),
                            })
            t2 = time.perf_counter()
            speed["n"] += nb
            speed["infer_ms"] += (t1 - t0) * 1e3
            speed["post_ms"] += (t2 - t1) * 1e3

        pending = None
        t_pre = time.perf_counter()
        for batch, indices in self.loader:
            with torch.inference_mode():
                preds = self._eval_step(variables, batch)
                dets_d, counts_d = non_max_suppression(preds, conf_thres=self.conf_thres,
                                                       iou_thres=self.iou_thres)
            speed["pre_ms"] += (time.perf_counter() - t_pre) * 1e3
            if pending is not None:
                drain(pending)  # host work overlaps batch k's device compute
            pending = (dets_d, counts_d, batch, indices)
            t_pre = time.perf_counter()
        if pending is not None:
            drain(pending)
        stats = {} if speed_only else coco.summarize()
        if coco_records is not None:
            p = pathlib.Path(predictions_json)
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_text(json.dumps(coco_records))
        if pr is not None:
            stats.update(pr.summarize())
        if speed["n"]:
            stats["speed_pre_ms"] = speed["pre_ms"] / speed["n"]
            stats["speed_infer_nms_ms"] = speed["infer_ms"] / speed["n"]
            stats["speed_post_ms"] = speed["post_ms"] / speed["n"]
        return stats
