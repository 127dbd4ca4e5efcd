"""Detection serving: events -> representation (ERGO-12 by default) ->
letterbox -> /255 -> Detector (eval) -> NMS (the event-file path of the JAX
package's ``cli/infer.py``).

    python -m event_representation_study_tpu_torch.cli.infer \\
        --events f.npz --conf configs/gen1_optimized.py

:func:`make_server` builds the model once and returns a callable that serves
batches of event windows.
"""
from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

from .. import resolve_device
from ..events.core import EventBlock
from ..models import build_model
from ..ops.image import letterbox_image
from ..ops.nms import non_max_suppression
from ..reps.dispatch import REPRESENTATION_CHANNELS, batched_representation


class Server:
    """``serve(blocks) -> (dets (B, max_det, 6), n (B,))`` for batched
    :class:`EventBlock`s of ``height x width`` windows. ``model`` is the
    :class:`..models.Detector` it runs, in eval mode."""

    def __init__(self, model, rep_fn, img_size: int, conf_thres: float, device):
        self.model = model
        self.rep_fn = rep_fn
        self.img_size = img_size
        self.conf_thres = conf_thres
        self.device = device

    def pipeline(self, blocks: EventBlock):
        """(rep (B, H, W, C), preds (B, A, 5+nc), dets, n) of ``blocks`` on
        the model's device: the serving function, which
        ``utils/export.py`` also traces."""
        rep = self.rep_fn(blocks)
        imgs = letterbox_image(rep, self.img_size) / 255.0  # NHWC
        preds = self.model(imgs.permute(0, 3, 1, 2))
        dets, n = non_max_suppression(preds, conf_thres=self.conf_thres)
        return rep, preds, dets, n

    @torch.inference_mode()
    def run(self, blocks: EventBlock):
        """:meth:`pipeline` of ``blocks`` moved to the device."""
        return self.pipeline(blocks.to(self.device))

    def __call__(self, blocks: EventBlock):
        return self.run(blocks)[2:]


def make_server(cfg: Dict, representation: str, H: int, W: int, img_size: int,
                conf_thres: float = 0.03, device="cuda") -> Server:
    """Build the detector of ``cfg`` on ``device`` (``cuda`` unless the caller
    asks for ``cpu``; raises when CUDA is absent), initialised from a
    generator seeded with 0, and return its :class:`Server`; ``main`` loads
    a checkpoint's weights into ``server.model``."""
    device = resolve_device(device)
    nc = cfg.get("data", {}).get("num_classes", 2)
    rep_fn = batched_representation(representation, H, W)
    generator = torch.Generator(device=device).manual_seed(0)
    model = build_model(cfg, num_classes=nc,
                        num_channels=REPRESENTATION_CHANNELS.get(representation, 12),
                        device=device, generator=generator).eval()
    return Server(model, rep_fn, img_size, conf_thres, device)


def main(args=None):
    from ..events.core import from_structured, stack_blocks
    from ..events.h5_io import load_events_from_path
    from ..ops.image import scale_coords_back
    from ..train.checkpoint import load_checkpoint, load_model_variables, model_variables
    from ..utils.config import load_config

    p = argparse.ArgumentParser("event detector inference (PyTorch port)")
    p.add_argument("--events", type=str, required=True, help=".h5/.npz/.npy event file")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="train checkpoint (its EMA weights) or stripped checkpoint; "
                        "seeded random weights if omitted")
    p.add_argument("--conf", type=str, default="configs/gen1_optimized.py")
    p.add_argument("--representation", type=str, default="OptimizedRepresentation")
    p.add_argument("--img-size", type=int, default=None,
                   help="default: the config's data.img_size")
    p.add_argument("--num-events", type=int, default=50000)
    p.add_argument("--conf-thres", type=float, default=0.03)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--override", nargs="*", default=[])
    args = p.parse_args(args)

    ev = load_events_from_path(args.events)
    H = int(ev["y"].max()) + 1
    W = int(ev["x"].max()) + 1
    ev = ev[-args.num_events:]
    blocks = stack_blocks([from_structured(ev, args.num_events)])
    cfg = load_config(args.conf, overrides=args.override)
    img_size = args.img_size or cfg.get("data", {}).get("img_size", 640)
    serve = make_server(cfg, args.representation, H, W, img_size,
                        args.conf_thres, device=args.device)
    if args.checkpoint:  # a train checkpoint's EMA weights, or a stripped one's
        load_model_variables(serve.model, model_variables(
            load_checkpoint(args.checkpoint, serve.device)))
    dets, n = serve(blocks)
    dets = dets[0, : int(n[0])].cpu().clone()  # a normal tensor, writable here
    if len(dets):
        dets[:, :4] = scale_coords_back(dets[:, :4], img_size, H, W)
    print(f"{len(dets)} detections")
    for d in dets.tolist():
        print(f"  cls={int(d[5])} conf={d[4]:.3f} box=({d[0]:.0f},{d[1]:.0f},{d[2]:.0f},{d[3]:.0f})")
    return np.asarray(dets)


if __name__ == "__main__":
    main()
