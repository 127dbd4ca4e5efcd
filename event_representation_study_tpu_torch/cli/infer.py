"""Detection serving (the JAX package's ``cli/infer.py``; the reference's
yolov6/core/inferer.py): events -> representation (ERGO-12 by default) ->
letterbox -> /255 -> Detector (eval) -> NMS, or image / video frames (the
reference's LoadData path, yolov6/data/datasets.py:49) -> letterbox -> /255
-> Detector -> NMS.

    python -m event_representation_study_tpu_torch.cli.infer \\
        --source f.npz --conf configs/gen1_optimized.py [--save-img out.png]
    python -m event_representation_study_tpu_torch.cli.infer \\
        --source frames/ --checkpoint rgb_ckpt --save-dir annotated --max-frames 10

:func:`make_server` builds the model once and returns a callable that serves
batches of event windows, or with no representation, of RGB frames.
"""
from __future__ import annotations

import argparse
import pathlib
from typing import Dict, Optional

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
    :class:`EventBlock`s of ``height x width`` windows, or for a pixel
    server (``rep_fn`` a float32 cast) a (B, h, w, C) tensor of 0..255 frames.
    ``model`` is the :class:`..models.Detector` it runs, in eval mode."""

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


def _frames(x: torch.Tensor) -> torch.Tensor:
    """A pixel server's representation: the frames themselves, as float32."""
    return x.to(torch.float32)


def make_server(cfg: Dict, representation: Optional[str], H: int, W: int, img_size: int,
                conf_thres: float = 0.03, device="cuda",
                num_channels: Optional[int] = None) -> Server:
    """Build the detector of ``cfg`` on ``device`` (``cuda`` unless the caller
    asks for ``cpu``; raises when CUDA is absent), initialised from a
    generator seeded with 0, and return its :class:`Server`; ``main`` loads
    a checkpoint's weights into ``server.model``. ``representation`` None
    serves frames of ``num_channels`` (3 by default; ``H`` and ``W`` unused)."""
    device = resolve_device(device)
    nc = cfg.get("data", {}).get("num_classes", 2)
    if representation is None:
        rep_fn, channels = _frames, num_channels or 3
    else:
        rep_fn = batched_representation(representation, H, W)
        channels = num_channels or REPRESENTATION_CHANNELS.get(representation, 12)
    generator = torch.Generator(device=device).manual_seed(0)
    model = build_model(cfg, num_classes=nc, num_channels=channels,
                        device=device, generator=generator).eval()
    return Server(model, rep_fn, img_size, conf_thres, device)


def main(args=None):
    """Serve one event file (returns its detections, (n, 6) in sensor
    pixels), or the frames of an image, a video or a directory (returns
    (path, frame index, detections) a frame)."""
    from ..data.demo_data import source_type
    from ..events.core import from_structured, stack_blocks
    from ..events.h5_io import load_events_from_path
    from ..ops.image import scale_coords_back
    from ..train.checkpoint import load_checkpoint, load_model_variables, model_variables
    from ..utils.config import load_config

    p = argparse.ArgumentParser("event detector inference (PyTorch port)")
    p.add_argument("--events", type=str, default=None,
                   help=".h5/.npz/.npy/.dat/.bin/.bag event file (alias of --source)")
    p.add_argument("--source", type=str, default=None,
                   help="event file, image, video, or directory of images/videos "
                        "(inferer.py LoadData semantics)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="train checkpoint (its EMA weights) or stripped checkpoint; "
                        "seeded random weights if omitted")
    p.add_argument("--conf", type=str, default="configs/gen1_optimized.py")
    p.add_argument("--representation", type=str, default="OptimizedRepresentation")
    p.add_argument("--img-size", type=int, default=None,
                   help="default: the config's data.img_size")
    p.add_argument("--num-events", type=int, default=50000)
    p.add_argument("--conf-thres", type=float, default=0.03)
    p.add_argument("--save-img", type=str, default=None,
                   help="event mode: write the events' binary histogram with the boxes here")
    p.add_argument("--save-dir", type=str, default=None,
                   help="image/video mode: write annotated frames here")
    p.add_argument("--max-frames", type=int, default=0,
                   help="image/video mode: stop after N frames (0 = all)")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--override", nargs="*", default=[])
    args = p.parse_args(args)

    source = args.source or args.events
    if source is None:
        p.error("--source (or --events) is required")
    cfg = load_config(args.conf, overrides=args.override)
    img_size = args.img_size or cfg.get("data", {}).get("img_size", 640)
    if source_type(source) in ("image", "video", "dir"):
        return _infer_pixels(args, source, cfg, img_size)

    ev = load_events_from_path(source)
    H = int(ev["y"].max()) + 1
    W = int(ev["x"].max()) + 1
    ev = ev[-args.num_events:]
    blocks = stack_blocks([from_structured(ev, args.num_events)])
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
    dets = dets.numpy()
    if args.save_img:
        from ..utils.viz import draw_boxes, make_binary_histo

        img = draw_boxes(make_binary_histo(ev, H, W), dets[:, :4])
        try:
            from PIL import Image

            Image.fromarray(img).save(args.save_img)
            print(f"saved {args.save_img}")
        except ImportError:
            np.save(pathlib.Path(args.save_img).with_suffix(".npy"), img)
    return dets


def _stem_in_channels(variables: Dict[str, torch.Tensor]) -> Optional[int]:
    """The input channels of the first 4-d weight under ``backbone.stem``
    (for the error message only; None for a backbone without that stem)."""
    for name, t in variables.items():
        if name.startswith("backbone.stem.") and t.dim() == 4:
            return int(t.shape[1])
    return None


def _infer_pixels(args, source, cfg, img_size: int):
    """Image / video / directory serving (inferer.py:27 + datasets.py
    LoadData): each RGB frame letterboxed, /255, through the detector and
    NMS (the :class:`Server` of ``make_server(cfg, None, ...)``, built at the
    first frame with its channel count), the detections un-letterboxed to
    the frame; with ``--save-dir`` each frame annotated and written as PNG."""
    from ..data.demo_data import LoadData
    from ..ops.image import scale_coords_back
    from ..train.checkpoint import load_checkpoint, load_model_variables, model_variables
    from ..utils.viz import draw_boxes

    variables = None
    if args.checkpoint:
        variables = model_variables(load_checkpoint(args.checkpoint, resolve_device(args.device)))
        # a checkpoint trained on an event representation has an N-channel
        # stem (12 for OptimizedRepresentation, 2 for EventHistogram, ...):
        # fail before the first frame rather than in a convolution
        c_in = _stem_in_channels(variables)
        if c_in not in (None, 3):
            raise SystemExit(
                f"checkpoint {args.checkpoint!r} was trained on "
                f"{c_in or 'N'}-channel event representations and cannot "
                "run on 3-channel image/video frames. Use an RGB-trained "
                "checkpoint for the pixel demo, or point --source at an "
                "event file (.h5/.npz/.dat/.bin/.bag).")

    save_dir = pathlib.Path(args.save_dir) if args.save_dir else None
    if save_dir:
        save_dir.mkdir(parents=True, exist_ok=True)
    serve, results = None, []
    for n_frame, (frame, path, fidx) in enumerate(LoadData(source)):
        if args.max_frames and n_frame >= args.max_frames:
            break
        if serve is None:  # the channels come from the first frame
            serve = make_server(cfg, None, 0, 0, img_size, args.conf_thres,
                                device=args.device, num_channels=frame.shape[-1])
            if variables is not None:
                load_model_variables(serve.model, variables)
        dets, n = serve(torch.from_numpy(frame)[None])
        d = dets[0, : int(n[0])].cpu().clone()
        if len(d):
            d[:, :4] = scale_coords_back(d[:, :4], img_size, frame.shape[0], frame.shape[1])
        d = d.numpy()
        name = pathlib.Path(path).stem
        print(f"{name}[{fidx}]: {len(d)} detections")
        for det in d:
            print(f"  cls={int(det[5])} conf={det[4]:.3f} "
                  f"box=({det[0]:.0f},{det[1]:.0f},{det[2]:.0f},{det[3]:.0f})")
        if save_dir is not None:
            import cv2

            img = draw_boxes(frame.copy(), d[:, :4])
            cv2.imwrite(str(save_dir / f"{name}_{fidx:05d}.png"), np.asarray(img)[..., ::-1])
        results.append((path, fidx, d))
    return results


if __name__ == "__main__":
    main()
