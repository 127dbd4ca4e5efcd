"""Standalone evaluation CLI (the JAX package's ``cli/eval.py``, the
equivalent of ev-YOLOv6/tools/eval.py): val / test / speed tasks over a
checkpoint, with optional per-class PR/F1/confusion reporting
(evaler.py:179-337) and the speed slots (evaler.py:491-501).

    python -m event_representation_study_tpu_torch.cli.eval \\
        --conf configs/gen1_optimized.py --data-path /data/gen1 \\
        --checkpoint runs/train/exp/best_ckpt --task val

Runs on ``--device cuda`` (the default; it raises without CUDA) or
``--device cpu``. ``--half`` runs the detector in bfloat16 (autocast over
float32 weights, ``models/yolo.py``); the representation, the letterbox
and what reaches NMS stay float32. A config with the learned
representation evaluates a detector that takes the raw events.
"""
from __future__ import annotations

import argparse


def get_args_parser():
    p = argparse.ArgumentParser("event-detector evaluation (PyTorch port)")
    p.add_argument("--conf", type=str, default="configs/gen1_optimized.py")
    p.add_argument("--data-path", type=str, required=True)
    p.add_argument("--checkpoint", type=str, default=None,
                   help="train or deploy (strip_optimizer) checkpoint; "
                        "seeded random init if omitted (smoke)")
    p.add_argument("--task", choices=["val", "test", "speed"], default="val")
    p.add_argument("--representation", type=str, default=None)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--img-size", type=int, default=None,
                   help="default: the config's data.img_size")
    p.add_argument("--num-events", type=int, default=None)
    p.add_argument("--conf-thres", type=float, default=0.03)
    p.add_argument("--iou-thres", type=float, default=0.65)
    p.add_argument("--do-pr-metric", action="store_true",
                   help="per-class PR/F1 + confusion matrix")
    p.add_argument("--save-predictions", type=str, default=None,
                   help="write COCO-format predictions JSON (evaler.py:545-568)")
    p.add_argument("--half", action="store_true",
                   help="bf16 model compute over float32 weights")
    p.add_argument("--override", nargs="*", default=[])
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without CUDA) or cpu")
    return p


def main(args=None):
    args = get_args_parser().parse_args(args)
    import torch

    from .. import resolve_device
    from ..data.gen1 import Gen1H5
    from ..data.loader import EventBatchLoader
    from ..models import build_model
    from ..reps.dispatch import REPRESENTATION_CHANNELS
    from ..train.checkpoint import load_checkpoint, load_model_variables, model_variables
    from ..train.evaler import Evaler
    from ..utils.config import load_config

    device = resolve_device(args.device)
    cfg = load_config(args.conf, overrides=args.override)
    if args.representation:
        cfg.setdefault("data", {})["representation"] = args.representation
    data = cfg.get("data", {})
    rep = data.get("representation", "OptimizedRepresentation")
    nc = data.get("num_classes", 2)
    ne = args.num_events or data.get("num_events", 50000)
    img_size = args.img_size or data.get("img_size", 640)
    ds = Gen1H5(args.data_path, task="test" if args.task == "test" else "val", num_events=ne)
    loader = EventBatchLoader(ds, args.batch_size, img_size=img_size, shuffle=False,
                              drop_last=False)
    model = build_model(cfg, num_classes=nc, num_channels=REPRESENTATION_CHANNELS.get(rep, 12),
                        device=device, generator=torch.Generator(device=device).manual_seed(0),
                        dtype=torch.bfloat16 if args.half else torch.float32,
                        representation=rep, img_size=img_size)
    if args.checkpoint:
        load_model_variables(model, model_variables(load_checkpoint(args.checkpoint, device)))

    evaler = Evaler(model, loader, nc, rep, img_size=img_size,
                    conf_thres=args.conf_thres, iou_thres=args.iou_thres, device=device)
    stats = evaler.run(None, do_pr_metric=args.do_pr_metric, speed_only=args.task == "speed",
                       predictions_json=args.save_predictions)
    for k, v in stats.items():
        if k != "confusion_matrix":
            print(f"{k}: {v}")
    return stats


if __name__ == "__main__":
    main()
