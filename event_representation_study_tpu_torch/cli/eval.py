"""Standalone evaluation CLI (the JAX package's ``cli/eval.py``, the
equivalent of ev-YOLOv6/tools/eval.py): val / test / speed tasks over a
checkpoint, with optional per-class PR/F1/confusion reporting
(evaler.py:179-337) and the speed slots (evaler.py:491-501).

    python -m event_representation_study_tpu_torch.cli.eval \\
        --conf configs/gen1_optimized.py --data-path /data/gen1 \\
        --checkpoint runs/train/exp/best_ckpt --task val

Runs on ``--device cuda`` (the default; it raises without CUDA) or
``--device cpu``.
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
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("--num-events", type=int, default=None)
    p.add_argument("--conf-thres", type=float, default=0.03)
    p.add_argument("--iou-thres", type=float, default=0.65)
    p.add_argument("--do-pr-metric", action="store_true",
                   help="per-class PR/F1 + confusion matrix")
    p.add_argument("--save-predictions", type=str, default=None,
                   help="write COCO-format predictions JSON (evaler.py:545-568)")
    p.add_argument("--half", action="store_true",
                   help="bf16 model compute (not ported: ROADMAP M20)")
    p.add_argument("--override", nargs="*", default=[])
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without CUDA) or cpu")
    return p


def main(args=None):
    args = get_args_parser().parse_args(args)
    if args.half:
        raise NotImplementedError("--half (bf16 compute) is not ported (ROADMAP M20)")
    import torch

    from .. import resolve_device
    from ..data.gen1 import Gen1H5
    from ..data.loader import EventBatchLoader
    from ..models import build_model
    from ..reps.ergo12 import N_CHANNELS
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
    ds = Gen1H5(args.data_path, task="test" if args.task == "test" else "val", num_events=ne)
    loader = EventBatchLoader(ds, args.batch_size, img_size=args.img_size, shuffle=False,
                              drop_last=False)
    model = build_model(cfg, num_classes=nc, num_channels=N_CHANNELS, device=device,
                        generator=torch.Generator(device=device).manual_seed(0))
    if args.checkpoint:
        load_model_variables(model, model_variables(load_checkpoint(args.checkpoint, device)))

    evaler = Evaler(model, loader, nc, rep, img_size=args.img_size,
                    conf_thres=args.conf_thres, iou_thres=args.iou_thres, device=device)
    stats = evaler.run(None, do_pr_metric=args.do_pr_metric, speed_only=args.task == "speed",
                       predictions_json=args.save_predictions)
    for k, v in stats.items():
        if k != "confusion_matrix":
            print(f"{k}: {v}")
    return stats


if __name__ == "__main__":
    main()
