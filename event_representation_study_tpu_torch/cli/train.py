"""Detection training CLI (the JAX package's ``cli/train.py``, the
equivalent of ev-YOLOv6/tools/train.py):

    python -m event_representation_study_tpu_torch.cli.train \\
        --conf configs/gen1_optimized.py --data-path /data/gen1 \\
        --batch-size 8 --epochs 100 --augment

``--testing`` skips training and evaluates on the test split (the
reference's train.py --testing path). Runs on ``--device cuda`` (the
default; it raises without CUDA) or ``--device cpu``. The training
variants of tools/train.py:140-161: ``--fuse-ab``, ``--distill`` (with
``--distill-feat``, ``--temperature``, ``--teacher-ckpt``), and
``--quant --calib`` (PTQ calibration instead of training; ``--calib``
alone refuses). ``--steps-per-dispatch K`` trains K steps a call, with the
EMA blended every step or, with ``--ema-cadence dispatch``, once a call.
``--override use_tensorboard=True`` / ``use_wandb=True`` add the
TensorBoard and wandb writers. ``--plot-images`` reaches the Trainer, which
raises naming its ROADMAP item (the plots are not ported).
"""
from __future__ import annotations

import argparse
import pathlib
import time


def get_args_parser():
    p = argparse.ArgumentParser("event-detector training (PyTorch port)")
    p.add_argument("--conf", type=str, default="configs/gen1_optimized.py",
                   help="experiment config file")
    p.add_argument("--data-path", type=str, required=True)
    p.add_argument("--representation", type=str, default=None,
                   help="override the config's representation name")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--img-size", type=int, default=None,
                   help="default: the config's data.img_size")
    p.add_argument("--num-events", type=int, default=None)
    p.add_argument("--output-dir", type=str, default="runs/train/exp")
    p.add_argument("--eval-interval", type=int, default=10)
    p.add_argument("--testing", action="store_true",
                   help="evaluation only (train.py --testing)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="checkpoint to evaluate / resume from")
    p.add_argument("--resume", nargs="?", const="auto", default=None,
                   help="resume training; with no value, the newest "
                        "runs/train/*/last_ckpt (train.py:117-215)")
    p.add_argument("--augment", action="store_true",
                   help="enable the strong-augment recipe (mosaic/affine/"
                        "flips/mixup) from the config's data_aug hyp")
    p.add_argument("--aug-mode", choices=("auto", "image", "event"), default="auto",
                   help="strong-aug executor: 'image' warps the rasterized "
                        "representation (ops/warp.py); 'event' composes "
                        "mosaic/affine/mixup on event coordinates "
                        "(reps/event_mosaic.py, point rasterization); 'auto' "
                        "(default) picks event when the representation supports it")
    p.add_argument("--stop-aug-last-n-epoch", type=int, default=15,
                   help="zero mosaic/mixup for the last N epochs (engine.py:475-480)")
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="train K steps per call on K stacked batches; the "
                        "remainder of an epoch goes through the per-batch step")
    p.add_argument("--ema-cadence", choices=("step", "dispatch"), default="step",
                   help="with --steps-per-dispatch > 1: blend the EMA every "
                        "step, or once per call with the product of the K "
                        "decays (the counter advances by K)")
    p.add_argument("--partner-pool", type=int, default=0,
                   help="with --augment: extra dataset-wide samples per batch "
                        "as mosaic/mixup partners; 0 = in-batch partners")
    p.add_argument("--plot-images", action="store_true",
                   help="train-batch/val-pred mosaics (not ported: ROADMAP M19)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--override", nargs="*", default=[],
                   help="dotted-key config overrides, e.g. model.depth_multiple=0.5")
    p.add_argument("--fuse-ab", action="store_true",
                   help="add the anchor-base auxiliary training branch "
                        "(fuse_ab head; engine.py:242-256)")
    p.add_argument("--distill", action="store_true",
                   help="knowledge distillation against a frozen teacher "
                        "(engine.py:226-241); excludes --fuse-ab")
    p.add_argument("--distill-feat", action="store_true",
                   help="also distill feature maps (channel-wise KD)")
    p.add_argument("--temperature", type=float, default=20.0,
                   help="distillation temperature (train.py:150)")
    p.add_argument("--teacher-ckpt", type=str, default=None,
                   help="teacher checkpoint (a train checkpoint or a stripped "
                        "deploy checkpoint); without it a fresh init")
    p.add_argument("--quant", action="store_true",
                   help="PTQ mode (with --calib: calibrate and exit, train.py:144-145)")
    p.add_argument("--calib", action="store_true",
                   help="in-trainer PTQ calibration, then exit (engine.py:916-942); "
                        "requires --quant")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without CUDA) or cpu")
    return p


def find_latest_checkpoint(root="runs/train") -> str:
    """The newest ``<root>/*/last_ckpt`` (train.py:117-135)."""
    cands = sorted(pathlib.Path(root).glob("*/last_ckpt"), key=lambda p: p.stat().st_mtime)
    if not cands:
        raise FileNotFoundError(f"--resume: no {root}/*/last_ckpt to resume from")
    return str(cands[-1])


def main(args=None):
    """Train, or calibrate with ``--quant --calib`` (returns the
    :class:`..train.engine.Trainer` after it), or, with ``--testing``,
    evaluate (returns the stats)."""
    t_main = time.time()
    parser = get_args_parser()
    args = parser.parse_args(args)
    if args.calib and not args.quant:
        parser.error("--calib requires --quant")
    from ..train.checkpoint import restore_train_state
    from ..train.engine import Trainer
    from ..utils.config import load_config

    cfg = load_config(args.conf, overrides=args.override)
    if args.representation:
        cfg.setdefault("data", {})["representation"] = args.representation

    trainer = Trainer(
        cfg,
        args.data_path,
        batch_size=args.batch_size,
        epochs=args.epochs,
        img_size=args.img_size,
        output_dir=args.output_dir,
        eval_interval=args.eval_interval,
        num_events=args.num_events,
        seed=args.seed,
        augment=args.augment,
        aug_mode=args.aug_mode,
        stop_aug_last_n_epoch=args.stop_aug_last_n_epoch,
        plot_images=args.plot_images,
        partner_pool=args.partner_pool,
        steps_per_dispatch=args.steps_per_dispatch,
        ema_cadence=args.ema_cadence,
        fuse_ab=args.fuse_ab,
        distill=args.distill,
        distill_feat=args.distill_feat,
        temperature=args.temperature,
        teacher_ckpt=args.teacher_ckpt,
        quant_calib=bool(args.quant and args.calib),
        # the reference's --testing evaluates the TEST split
        # (engine.py:603-623 task="test")
        eval_task="test" if args.testing else "val",
        device=args.device,
    )
    t0 = time.time()
    print(f"trainer ready in {t0 - t_main:.1f}s", flush=True)
    ckpt = args.checkpoint
    if args.resume is not None and ckpt is None:
        ckpt = find_latest_checkpoint() if args.resume == "auto" else args.resume
        print(f"resuming from {ckpt}")
    if ckpt:
        trainer.state, trainer.start_epoch = restore_train_state(ckpt, trainer.state)
        print(f"checkpoint restored in {time.time() - t0:.1f}s", flush=True)

    if args.testing:
        # the live weights of a fresh model, the EMA of a checkpoint
        stats = trainer.evaler.run(None if args.checkpoint is None
                                   else trainer.state.ema.variables)
        print(stats)
        return stats
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
