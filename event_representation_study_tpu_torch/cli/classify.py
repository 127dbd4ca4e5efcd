"""Mini N-ImageNet classification CLI (the JAX package's ``cli/classify.py``,
the equivalent of n_imagenet/real_cnn_model/main.py with its .ini +
``--override`` config surface, main.py:49-80):

    python -m event_representation_study_tpu_torch.cli.classify \\
        --config study.ini --train-list train_list.txt --val-list val_list.txt \\
        --override epochs=2 batch_size=64 [--device cpu]

A list file holds one ``.npz`` path a line; a sample's class is its parent
directory's name. The .ini keys read (any section): train_file, val_file,
loader_type, num_classes, slice_length, reshape_method, augment, model,
kernel_size, optimizer, learning_rate, weight_decay, seed, batch_size,
channel_size, epochs. Runs on ``--device cuda`` (the default; it raises
without CUDA) or ``--device cpu``. The config's ``seed`` (default 1) seeds
the generator that draws the model's weights.
"""
from __future__ import annotations

import argparse
import configparser
import pathlib


def parse_ini(path: str) -> dict:
    """Flatten an n_imagenet-style .ini into one dict (base parse_utils)."""
    cp = configparser.ConfigParser()
    cp.read(path)
    out = {}
    for section in cp.sections():
        for k, v in cp.items(section):
            out[k] = v
    return out


def read_list(path):
    """(files, labels) of a list file; labels number the parent directories
    in order of first appearance."""
    files, labels = [], []
    classes = {}
    for line in pathlib.Path(path).read_text().splitlines():
        f = line.strip()
        if not f:
            continue
        cls = pathlib.Path(f).parent.name
        classes.setdefault(cls, len(classes))
        files.append(f)
        labels.append(classes[cls])
    return files, labels


def main(args=None):
    p = argparse.ArgumentParser("Mini N-ImageNet classification (PyTorch port)")
    p.add_argument("--config", type=str, default=None, help=".ini config")
    p.add_argument("--train-list", type=str, default=None)
    p.add_argument("--val-list", type=str, default=None)
    p.add_argument("--override", nargs="*", default=[],
                   help="key=value overrides of ini entries")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without CUDA) or cpu")
    args = p.parse_args(args)

    from .. import resolve_device

    device = resolve_device(args.device)
    cfg = parse_ini(args.config) if args.config else {}
    for ov in args.override:
        k, _, v = ov.partition("=")
        cfg[k.strip()] = v.strip()

    from ..data.nimagenet import NImageNetDataset
    from ..models.resnet import EventResNet
    from ..train.classifier import ClassifierTrainer

    train_files, train_labels = read_list(args.train_list or cfg["train_file"])
    val_files, val_labels = read_list(args.val_list or cfg["val_file"])

    loader_type = cfg.get("loader_type", "reshape_then_optimized")
    num_classes = int(cfg.get("num_classes", 100))
    ds_train = NImageNetDataset(
        train_files, train_labels, loader_type=loader_type,
        slice_length=int(cfg.get("slice_length", 30000)),
        reshape_method=cfg.get("reshape_method", "no_sample"),
        augment=cfg.get("augment", "True") == "True",
    )
    ds_val = NImageNetDataset(
        val_files, val_labels, loader_type=loader_type,
        slice_length=int(cfg.get("slice_length", 30000)),
        reshape_method=cfg.get("reshape_method", "no_sample"),
    )
    model = EventResNet(
        num_classes=num_classes,
        arch=cfg.get("model", "ResNet34"),
        stem_kernel=int(cfg.get("kernel_size", 14)),
        in_channels=int(cfg.get("channel_size", ds_train.channels)),
    )
    trainer = ClassifierTrainer(
        model, ds_train.representation, num_classes,
        optimizer=cfg.get("optimizer", "Adam"),
        lr=float(cfg.get("learning_rate", 3e-4)),
        weight_decay=float(cfg.get("weight_decay", 1e-4)),
        seed=int(cfg.get("seed", 1)),
        device=device,
    )
    bs = int(cfg.get("batch_size", 64))
    trainer.init()
    epochs = int(cfg.get("epochs", 100))
    history = []
    for e in range(epochs):
        tr = trainer.run_epoch(ds_train, bs, train=True)
        va = trainer.run_epoch(ds_val, bs, train=False)
        print(f"epoch {e}: train {tr} val {va}", flush=True)
        history.append({"epoch": e, "train": tr, "val": va})
    return history


if __name__ == "__main__":
    main()
