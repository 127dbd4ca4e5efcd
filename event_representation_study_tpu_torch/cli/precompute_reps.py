"""Offline representation baking CLI (the JAX package's
``cli/precompute_reps.py``) — the equivalent of
ev-YOLOv6/yolov6/data/gen4/precompute_reps.py stage (2): bake each sample's
representation to a per-sample HDF5 file + label .npy.

Training does not need this round trip (the representation builds on the
device in the train step); the CLI exports representations to other
consumers. Each batch of the split's windows builds in one
``batched_representation`` call on the device (K1, or K2 for a sum-only
representation, on ``cuda``), replacing the reference's 8-process CPU pool
(precompute_reps.py:439-466). Each sample goes to ``reps/{idx}.h5``
(dataset ``rep``, deflate) through h5py, or without it through
``events/h5lite.py``, and its labels ``[cls, x1, y1, x2, y2]`` (letterboxed
at 640) to ``labels/{idx}.npy``::

    python -m event_representation_study_tpu_torch.cli.precompute_reps \\
        --data-path DIR --output-dir OUT [--device cpu]
"""
from __future__ import annotations

import argparse
import pathlib

import numpy as np


def main(args=None):
    p = argparse.ArgumentParser("precompute representations (PyTorch port)")
    p.add_argument("--data-path", type=str, required=True)
    p.add_argument("--task", type=str, default="val", choices=["train", "val", "test"])
    p.add_argument("--representation", type=str, default="OptimizedRepresentation")
    p.add_argument("--output-dir", type=str, required=True)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--num-events", type=int, default=50000)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without CUDA) or cpu")
    args = p.parse_args(args)

    from .. import resolve_device
    from ..data.gen1 import Gen1H5
    from ..data.loader import EventBatchLoader
    from ..events.blosc_codec import h5py
    from ..reps.dispatch import batched_representation

    device = resolve_device(args.device)
    ds = Gen1H5(args.data_path, task=args.task, num_events=args.num_events)
    loader = EventBatchLoader(ds, args.batch_size, shuffle=False, drop_last=False)
    rep_fn = batched_representation(args.representation, ds.height, ds.width)

    out = pathlib.Path(args.output_dir)
    (out / "reps").mkdir(parents=True, exist_ok=True)
    (out / "labels").mkdir(parents=True, exist_ok=True)

    written = 0
    for batch, indices in loader:
        reps = rep_fn(batch.events.to(device)).cpu().numpy()
        labels = np.asarray(batch.gt_labels)
        boxes = np.asarray(batch.gt_bboxes)
        mask = np.asarray(batch.gt_mask) > 0
        for i, idx in enumerate(indices):
            with h5py.File(out / "reps" / f"{int(idx)}.h5", "w") as f:
                f.create_dataset("rep", data=reps[i].astype(np.float32), compression="gzip")
            lab = np.concatenate(
                [labels[i][mask[i]][:, None].astype(np.float32), boxes[i][mask[i]]], axis=1)
            np.save(out / "labels" / f"{int(idx)}.npy", lab)
            written += 1
            if args.limit and written >= args.limit:
                print(f"wrote {written} samples to {out}")
                return written
    print(f"wrote {written} samples to {out}")
    return written


if __name__ == "__main__":
    main()
