"""Gen4/1 Mpx stage-1 consolidation CLI — the offline step of
ev-YOLOv6/yolov6/data/gen4/precompute_reps.py:253-310 (toh5pyfiles) driven
from the dataset's release formats.

Two input modes, auto-detected from the directory contents:
- Prophesee raw release: ``*_td.dat`` EVT2.0 event files paired with
  ``*_bbox.npy`` GT files (same stem).
- Preconverted npz: one ``*.npz`` per recording holding x/y/t/p + boxes.

A copy of the JAX package's ``cli/consolidate.py``; the split file is
written through h5py, or without it through ``events/h5lite.py``, in
Blosc-ZSTD chunks whenever this process has a Blosc codec.

Example::

    python -m event_representation_study_tpu_torch.cli.consolidate \
        /data/gen4/train_raw --output /data/gen4/training.h5
"""
from __future__ import annotations

import argparse
import pathlib


def main(args=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input_dir", help="directory of recordings")
    ap.add_argument("--output", required=True, help="consolidated .h5 path")
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--max-class-id", type=int, default=2,
                    help="keep class_id <= this (precompute_reps.py:305)")
    a = ap.parse_args(args)

    from ..data.gen4 import consolidate_npz, consolidate_recordings

    root = pathlib.Path(a.input_dir)
    dats = sorted(root.glob("*_td.dat"))
    if dats:
        boxes = []
        missing = 0
        for d in dats:
            b = d.with_name(d.name.replace("_td.dat", "_bbox.npy"))
            if not b.exists():
                missing += 1
                print(f"WARNING: no GT file {b.name} — consolidating "
                      f"{d.name} with EMPTY labels")
                b = None
            boxes.append(b)
        if missing:
            print(f"WARNING: {missing}/{len(dats)} recordings have no "
                  "*_bbox.npy GT — check the directory if labels were "
                  "expected")
        print(f"consolidating {len(dats)} .dat recordings -> {a.output}")
        consolidate_recordings(dats, boxes, a.output, height=a.height,
                               width=a.width, max_class_id=a.max_class_id)
        return
    npzs = sorted(root.glob("*.npz"))
    if not npzs:
        raise SystemExit(f"no *_td.dat or *.npz recordings under {root}")
    print(f"consolidating {len(npzs)} npz recordings -> {a.output}")
    consolidate_npz(npzs, a.output, height=a.height, width=a.width,
                    max_class_id=a.max_class_id)


if __name__ == "__main__":
    main()
