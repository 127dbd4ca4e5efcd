"""Demo inputs (the JAX package's ``data/demo_data.py``; the reference's
``LoadData``, ev-YOLOv6/yolov6/data/datasets.py:49-120): iterate images,
videos, or a directory of either, yielding RGB frames for the pixel path of
``cli/infer.py`` (yolov6/core/inferer.py:27). Event files go through the
CLI's event path; this module serves the pixel inputs only. cv2 is imported
when frames are read."""
from __future__ import annotations

import pathlib
from typing import Iterator, Tuple

import numpy as np

IMG_FORMATS = (".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff", ".webp")
VID_FORMATS = (".mp4", ".avi", ".mov", ".mkv", ".m4v", ".wmv", ".mpg",
               ".mpeg")
EVENT_FORMATS = (".h5", ".hdf5", ".npz", ".npy", ".dat", ".bin", ".bag")


def source_type(path) -> str:
    """'event' | 'image' | 'video' | 'dir' for a demo --source argument."""
    p = pathlib.Path(path)
    if p.is_dir():
        return "dir"
    s = p.suffix.lower()
    if s in EVENT_FORMATS:
        return "event"
    if s in IMG_FORMATS:
        return "image"
    if s in VID_FORMATS:
        return "video"
    raise ValueError(f"unsupported demo source: {path}")


class LoadData:
    """Iterate (frame_rgb uint8 HxWx3, path, frame_index) over images and
    videos (datasets.py LoadData semantics: a directory expands to its
    sorted image/video files)."""

    def __init__(self, source):
        p = pathlib.Path(source)
        if p.is_dir():
            self.files = sorted(
                f for f in p.iterdir()
                if f.suffix.lower() in IMG_FORMATS + VID_FORMATS
            )
            if not self.files:
                raise FileNotFoundError(f"no images/videos under {source}")
        else:
            self.files = [p]

    def __iter__(self) -> Iterator[Tuple[np.ndarray, str, int]]:
        import cv2

        for f in self.files:
            if f.suffix.lower() in IMG_FORMATS:
                im = cv2.imread(str(f))
                if im is None:
                    raise IOError(f"cannot read image {f}")
                yield im[..., ::-1].copy(), str(f), 0  # BGR -> RGB
            else:
                cap = cv2.VideoCapture(str(f))
                idx = 0
                try:
                    while True:
                        ok, im = cap.read()
                        if not ok:
                            break
                        yield im[..., ::-1].copy(), str(f), idx
                        idx += 1
                finally:
                    cap.release()
