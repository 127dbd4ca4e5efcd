"""Experiment metrics writers (the JAX package's ``utils/observability.py``;
the reference's tensorboard ``SummaryWriter`` and wandb calls,
yolov6/utils/events.py:37-60, engine.py:264-265, evaler.py:480).

One protocol (``log(metrics, step)``, ``log_images(tag, images, step)``,
``close()``), three backends:
- :class:`JsonlWriter`, always there: one JSON object per logged step in
  ``metrics.jsonl``;
- :class:`TensorBoardWriter`: event files through the first-party writer
  of :mod:`.tb_native` (no package needed), or through torch's
  ``SummaryWriter`` (the ``tensorboard`` package) with ``native=False``;
- :class:`WandbWriter`, when ``wandb`` imports.
:meth:`MultiWriter.default` fans out to every backend it could build and
drops one whose package is missing, with a warning that names it.
"""
from __future__ import annotations

import json
import pathlib
import time
from typing import Dict, List, Optional

import numpy as np

from .logging import get_logger

LOGGER = get_logger("observability")


class JsonlWriter:
    def __init__(self, path):
        self.path = pathlib.Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a")

    def log(self, metrics: Dict, step: int):
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()
                    if isinstance(v, (int, float))})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def log_images(self, tag: str, images, step: int):
        pass  # images go to disk through the plot helpers, as in the JAX package

    def close(self):
        self._f.close()


class TensorBoardWriter:
    """events.py ``write_tblog``: scalars and HWC images into an event file
    under ``log_dir``."""

    def __init__(self, log_dir, native: bool = True):
        if native:
            from .tb_native import NativeTBWriter

            self.writer = NativeTBWriter(log_dir)
        else:
            from torch.utils.tensorboard import SummaryWriter  # needs tensorboard

            self.writer = SummaryWriter(str(log_dir))

    def log(self, metrics: Dict, step: int):
        for k, v in metrics.items():
            if isinstance(v, (int, float)):
                self.writer.add_scalar(k, v, step)

    def log_images(self, tag: str, images, step: int):
        for i, im in enumerate(images):
            self.writer.add_image(f"{tag}/{i}", np.asarray(im), step, dataformats="HWC")

    def close(self):
        self.writer.close()


class WandbWriter:
    """events.py ``write_wandb``: one wandb run of ``project``."""

    def __init__(self, project: str, config: Optional[Dict] = None):
        import wandb  # optional

        self.run = wandb.init(project=project, config=config or {})
        self._wandb = wandb

    def log(self, metrics: Dict, step: int):
        self._wandb.log(dict(metrics), step=step)

    def log_images(self, tag: str, images, step: int):
        self._wandb.log({tag: [self._wandb.Image(im) for im in images]}, step=step)

    def close(self):
        self.run.finish()


class MultiWriter:
    """Fan-out to every writer."""

    def __init__(self, writers: List):
        self.writers = writers

    @classmethod
    def default(cls, output_dir, project: str = "ers-tpu", config: Optional[Dict] = None,
                use_wandb: bool = False, use_tensorboard: bool = False) -> "MultiWriter":
        """``metrics.jsonl`` in ``output_dir``; with ``use_tensorboard`` the
        event files in ``output_dir/tb``; with ``use_wandb`` a wandb run of
        ``project`` with ``config``."""
        writers: List = [JsonlWriter(pathlib.Path(output_dir) / "metrics.jsonl")]
        backends = []
        if use_tensorboard:
            backends.append(lambda: TensorBoardWriter(pathlib.Path(output_dir) / "tb"))
        if use_wandb:
            backends.append(lambda: WandbWriter(project, config))
        for build in backends:
            try:
                writers.append(build())
            except ImportError as e:
                LOGGER.warning("metrics writer dropped: module %r is not installed", e.name)
        return cls(writers)

    def log(self, metrics: Dict, step: int):
        for w in self.writers:
            w.log(metrics, step)

    def log_images(self, tag: str, images, step: int):
        for w in self.writers:
            w.log_images(tag, images, step)

    def close(self):
        for w in self.writers:
            w.close()
