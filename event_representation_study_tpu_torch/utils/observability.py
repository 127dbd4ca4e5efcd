"""Experiment metrics writers (the JSONL part of the JAX package's
``utils/observability.py``): :class:`JsonlWriter` appends one JSON object
per logged step to ``metrics.jsonl``; :class:`MultiWriter` fans out to its
writers. The TensorBoard and wandb backends are ROADMAP item M19.
"""
from __future__ import annotations

import json
import pathlib
import time
from typing import Dict, List


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

    def close(self):
        self._f.close()


class MultiWriter:
    """Fan-out to every writer."""

    def __init__(self, writers: List):
        self.writers = writers

    @classmethod
    def default(cls, output_dir, use_wandb: bool = False,
                use_tensorboard: bool = False) -> "MultiWriter":
        if use_wandb or use_tensorboard:
            raise NotImplementedError(
                "the wandb and TensorBoard writers are not ported (ROADMAP M19); "
                "metrics go to metrics.jsonl")
        return cls([JsonlWriter(pathlib.Path(output_dir) / "metrics.jsonl")])

    def log(self, metrics: Dict, step: int):
        for w in self.writers:
            w.log(metrics, step)

    def close(self):
        for w in self.writers:
            w.close()
