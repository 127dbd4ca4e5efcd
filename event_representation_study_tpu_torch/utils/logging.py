"""Rank-aware logging (the JAX package's ``utils/logging.py``, the
equivalent of ev-YOLOv6/yolov6/utils/events.py LOGGER, :10-20): only rank 0
logs below WARNING. The rank is the ``RANK`` environment variable that
``torchrun`` sets (0 when absent)."""
from __future__ import annotations

import logging
import os


def get_logger(name: str = "ers_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("%(asctime)s %(name)s: %(message)s"))
        logger.addHandler(h)
        rank = int(os.environ.get("RANK", "0"))
        logger.setLevel(logging.INFO if rank == 0 else logging.WARNING)
    return logger
