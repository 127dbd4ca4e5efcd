"""Experiment-config loader.

The reference execs Python config files into an addict ConfigDict
(ev-YOLOv6/yolov6/utils/config.py:35-101). We keep the same experiment-file
semantics — a Python file defining ``model``, ``solver``, ``data_aug``,
``training_mode`` — loaded into one plain nested dict, with dotted-key
overrides (the n_imagenet ``--override`` mini-language, main.py:49-80)."""
from __future__ import annotations

import importlib.util
import pathlib
from typing import Any, Dict, Optional, Sequence


def load_config(path: str, overrides: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    path = pathlib.Path(path)
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cfg = {
        k: v
        for k, v in vars(mod).items()
        if not k.startswith("_") and not callable(v) and not isinstance(v, type(importlib))
    }
    for ov in overrides or []:
        key, _, val = ov.partition("=")
        apply_override(cfg, key.strip(), val.strip())
    return cfg


def apply_override(cfg: Dict, dotted_key: str, raw_value: str) -> None:
    """``a.b.c=value`` override with literal-eval of the value."""
    import ast

    keys = dotted_key.split(".")
    d = cfg
    for k in keys[:-1]:
        d = d.setdefault(k, {})
    try:
        value = ast.literal_eval(raw_value)
    except (ValueError, SyntaxError):
        value = raw_value
    d[keys[-1]] = value
