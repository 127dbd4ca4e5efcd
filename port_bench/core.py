"""The harness's general part: finding a cell's files by name, the run's
context, the checks that decide ``correct``, and the result line.

Nothing here names a cell, a configuration or a metric: ``BENCHMARK.json``
names them, and each is a file found by that name (package docstring).
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import pathlib
import sys
import tempfile
from typing import Any, Dict, List, Optional

import torch

from . import tracing

BENCH_DIR = pathlib.Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# top-level module names the benchmark's process may never hold
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "event_representation_study_tpu")


class HarnessError(RuntimeError):
    """A run that cannot give a result: no card, a missing file, a
    forbidden module. ``run.py`` prints it and exits with code 2."""


def load_json(path: pathlib.Path) -> Any:
    if not path.exists():
        raise HarnessError(f"missing {path}")
    return json.loads(path.read_text())


def load_module(kind: str, name: str, bench_dir: pathlib.Path = BENCH_DIR):
    """``<bench_dir>/<kind>/<name>.py`` imported by path (a metric's name
    may hold dots)."""
    path = bench_dir / kind / f"{name}.py"
    if not path.exists():
        raise HarnessError(f"no {kind} file {name!r}: missing {path}")
    mod_name = f"port_bench.{kind}._by_name_{name.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """Everything one cell of ``BENCHMARK.json`` names, read from files."""

    name: str
    entry: Dict[str, Any]  # the BENCHMARK.json workloads entry
    config: Dict[str, Any]  # configs/<config>.json
    work: Dict[str, Any]  # workloads/<cell>.json
    traffic: Dict[str, Any]  # traffic/<traffic>.json
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    bench_dir: pathlib.Path = BENCH_DIR  # the checkout's port_bench/

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def driver(self):
        """The cell's timed loop, ``drivers/<driver>.py``, as the workload
        file names it."""
        return load_module("drivers", self.work["driver"], self.bench_dir)

    def reference(self):
        """The configuration's plain reference, ``reference/<config>.py``."""
        return load_module("reference", self.entry["config"], self.bench_dir)

    def traffic_maker(self):
        """The traffic's generator, ``traffic/<generator>.py``, as the
        traffic file names it."""
        return load_module("traffic", self.traffic["generator"], self.bench_dir)


def resolve_cell(name: str, root: pathlib.Path = ROOT, spec: Optional[Dict] = None) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` (or of ``spec``, a
    dict of its form) with its files; the benchmark's files lie under
    ``<root>/port_bench``."""
    spec = load_json(root / "BENCHMARK.json") if spec is None else spec
    entries = [w for w in spec["workloads"] if w["name"] == name]
    if not entries:
        raise HarnessError(f"BENCHMARK.json has no workload {name!r}")
    entry = entries[0]
    conf = [c for c in spec["configs"] if c["name"] == entry["config"]]
    if not conf:
        raise HarnessError(f"BENCHMARK.json has no config {entry['config']!r}")
    bench_dir = root / "port_bench"
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)]
    return Cell(name, entry, load_json(root / conf[0]["file"]),
                load_json(bench_dir / "workloads" / f"{name}.json"),
                load_json(bench_dir / "traffic" / f"{entry['traffic']}.json"), e2e, per_layer,
                bench_dir)


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def precision_flags(precision: Dict[str, Any]) -> None:
    """cuDNN's and the matmuls' TF32 switches as a configuration's
    ``precision`` states them (its ``dtype`` and ``autocast`` are the
    driver's to hand to the program); a configuration that states no
    ``tf32`` has no result."""
    if not isinstance(precision.get("tf32"), bool):
        raise HarnessError("the configuration's precision states no tf32 switch")
    torch.backends.cudnn.allow_tf32 = precision["tf32"]
    torch.backends.cuda.matmul.allow_tf32 = precision["tf32"]


def require_cards(chips: int) -> torch.device:
    """The first card, after checking that ``chips`` cards are there. A
    run with fewer has no result: there is no fall-back to the CPU."""
    if not torch.cuda.is_available():
        raise HarnessError("CUDA is not available: this benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise HarnessError(f"{torch.cuda.device_count()} card(s), the cell needs {chips}")
    return torch.device("cuda", 0)


@dataclasses.dataclass
class Check:
    value: float
    limit: float

    @property
    def passed(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Run:
    """What a driver hands back: the window's counts and times, the traced
    window's summary, the numbers compared with their limits, and what the
    metric readers need besides (``extra``)."""

    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    trace: Optional[tracing.TraceSummary] = None
    checks: Dict[str, Check] = dataclasses.field(default_factory=dict)
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.passed for c in self.checks.values())


@dataclasses.dataclass
class Context:
    """A run's arguments and surroundings, handed to the cell's timed loop
    (``drivers/<driver>.py``)."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float  # perf_counter at process start
    tmp: pathlib.Path

    @property
    def window_seconds(self) -> float:
        """The window's length: ``--seconds``, and in a traced run at most
        the cell's ``trace_seconds`` (its trace stays small)."""
        if self.trace:
            return min(self.seconds, float(self.cell.work.get("trace_seconds", self.seconds)))
        return self.seconds

    def checks(self, readings: Dict[str, float]) -> Dict[str, Check]:
        """The readings of every number the cell compares, each with its
        limit from the workload file; a reading missing reads infinite."""
        return {k: Check(float(readings.get(k, math.inf)), float(v))
                for k, v in self.cell.work["limits"].items()}


def make_tmp() -> pathlib.Path:
    """A directory of this run under ``$TMPDIR``."""
    return pathlib.Path(tempfile.mkdtemp(prefix="port_bench_"))
