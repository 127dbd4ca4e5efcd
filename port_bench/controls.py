"""The readings that set each cell's limits from above: the control and the
planted faults, read on the card at the cell's own size. The benchmark's
runs never run this; it is run once when limits are set:

    python3 port_bench/controls.py --workload <cell> --seeds 11,12,13

The control is the plain reference put in the port's place and computed in
the nearest precision below the configuration's, which the configuration
names (:func:`lower_precision`).
Each cell's driver gives its control and faults (``controls`` in
``drivers/<driver>.py``), each read through the same judge as a run's. A
state returned unchanged reads 1 on a change gap by the judge's measure and
needs no run. Prints one JSON line a seed and kind.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys
from typing import Dict, Iterator, Tuple

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench import core  # noqa: E402


@contextlib.contextmanager
def lower_precision(precision: Dict):
    """Inside the block, the precision just below a configuration's, as its
    ``precision["control"]`` states it: ``tf32`` sets cuDNN's and the
    matmuls' TF32 switches, ``autocast`` names the dtype of a CUDA autocast
    (``bfloat16``, ``float16``)."""
    control = precision.get("control")
    if not control:
        raise core.HarnessError("the configuration's precision states no control")
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    if "tf32" in control:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = bool(
            control["tf32"])
    autocast = (torch.autocast("cuda", dtype=getattr(torch, control["autocast"]))
                if control.get("autocast") else contextlib.nullcontext())
    try:
        with autocast:
            yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def readings(cell: core.Cell, seed: int, dev) -> Iterator[Tuple[str, Dict[str, float]]]:
    """(kind, the cell's numbers) of the control and each planted fault."""
    core.precision_flags(cell.config["precision"])
    yield from cell.driver().controls(
        cell, seed, dev, lambda: lower_precision(cell.config["precision"]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="control and fault readings of a cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    args = p.parse_args(argv)
    cell = core.resolve_cell(args.workload, ROOT)
    dev = core.require_cards(cell.chips)
    limits = cell.work["limits"]
    for seed in (int(s) for s in args.seeds.split(",")):
        for kind, got in readings(cell, seed, dev):
            fails = [k for k, v in got.items() if not v <= limits[k]]
            print(json.dumps({"workload": args.workload, "seed": seed, "kind": kind,
                              "readings": got, "fails": fails}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
