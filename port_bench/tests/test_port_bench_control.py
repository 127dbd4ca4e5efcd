"""The control of every cell comes out not correct: the plain reference in
the port's place, computed in TF32 (the precision below the
configurations' float32 with TF32 off), at the cell's own size on one
seed, fails at least one of the cell's limits; so do the planted faults.
The held cells (``port_bench/held/``) are tested too. Card only (TF32 exists on
the card alone); ``controls.py`` reads the same on more seeds."""
import json
import pathlib

import pytest

from port_bench import controls, core
from port_bench.tests.shrunk import with_held

ROOT = pathlib.Path(__file__).resolve().parents[2]
SPEC = with_held(json.loads((ROOT / "BENCHMARK.json").read_text()))
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit(card, cell):
    c = core.resolve_cell(cell, ROOT, SPEC)
    readings = dict(controls.readings(c, 2 ** 31 + 4711, card))
    control = readings["control"]
    assert any(not v <= c.work["limits"][k] for k, v in control.items()), control
    for kind, got in readings.items():  # every planted fault fails a limit too
        assert any(not v <= c.work["limits"][k] for k, v in got.items()), (kind, got)
