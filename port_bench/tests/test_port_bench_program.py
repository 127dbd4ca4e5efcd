"""The readings of the port's own spans and counters (``program.py``, the
readers of ``metrics/`` with a ``program_*`` source) and the reduction of
its ranges in a trace (``program_trace.py``).

- Each shrunk cell (``shrunk.py``), traced on the CPU, reads every such
  metric of the cell, and stays correct.
- A port without the tables, or an untraced run, reads None.
- ``reduce_program`` labels idle time by the innermost range of the step's
  thread, never by another thread's, and counts self times.
- ``tracing.reduce_trace`` reads the same from a trace with and without the
  port's ranges.
"""
import json
import pathlib
import types

import pytest
import torch

from port_bench import core, program, tracing
from port_bench import run as harness
from port_bench.program_trace import reduce_program
from port_bench.tests.shrunk import shrunk_root

from event_representation_study_tpu_torch.utils import profiling

ROOT = pathlib.Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
SEED = 2 ** 31 + 4343
PROGRAM = {w["name"]: sorted(m["name"] for m in SPEC["per_layer"]
                             if m["source"] in ("program_span", "program_counter")
                             and w["name"] in m["workloads"]
                             and m["name"] not in ("loader_wait_ms.train", "load_share.classify"))
           for w in SPEC["workloads"]}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(4)
    return shrunk_root(tmp_path_factory.mktemp("bench"))


@pytest.fixture(autouse=True)
def fresh_tables(monkeypatch):
    monkeypatch.setattr(profiling, "_COUNTS", {})
    monkeypatch.setattr(profiling, "_SPANS", {})


@pytest.mark.parametrize("cell", ["gen1_optimized.train", "nimagenet_resnet34.train"])
def test_traced_cell_reads_the_program_metrics(root, cell):
    run, result = harness.execute(cell, SEED, 1.0, True, device=torch.device("cpu"), root=root)
    assert result["correct"], result["checks"]
    got = result["metrics"]
    assert PROGRAM[cell] and all(name in got for name in PROGRAM[cell]), (PROGRAM[cell], got)
    for name in PROGRAM[cell]:
        assert got[name]["value"] >= 0
    if cell == "gen1_optimized.train":
        # the two halves of the benchmark's own span around next() of the feed
        halves = got["prefetch_wait_ms.train"]["value"] + got["h2d_stage_ms.train"]["value"]
        assert 0 < halves <= got["loader_wait_ms.train"]["value"]
        assert got["loader_starved.train"]["value"] <= 100 and got["ema_ms.train"]["value"] > 0
    else:
        host_ms = 1e3 * run.extra["load_s"] / run.extra["steps"]
        parts = got["decode_ms.classify"]["value"] + got["prep_ms.classify"]["value"]
        assert 0 < parts <= host_ms


def test_readers_read_none_without_the_tables(monkeypatch):
    summary = tracing.reduce_events([("bench/window", 0.0, 1e6, 0.0)], [])
    traced = core.Run(window_s=1.0, trace=summary, extra={"steps": 2})
    with torch.profiler.profile():
        with profiling.span("ema"):
            pass
    assert program.span_ms(traced, "ema", "calls") > 0
    assert program.span_ms(traced, "loader/wait", "steps") == 0.0  # never opened
    assert program.span_ms(traced, "loader/wait", "calls") is None
    assert program.counter_pct(traced, "loader/empty_takes", "loader/takes") is None
    assert program.span_ms(core.Run(window_s=1.0, extra={"steps": 2}), "ema", "calls") is None
    monkeypatch.delattr(profiling, "span_totals")  # a port from before the tables
    assert program.span_ms(traced, "ema", "calls") is None
    assert program.counter_pct(traced, "loader/empty_takes", "loader/takes") is None


def test_reduce_program_labels_idle_by_the_innermost_step_range():
    host = [("step", 1, 5.0, 90.0, 4.0), ("step/loss", 1, 20.0, 40.0, 1.0),
            ("ema", 1, 60.0, 80.0, 0.0), ("worker", 2, 0.0, 100.0, 0.0)]
    device = [(0.0, 10.0), (50.0, 60.0)]
    out = reduce_program(host, device, (1, 0.0, 100.0))
    idle = dict(out["idle"])
    # gaps [10, 50) and [60, 100): step 10 + 10 + 10, loss 20, ema 20, outside 10
    assert idle == pytest.approx({"step": 30e-6, "step/loss": 20e-6, "ema": 20e-6,
                                  "outside": 10e-6})
    assert "worker" not in idle
    assert out["idle_s"] == pytest.approx(80e-6)
    assert out["idle_inside_share"] == pytest.approx(70 / 80)
    calls, host_s, self_s, device_s = out["spans"]["step"]
    assert calls == 1 and host_s == pytest.approx(85e-6) and self_s == pytest.approx(45e-6)
    assert device_s == pytest.approx(4e-6)
    assert out["spans"]["worker"][2] == pytest.approx(100e-6)


class _Event:
    def __init__(self, name, start, end, device=False, thread=1, device_us=0.0):
        self.name, self.thread, self.device_time_total = name, thread, device_us
        self.time_range = types.SimpleNamespace(start=start, end=end)
        self.device_type = (torch.autograd.DeviceType.CUDA if device
                            else torch.autograd.DeviceType.CPU)


def test_reduce_trace_ignores_the_program_ranges():
    bench = [_Event("bench/window", 0, 1000), _Event("bench/loader", 100, 300, device_us=50),
             _Event("bench/loader", 100, 300, device=True), _Event("k", 120, 170, device=True),
             _Event("k2", 600, 700, device=True)]
    program_ranges = [_Event("ers/loader/wait", 110, 200), _Event("ers/step", 400, 900),
                      _Event("ers/step/loss", 500, 800, device_us=100)]
    plain = tracing.reduce_trace(types.SimpleNamespace(events=lambda: bench))
    mixed = tracing.reduce_trace(types.SimpleNamespace(events=lambda: bench + program_ranges))
    assert mixed == plain
    assert plain.idle_gaps == [("host", pytest.approx(850e-6))]
