"""Every cell, configuration, traffic mix, driver and metric is found by
its name from files alone, and a new cell takes only new files."""
import json
import pathlib
import re
import shutil

import pytest
import torch

from port_bench import core
from port_bench.tests.shrunk import with_held

ROOT = pathlib.Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
FULL = with_held(SPEC)  # with the held cells added back
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in FULL["workloads"]])
def test_every_cell_resolves(cell):
    c = core.resolve_cell(cell, ROOT, FULL)
    assert c.config["name"] == c.entry["config"] and c.traffic["generator"]
    assert callable(c.driver().run) and callable(c.driver().controls)
    assert callable(c.reference().model) and callable(c.traffic_maker().__dict__.get(
        "from_traffic", c.traffic_maker().__dict__.get("write_tree")))
    assert c.config["precision"]["control"] and isinstance(c.config["precision"]["tf32"], bool)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(core.load_module("metrics", m["name"]).read)
    assert c.work["limits"], "a cell compares at least one number"


def test_contract_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["port_bench"] and 1 <= SPEC["run_seconds"] <= 51
    for spec in (SPEC, FULL):  # the held cells' entries hold to the contract too
        _check_entries(spec)


def _check_entries(SPEC):
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("port_bench/") and (ROOT / c["file"]).exists()
        assert all(NAME.match(k) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4) and len(w["why"]) <= 200
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: set(m.get("workloads", [w["name"] for w in SPEC["workloads"]]))
           for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= e2e[m["moves"]]
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_harness_names_no_cell():
    """run.py, core.py and the readers' helpers hold no cell, configuration
    or metric name: BENCHMARK.json and the files do."""
    names = ([w["name"] for w in FULL["workloads"]] + [c["name"] for c in FULL["configs"]]
             + [m["name"] for m in FULL["end_to_end"] + FULL["per_layer"]])
    for f in ("run.py", "core.py", "readers.py", "tracing.py"):
        text = (ROOT / "port_bench" / f).read_text()
        assert not [n for n in names if f'"{n}"' in text or f"'{n}'" in text], f


def test_new_cell_is_files_only(tmp_path):
    """The held cells added back, and a throwaway cell, configuration (with
    its own reference and a TF32 precision), traffic mix and per-layer
    metric written into a copy as new files and new BENCHMARK.json entries,
    are found; no existing file changes."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "port_bench", root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = with_held(SPEC)
    before = {p: p.read_bytes() for p in (root / "port_bench").rglob("*") if p.is_file()}
    bench = root / "port_bench"
    cfg = json.loads((bench / "configs" / "gen1_optimized.json").read_text())
    cfg["precision"].update(tf32=True, control={"autocast": "bfloat16"})
    (bench / "configs" / "gen1_throwaway.json").write_text(json.dumps(cfg))
    (bench / "reference" / "gen1_throwaway.py").write_text(
        (bench / "reference" / "gen1_optimized.py").read_text() + "\nTHROWAWAY = True\n")
    (bench / "traffic" / "bursty_b8.json").write_text(json.dumps(
        dict(json.loads((bench / "traffic" / "closed_loop_1.json").read_text()), clients=1)))
    (bench / "workloads" / "gen1_throwaway.serve.json").write_text(json.dumps(
        {"driver": "serve_closed_loop", "limits": {"box_gap_px": 1.0}}))
    (bench / "metrics" / "queue_ms.serve.py").write_text("def read(run):\n    return 1.0\n")
    spec["configs"].append({"name": "gen1_throwaway", "source": "https://example.org/x",
                            "file": "port_bench/configs/gen1_throwaway.json", "reduced": [],
                            "why": "test"})
    spec["workloads"].append({"name": "gen1_throwaway.serve", "config": "gen1_throwaway",
                              "traffic": "bursty_b8", "chips": 1, "why": "test"})
    spec["end_to_end"][[m["name"] for m in spec["end_to_end"]].index("serve_p95_ms")][
        "workloads"].append("gen1_throwaway.serve")
    spec["per_layer"].append({"name": "queue_ms.serve", "unit": "ms", "better": "lower",
                              "source": "program_span", "layer": "NMS",
                              "moves": "serve_p95_ms", "workloads": ["gen1_throwaway.serve"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    c = core.resolve_cell("gen1_throwaway.serve", root)
    assert c.config["name"] == "gen1_optimized" and c.traffic["clients"] == 1
    assert c.reference().THROWAWAY and c.traffic_maker().from_traffic
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    core.precision_flags(c.config["precision"])
    try:
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    assert [m["name"] for m in c.per_layer] == ["queue_ms.serve"]
    assert {m["name"] for m in c.end_to_end} == {"serve_p95_ms", "setup_s"}
    assert core.load_module("metrics", "queue_ms.serve", bench).read(None) == 1.0
    assert core.load_module("drivers", c.work["driver"], bench).run
    changed = [p for p, b in before.items() if p.read_bytes() != b]
    assert not changed


def test_unknown_names_fail():
    with pytest.raises(core.HarnessError):
        core.resolve_cell("no_such.cell", ROOT)
    with pytest.raises(core.HarnessError):
        core.load_module("metrics", "no_such_metric")
