"""A shrunk copy of the benchmark for CPU tests: ``BENCHMARK.json`` (with
the held cells added back) and ``port_bench/`` copied under a temporary
root beside a link to the port,
the configurations cut (depth x 0.2, width x 0.125, 128 px) and the traffic
cut (a few windows of 2,048 events), so that a whole run of a cell takes
seconds on the CPU. The tests then drive ``run.py::execute`` there."""
from __future__ import annotations

import json
import pathlib
import shutil

REPO = pathlib.Path(__file__).resolve().parents[2]
PORT = "event_representation_study_tpu_torch"

CONFIG_CUTS = {
    "nimagenet_resnet34": {"program.model": "ResNet18", "program.batch_size": 4,
                           "program.slice_length": 2000, "dataset.classes": 4,
                           "dataset.files_per_class": 4},
    "gen1_optimized": {"program.model.depth_multiple": 0.2, "program.model.width_multiple": 0.125,
                       "program.data.img_size": 128},
}
TRAFFIC_CUTS = {
    "npz_b64": {"events_per_file": 3000},
    "closed_loop_1": {"num_events": 2048, "unique_windows": 4, "warmup_requests": 1,
                      "calibration_windows": 2, "sample_requests": 4},
    "strong_aug_b32": {"num_events": 2048, "unique_windows": 4, "length": 400, "batch_size": 4,
                       "nominal_batch_size": 8},
}


# the shrunk serving cell's reference serves one window a forward, as the
# port does: on the CPU both then compute alike, and a sound run reads 0
# (the shrunk detector's coarse levels see a few values a channel, so at
# other batch sizes its float32 rounding reads tenths of a pixel)
WORKLOAD_CUTS = {}


def _set(d: dict, dotted: str, value) -> None:
    *path, last = dotted.split(".")
    for k in path:
        d = d[k]
    d[last] = value


def with_held(spec: dict) -> dict:
    """``spec`` (BENCHMARK.json's form) with the entries of every held cell
    (``port_bench/held/<cell>.json``: a cell kept out of BENCHMARK.json,
    with the files it runs on) added back, as a later PR would add them."""
    spec = json.loads(json.dumps(spec))
    for path in sorted((REPO / "port_bench" / "held").glob("*.json")):
        held = json.loads(path.read_text())
        for key in ("workloads", "end_to_end", "per_layer"):
            spec[key] += held[key]
    return spec


def shrunk_root(tmp: pathlib.Path) -> pathlib.Path:
    root = pathlib.Path(tmp) / "checkout"
    root.mkdir()
    spec = with_held(json.loads((REPO / "BENCHMARK.json").read_text()))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    shutil.copytree(REPO / "port_bench", root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / PORT).symlink_to(REPO / PORT)
    for kind, cuts in (("configs", CONFIG_CUTS), ("traffic", TRAFFIC_CUTS),
                       ("workloads", WORKLOAD_CUTS)):
        for name, edits in cuts.items():
            path = root / "port_bench" / kind / f"{name}.json"
            data = json.loads(path.read_text())
            for k, v in edits.items():
                _set(data, k, v)
            path.write_text(json.dumps(data))
    return root
