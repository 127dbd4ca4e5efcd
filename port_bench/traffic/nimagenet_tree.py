"""A synthetic Mini N-ImageNet tree made from a seed: the benchmark's own
writer for the classification cell.

``classes`` directories ``n00000000`` ... with ``files_per_class`` ``.npz``
files each, every file one sample of ``events`` events on the 480x640
N-ImageNet sensor (the port's ``generate_fake_events`` law, copied in
:mod:`.gen1_windows`), stored as N-ImageNet stores them: a structured
``event_data`` array (x, y uint16, t int64 us, p bool), zlib-compressed
(``np.savez_compressed``). The list file names every file; a sample's
class is its directory, as ``cli/classify.py::read_list`` reads it.
"""
from __future__ import annotations

import pathlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .gen1_windows import fake_events

SENSOR_H, SENSOR_W = 480, 640
DTYPE = [("x", "<u2"), ("y", "<u2"), ("t", "<i8"), ("p", "?")]


def _write(path: pathlib.Path, n: int, duration_us: int, seed: int) -> None:
    ev = fake_events(n, SENSOR_H, SENSOR_W, duration_us, seed)
    data = np.zeros(n, DTYPE)
    data["x"], data["y"], data["t"], data["p"] = ev[0], ev[1], ev[2], ev[3] > 0
    np.savez_compressed(path, event_data=data)


def write_tree(root, dataset: dict, traffic: dict, seed: int, threads: int = 4):
    """Write under ``root`` the tree of ``dataset`` (``classes``,
    ``files_per_class``, from the configuration) with the samples a
    traffic file describes; returns (files, labels) in list order."""
    root = pathlib.Path(root)
    rng = np.random.default_rng(seed)
    jobs, files, labels = [], [], []
    for c in range(dataset["classes"]):
        d = root / f"n{c:08d}"
        d.mkdir(parents=True, exist_ok=True)
        for i in range(dataset["files_per_class"]):
            path = d / f"s{i}.npz"
            jobs.append((path, traffic["events_per_file"], traffic["duration_us"],
                         int(rng.integers(2 ** 62))))
            files.append(str(path))
            labels.append(c)
    with ThreadPoolExecutor(threads) as pool:
        for f in [pool.submit(_write, *job) for job in jobs]:
            f.result()
    return files, labels
