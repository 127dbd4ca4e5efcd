"""Benchmark of the PyTorch/CUDA port (``event_representation_study_tpu_torch``).

``python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` on the card and prints one JSON line.
Cells, configurations, traffic mixes, timed loops (drivers) and metrics are
files found by name: ``workloads/<cell>.json``, ``configs/<config>.json``,
``traffic/<traffic>.json``, ``drivers/<driver>.py``, ``metrics/<metric>.py``,
with each configuration's plain reference in ``reference/<config>.py`` and
each traffic file's generator in ``traffic/<generator>.py``. A cell kept out
of ``BENCHMARK.json`` for now, with the files it runs on, lists the entries
that would add it back in ``held/<cell>.json``; the tests run it shrunk.
"""
