"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The run builds its inputs and weights from
``--seed``, sets up and warms the cell's shapes (``setup_s``), measures for
``--seconds`` (with ``--trace 1`` under the profiler, for the per-layer
metrics), then checks what the timed path produced against the plain
reference and prints, as the last line of standard output, one JSON object
with ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
(``breakdown`` when traced) and ``checks`` last: every number compared
with its limit, which also close standard error.

Exits with code 2 and no result without CUDA, with fewer cards than the cell
needs, without the port, or when JAX or the JAX package was loaded. The
TF32 switches are set from the configuration's ``precision`` before
anything is built.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CACHE = ".bench_cache"  # build and kernel caches, at a fixed path in the checkout


def cache_env(root: pathlib.Path) -> None:
    """Every build and kernel cache of the process inside the checkout, at
    fixed paths, so that only a checkout's first run builds. (The port's
    own kernel libraries go to ``event_representation_study_tpu_torch/_build``,
    also in the checkout.)"""
    cache = root / CACHE
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)


def execute(workload: str, seed: int, seconds: float, trace: bool, device=None,
            root: pathlib.Path = ROOT):
    """Run the cell; returns (Run, result dict). ``device`` None looks for
    the cell's cards (and fails without them); the tests pass the CPU."""
    from port_bench import core

    cell = core.resolve_cell(workload, root)
    if device is None:
        device = core.require_cards(cell.chips)
    core.precision_flags(cell.config["precision"])
    driver = cell.driver()
    tmp = core.make_tmp()
    try:
        # any whole number: the generators take it modulo 2**63
        ctx = core.Context(cell, int(seed) % 2 ** 63, float(seconds), bool(trace), device,
                           T_START, tmp)
        run = driver.run(ctx)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    bad = core.forbidden_modules()
    if bad:
        raise core.HarnessError(f"forbidden modules loaded: {', '.join(bad)}")
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = core.load_module("metrics", m["name"], root / "port_bench").read(run)
        if value is None:
            if not trace:
                raise core.HarnessError(f"end-to-end metric {m['name']} has no reading")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (__import__("torch").cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(run.memory_peak_bytes)}
    result = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": dev}
    info = run.extra.setdefault("info", {})
    if device.type == "cuda":
        from port_bench import yardstick

        info["card"] = yardstick.card_power()
    if run.trace is not None:
        info["spans"] = {  # calls, host s, device s of kernels inside
            name: [len(calls), run.trace.host_s(name), run.trace.device_s(name)]
            for name, calls in sorted(run.trace.spans.items())}
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": [list(x) for x in run.trace.device_ops],
                               "idle_gaps": [list(x) for x in run.trace.idle_gaps]}
    result["checks"] = {k: {"value": c.value, "limit": c.limit} for k, c in run.checks.items()}
    return run, result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    cache_env(ROOT)
    try:
        from port_bench import core
    except ImportError as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return 2
    try:
        run, result = execute(args.workload, args.seed, args.seconds, bool(args.trace))
    except (core.HarnessError, ImportError) as e:
        print(f"port_bench: no result: {e}", file=sys.stderr, flush=True)
        return 2
    for k, v in run.extra.get("info", {}).items():
        print(f"[info] {k} {json.dumps(v)}", flush=True)
    for k, c in run.checks.items():
        print(f"check {k} {c.value!r} limit {c.limit!r} {'ok' if c.passed else 'FAILED'}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
