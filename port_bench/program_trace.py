"""The port's own ranges in a traced window, and the device's idle time
labelled by them.

    python3 port_bench/program_trace.py --workload <cell> --seed <n> --seconds <s>

From the root of a checkout: runs the cell as ``run.py --trace 1`` does
(its lines are printed as ``run.py`` prints them) and then prints two more
lines, ``[program] spans`` and ``[program] idle``, reduced from the same
profiler's events by :func:`reduce_program`:

- each ``ers/<name>`` range of the port (``utils/profiling.py::span``):
  calls, host seconds, self seconds (less what the span's child ranges on
  the same thread cover) and the device seconds of the kernels launched
  inside it;
- the window's idle device time split by the innermost ``ers/`` range the
  step's thread (the thread of the ``bench/window`` range) was in at each
  moment, ``outside`` where it was in none, and the share of the idle time
  inside a range. Ranges of other threads never label idle time.

The result line's fields are ``run.py``'s, unchanged.
"""
from __future__ import annotations

import json
import pathlib
import sys
from typing import Dict, List, Optional, Tuple

PREFIX = "ers/"
OUTSIDE = "outside"


def innermost_segments(ranges, lo: float, hi: float) -> List[Tuple[float, float, Optional[str]]]:
    """[lo, hi) cut into (start, end, name) pieces by the innermost of
    ``ranges`` ((name, start, end) on one thread, nested as a thread's
    ranges are) covering each piece; None where none does."""
    out: List[Tuple[float, float, Optional[str]]] = []

    def emit(s, e, name):
        s, e = max(s, lo), min(e, hi)
        if e > s:
            out.append((s, e, name))

    stack: List[Tuple[float, str]] = []  # (end, name), innermost last
    cur = lo
    for name, s, e in sorted(ranges, key=lambda r: (r[1], -r[2])):
        while stack and stack[-1][0] <= s:
            end, inner = stack.pop()
            emit(cur, end, inner)
            cur = max(cur, end)
        emit(cur, s, stack[-1][1] if stack else None)
        cur = max(cur, s)
        stack.append((e, name))
    while stack:
        end, inner = stack.pop()
        emit(cur, end, inner)
        cur = max(cur, end)
    emit(cur, hi, None)
    return out


def label_idle(gaps, segments) -> Dict[str, float]:
    """Seconds of the idle ``gaps`` ((start, end) in us, in time order) in
    each labelled piece of ``segments`` (:func:`innermost_segments`)."""
    totals: Dict[str, float] = {}
    j = 0
    for g0, g1 in gaps:
        while j < len(segments) and segments[j][1] <= g0:
            j += 1
        k = j
        while k < len(segments) and segments[k][0] < g1:
            s, e, name = segments[k]
            cover = min(e, g1) - max(s, g0)
            if cover > 0:
                key = OUTSIDE if name is None else name
                totals[key] = totals.get(key, 0.0) + cover / 1e6
            k += 1
    return totals


def self_us(calls) -> List[float]:
    """Each of ``calls`` ((start, end) on one thread, nested) less the union
    of the calls nested directly inside it."""
    order = sorted(range(len(calls)), key=lambda i: (calls[i][0], -calls[i][1]))
    own = [calls[i][1] - calls[i][0] for i in range(len(calls))]
    stack: List[int] = []
    for i in order:
        s, e = calls[i]
        while stack and calls[stack[-1]][1] <= s:
            stack.pop()
        if stack:
            own[stack[-1]] -= e - s  # a direct child: its own children lie inside it
        stack.append(i)
    return own


def reduce_program(host, device, window, top: int = 12) -> Dict:
    """``host``: (name, thread, start_us, end_us, device_us) of every
    ``ers/`` range, name without the prefix; ``device``: (start_us, end_us)
    of every device operation; ``window``: (thread, start_us, end_us) of the
    ``bench/window`` range. Returns ``spans`` {name: [calls, host s, self
    s, device s]}, ``idle`` [(label, s)] largest first (at most ``top``)
    and ``idle_inside_share``, the share of the window's idle time inside
    an ``ers/`` range of the step's thread."""
    from port_bench.tracing import idle_gaps

    step_thread, lo, hi = window
    spans: Dict[str, List[float]] = {}
    by_thread: Dict[int, List[int]] = {}
    for i, (_, thread, _, _, _) in enumerate(host):
        by_thread.setdefault(thread, []).append(i)
    own = [0.0] * len(host)
    for idx in by_thread.values():
        for i, us in zip(idx, self_us([(host[i][2], host[i][3]) for i in idx])):
            own[i] = us
    for (name, _, s, e, dev), us in zip(host, own):
        row = spans.setdefault(name, [0, 0.0, 0.0, 0.0])
        row[0] += 1
        row[1] += (e - s) / 1e6
        row[2] += us / 1e6
        row[3] += dev / 1e6
    gaps = idle_gaps(device, lo, hi)
    segments = innermost_segments(
        [(n, s, e) for n, t, s, e, _ in host if t == step_thread], lo, hi)
    labelled = label_idle(gaps, segments)
    idle_s = sum((g1 - g0) / 1e6 for g0, g1 in gaps)
    inside = idle_s - labelled.get(OUTSIDE, 0.0)
    return {"spans": {k: spans[k] for k in sorted(spans)},
            "idle": sorted(labelled.items(), key=lambda kv: -kv[1])[:top],
            "idle_s": idle_s, "idle_inside_share": inside / idle_s if idle_s > 0 else None}


def events_of(prof):
    """(host, device, window) of :func:`reduce_program` from a finished
    ``torch.profiler.profile``; device ranges named like a host range are
    the profiler's mirrors of annotations, not device work (as
    ``tracing.reduce_trace`` reads them)."""
    import torch

    from port_bench.tracing import PREFIX as BENCH, WINDOW

    cuda = torch.autograd.DeviceType.CUDA
    host, device, window = [], [], None
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            if not e.name.startswith((BENCH, PREFIX)):
                device.append((start, end))
        elif e.name.startswith(PREFIX):
            host.append((e.name[len(PREFIX):], e.thread, start, end, e.device_time_total))
        elif e.name == WINDOW:
            window = (e.thread, start, end)
    return host, device, window


def main(argv=None) -> int:
    root = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    from port_bench import run, tracing

    argv = list(sys.argv[1:] if argv is None else argv)
    held = {}
    real = tracing.reduce_trace

    def reduce_trace(prof):  # the harness's reduction, and the program's beside it
        held["program"] = reduce_program(*events_of(prof))
        return real(prof)

    tracing.reduce_trace = reduce_trace
    try:
        rc = run.main(argv + ["--trace", "1"])
    finally:
        tracing.reduce_trace = real
    program = held.get("program")
    if program is not None:
        print(f"[program] spans {json.dumps(program['spans'])}", flush=True)
        print(f"[program] idle {json.dumps({k: program[k] for k in ('idle', 'idle_s', 'idle_inside_share')})}",
              flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
