"""Spans and the device trace of a ``--trace 1`` run.

Spans are ``torch.profiler.record_function`` ranges named ``bench/<layer>``
that the harness opens around its own calls into the port, or around port
functions it wraps at run time (:func:`wrap_attr`); the port itself is not
edited. :class:`Profiled` runs the profiler over the traced window and
:func:`reduce_trace` turns the profiler's events into what the metric
readers take: the device's busy time in the window, each span's host
interval and the device time of every kernel launched inside it, the top
device operations and the idle gaps labelled by the span the host was in.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

PREFIX = "bench/"
WINDOW = PREFIX + "window"


def span(name: str):
    """A host range ``bench/<name>``: a no-op unless a profiler runs."""
    return torch.profiler.record_function(PREFIX + name)


def wrap_attr(owner, attr: str, name: str, after: Optional[Callable] = None,
              before: Optional[Callable] = None):
    """Replace ``owner.attr`` (a module-level function or an instance's
    method) by one that runs inside the span ``name``; ``before(*args)`` is
    called on the arguments just before the span opens (what it launches is
    not the call's), ``after(result)`` on the result inside it. Returns a
    function that puts the original back."""
    real = getattr(owner, attr)

    def wrapped(*args, **kwargs):
        if before is not None:
            before(*args, **kwargs)
        with span(name):
            out = real(*args, **kwargs)
            if after is not None:
                after(out)
            return out

    setattr(owner, attr, wrapped)
    return lambda: setattr(owner, attr, real)


def module_span(module: torch.nn.Module, name: str):
    """Open the span ``name`` in a forward pre-hook and close it in the
    forward hook of ``module``. Returns the hooks' remover."""
    open_ranges: List = []

    def pre(_mod, _inp):
        rf = span(name)
        rf.__enter__()
        open_ranges.append(rf)

    def post(_mod, _inp, _out):
        open_ranges.pop().__exit__(None, None, None)

    h1 = module.register_forward_pre_hook(pre)
    h2 = module.register_forward_hook(post)

    def remove():
        h1.remove()
        h2.remove()

    return remove


@dataclasses.dataclass
class SpanCall:
    start_us: float
    end_us: float
    device_us: float  # device time of every kernel launched inside the call


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    spans: Dict[str, List[SpanCall]]
    device_ops: List[Tuple[str, float]]  # (name, seconds), largest first
    idle_gaps: List[Tuple[str, float]]  # (host span during the gap, seconds)

    def device_s(self, name: str) -> float:
        return sum(c.device_us for c in self.spans.get(name, [])) / 1e6

    def host_s(self, name: str) -> float:
        return sum(c.end_us - c.start_us for c in self.spans.get(name, [])) / 1e6


def union_us(intervals, lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals clipped to [lo, hi)
    (a copy of ``chip_smoke.py::union_us``)."""
    spans = sorted((max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + (cur_e - cur_s if cur_e is not None else 0.0)


def idle_gaps(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The gaps in [lo, hi) that no interval covers, in time order."""
    spans = sorted((max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi)
    gaps, cur = [], lo
    for s, e in spans:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if cur < hi:
        gaps.append((cur, hi))
    return gaps


def label_gaps(gaps, host_spans: Dict[str, List[SpanCall]], top: int = 10):
    """Seconds of idle device time by the span the host spent the most of
    each gap in (``host`` outside every span), largest first."""
    ranges = sorted(((c.start_us, c.end_us, n) for n, calls in host_spans.items()
                     for c in calls), key=lambda r: r[0])
    totals: Dict[str, float] = {}
    for g0, g1 in gaps:
        label, most, inside = "host", 0.0, []
        for s, e, n in ranges:
            if s >= g1:
                break
            cover = min(e, g1) - max(s, g0)
            if cover > 0:
                inside.append((s, e))
            if cover > most:
                label, most = n, cover
        if (g1 - g0) - union_us(inside, g0, g1) > most:  # mostly outside every span
            label = "host"
        totals[label] = totals.get(label, 0.0) + (g1 - g0) / 1e6
    return sorted(totals.items(), key=lambda kv: -kv[1])[:top]


def reduce_events(host, device, top: int = 10) -> TraceSummary:
    """``host``: (name, start_us, end_us, device_us) of every ``bench/``
    range; ``device``: (name, start_us, end_us) of every device operation.
    The window is the ``bench/window`` range."""
    spans: Dict[str, List[SpanCall]] = {}
    for name, s, e, dev in host:
        spans.setdefault(name[len(PREFIX):], []).append(SpanCall(s, e, dev))
    win = spans.pop(WINDOW[len(PREFIX):])
    lo, hi = win[0].start_us, win[0].end_us
    intervals = [(s, e) for _, s, e in device]
    busy = union_us(intervals, lo, hi)
    by_name: Dict[str, float] = {}
    for name, s, e in device:
        if e > lo and s < hi:
            by_name[name] = by_name.get(name, 0.0) + (min(e, hi) - max(s, lo)) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = label_gaps(idle_gaps(intervals, lo, hi), spans, top)
    return TraceSummary((hi - lo) / 1e6, busy / 1e6, spans, ops, gaps)


def reduce_trace(prof) -> TraceSummary:
    """:func:`reduce_events` of a finished ``torch.profiler.profile``.
    Device ranges named like a host span (the profiler mirrors user
    annotations on the device timeline) are not device work."""
    cuda = torch.autograd.DeviceType.CUDA
    host, device = [], []
    for e in prof.events():
        if e.name.startswith(PREFIX):
            if e.device_type != cuda:
                host.append((e.name, e.time_range.start, e.time_range.end,
                             e.device_time_total))
        elif e.device_type == cuda:
            device.append((e.name, e.time_range.start, e.time_range.end))
    return reduce_events(host, device)


class Profiled:
    """The traced window: with ``enabled``, ``torch.profiler`` over CPU and
    CUDA around the ``bench/window`` range; the summary is in
    ``self.summary`` after the block, the card synchronised before the
    range closes."""

    def __init__(self, enabled: bool, device: torch.device):
        self.enabled = enabled
        self.device = device
        self.summary: Optional[TraceSummary] = None
        self.t_end = 0.0
        self._stack = contextlib.ExitStack()
        self._prof = None

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._prof = self._stack.enter_context(profile(activities=acts))
            self._stack.enter_context(torch.profiler.record_function(WINDOW))
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t_end = time.perf_counter()  # the window's end, before the trace is read
        self._stack.close()
        if self.enabled and exc[0] is None:
            self.summary = reduce_trace(self._prof)
        return False
