"""Arithmetic shared by the metric readers under ``metrics/``. Each reader
returns None where its run holds nothing to read (an untraced run, a cell
without the layer), and the harness then leaves the metric out."""
from __future__ import annotations

from typing import Optional

from .core import Run
from .yardstick import HBM_BYTES_PER_S


def per_second(run: Run, key: str) -> Optional[float]:
    """``extra[key]`` over the window's seconds."""
    if key not in run.extra or run.window_s <= 0:
        return None
    return run.extra[key] / run.window_s


def device_idle_pct(run: Run) -> Optional[float]:
    """Share of the traced window in which no device operation ran."""
    if run.trace is None or run.trace.window_s <= 0 or run.trace.busy_s <= 0:
        return None  # no device operation traced: nothing to read
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def roofline_pct(run: Run, span: str, bytes_key: str) -> Optional[float]:
    """The least time of the calls of ``span`` (their least bytes at the
    card's HBM rate) over the device time of every kernel launched inside
    them, in percent."""
    if run.trace is None:
        return None
    device_s = run.trace.device_s(span)
    nbytes = run.extra.get(bytes_key, 0)
    if device_s <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / device_s


def mfu_pct(run: Run, flops_key: str, count_key: str) -> Optional[float]:
    """Model FLOPs of the window's work over the window and the peak of the
    precision the run used, in percent."""
    if (run.trace is None or run.trace.busy_s <= 0 or flops_key not in run.extra
            or run.window_s <= 0):
        return None
    done = run.extra[flops_key] * run.extra[count_key]
    return 100.0 * done / run.window_s / run.extra["peak_flops"]


def per_call_ms(run: Run, total_s_key: str, count_key: str) -> Optional[float]:
    """``extra[total_s_key]`` per ``extra[count_key]``, in ms."""
    if run.trace is None or not run.extra.get(count_key):
        return None
    return 1e3 * run.extra[total_s_key] / run.extra[count_key]
