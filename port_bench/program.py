"""Readings of the port's own spans and counters, for the readers under
``metrics/`` whose ``source`` is ``program_span`` or ``program_counter``.

The port (``utils/profiling.py``) adds to its process-wide tables only
while a ``torch.profiler`` records, which in a run of ``run.py`` is the
traced window alone: at the end of a ``--trace 1`` run they hold the
window's spans (calls, host seconds) and counters. A port without these
tables (one that predates them), or an untraced run, reads None.
"""
from __future__ import annotations

from typing import Optional

from .core import Run


def _tables():
    """The port's ``utils/profiling`` module when it keeps span totals and
    counters, else None."""
    try:
        from event_representation_study_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not (hasattr(profiling, "span_totals") and hasattr(profiling, "counters")):
        return None
    return profiling


def span_ms(run: Run, name: str, per: str) -> Optional[float]:
    """Host ms of the span ``name`` in the window per ``extra[per]`` (a
    count of the run's work, such as ``steps``), or per call of the span
    when ``per`` is ``"calls"``. A span the window never opened reads 0
    per step, and None per call."""
    tables = _tables()
    if run.trace is None or tables is None:
        return None
    calls, seconds = tables.span_totals().get(name, (0, 0.0))
    n = calls if per == "calls" else run.extra.get(per, 0)
    return 1e3 * seconds / n if n else None


def counter_pct(run: Run, part: str, whole: str) -> Optional[float]:
    """The counter ``part`` over the counter ``whole``, in percent."""
    tables = _tables()
    if run.trace is None or tables is None:
        return None
    counts = tables.counters()
    return 100.0 * counts.get(part, 0) / counts[whole] if counts.get(whole) else None
