"""Event-stream windowing with ev-licious-exact semantics
(ev-licious/src/evlicious/io/h5_event_handle.py:10-11, :71-103); a copy of
the JAX package's ``events/windows.py`` (NumPy only).

Two quirks of the reference are load-bearing and reproduced verbatim:

* time -> index lookup adds 1e-3 to the query before ``searchsorted``, so
  an event AT an integer boundary timestamp belongs to the PRECEDING
  window (`_find_index_from_timestamps`, :10-11);
* in ``compute_time_and_index_windows`` the UNIT arguments are crossed:
  ``window_unit`` selects how the window END GRID is built from
  ``step_size``, and ``step_size_unit`` selects how the window SPAN is
  applied via ``window`` (:78-101). Callers that pass the same unit for
  both (every caller in the study) never observe the swap, but mixed-unit
  calls follow the reference bit-for-bit.
"""
from __future__ import annotations

import numpy as np


def find_index_from_timestamps(t_query, t_events):
    """h5_event_handle.py:10-11 (boundary events -> preceding window)."""
    return np.searchsorted(t_events, np.asarray(t_query) + 1e-3)


def time_and_index_windows(t, step_size: int, window: int,
                           step_size_unit: str, window_unit: str):
    """h5_event_handle.py:71-103 verbatim: returns
    ``((timestamps0, timestamps1), (i0, i1))`` — window end positions on a
    ``step_size`` grid (end-aligned; the +1 includes the stream end when it
    divides exactly), spans reaching ``window`` back from each end."""
    assert window_unit in ("nr", "us")
    assert step_size_unit in ("nr", "us")
    t = np.asarray(t)
    n = len(t)

    if window_unit == "nr":
        i1 = np.arange(step_size, n + 1, step_size)
        timestamps1 = t[np.clip(i1, 0, n - 1)]
    else:
        t0, t1 = t[0], t[-1]
        timestamps1 = np.arange(t0 + step_size, t1 + 1, step_size)
        i1 = find_index_from_timestamps(timestamps1, t)

    if step_size_unit == "nr":
        full_i0 = np.clip(i1 - window, 0, n - 1)
        # the reference reassigns i0 to the np.unique result (:95-97), so
        # its returned i0 is DEDUPLICATED (shorter than i1 when the clip
        # collapses several starts to 0) while timestamps0 stays full
        # length — reproduced verbatim; use :func:`index_windows` for
        # aligned per-window pairs
        i0, inverse = np.unique(full_i0, return_inverse=True)
        timestamps0 = t[i0][inverse]
    else:
        timestamps0 = timestamps1 - window
        i0 = np.clip(find_index_from_timestamps(timestamps0, t), 0, n - 1)

    return (timestamps0, timestamps1), (i0, i1)


def index_windows(n: int, window: int, stride: int | None = None) -> np.ndarray:
    """(k, 2) fixed-count windows — the reference's nr/nr grid, but with
    the per-window (i0, i1) pairing kept aligned (no i0 dedup). Takes the
    stream LENGTH, not the timestamps: the count grid needs no I/O."""
    stride = stride or window
    if n == 0:
        return np.zeros((0, 2), np.int64)
    i1 = np.arange(stride, n + 1, stride)
    i0 = np.clip(i1 - window, 0, n - 1)
    return np.stack([i0, i1], axis=-1).astype(np.int64)


def time_windows(t, window_us: int, stride_us: int | None = None) -> np.ndarray:
    """(n, 2) fixed-duration windows — the reference's us/us call."""
    stride_us = stride_us or window_us
    if len(t) == 0:
        return np.zeros((0, 2), np.int64)
    _, (i0, i1) = time_and_index_windows(t, stride_us, window_us, "us", "us")
    return np.stack([i0, i1], axis=-1).astype(np.int64)
