"""ERGO-12 — the optimized 12-channel representation found by the study: the
fixed (window, function, aggregation) triples of the "v2" optimum, SBN
stacking (constants copied from the JAX package's ``reps/ergo12.py``). The
batched form on K1 is ``fused_mdes.ergo12_fused_batched``."""
from __future__ import annotations


WINDOW_INDEXES = (0, 3, 2, 6, 5, 6, 2, 5, 1, 0, 4, 1)
FUNCTIONS = (
    "polarity",
    "timestamp_neg",
    "count_neg",
    "polarity",
    "count_pos",
    "count",
    "timestamp_pos",
    "count_neg",
    "timestamp_neg",
    "timestamp_pos",
    "timestamp",
    "count",
)
AGGREGATIONS = (
    "variance",
    "variance",
    "mean",
    "sum",
    "mean",
    "sum",
    "mean",
    "mean",
    "max",
    "max",
    "max",
    "mean",
)
STACKING_TYPE = "SBN"

