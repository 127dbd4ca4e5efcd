"""Categorical benchmark surfaces (gryffin/src/gryffin/benchmark_functions/):
test objectives for BO smoke tests — each maps a grid of categorical options
to a synthetic landscape with a known optimum."""
from __future__ import annotations

import numpy as np


def _grid_coords(sample, num_opts):
    """option indices -> [-1, 1]^d coordinates."""
    return np.array(
        [2 * s / max(n - 1, 1) - 1 for s, n in zip(sample, num_opts)], float
    )


def cat_dejong(sample, num_opts):
    """Sphere function: optimum at the center options."""
    x = _grid_coords(sample, num_opts)
    return float(np.sum(x**2))


def cat_camel(sample, num_opts):
    """Six-hump-camel-like surface on the first two dims."""
    x = _grid_coords(sample, num_opts) * 2
    a, b = x[0], x[1] if len(x) > 1 else 0.0
    return float(
        (4 - 2.1 * a**2 + a**4 / 3) * a**2 + a * b + (-4 + 4 * b**2) * b**2
    )


def cat_ackley(sample, num_opts):
    x = _grid_coords(sample, num_opts) * 3
    d = len(x)
    return float(
        -20 * np.exp(-0.2 * np.sqrt(np.sum(x**2) / d))
        - np.exp(np.sum(np.cos(2 * np.pi * x)) / d)
        + 20
        + np.e
    )
