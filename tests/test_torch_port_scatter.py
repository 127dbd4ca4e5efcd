"""The port's segment primitives (``ops/scatter.py``) against the JAX
package's on the same NumPy inputs: the conftest streams (2500, 800 and 64
events at 240x304), a ragged block (its tail padded) and an empty window.

Tolerances: counts, last positions, last-write values and top-k slots
exactly; sums, means, maxes and minima rtol 1e-6; the variance rtol 1e-6 plus
atol 1e-6 (E[x^2] - E[x]^2 cancels in float32 where it is near 0).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event_representation_study_tpu.ops import scatter as jax_scatter
from event_representation_study_tpu_torch.ops import scatter
from torch_port_helpers import assert_close

H, W = 240, 304
S = H * W
CAP = 4096


def _inputs(ev):
    """(x, y, t, p) padded to CAP, the mask, and float values: normalized
    time, polarity and a seeded normal column."""
    n = len(ev)
    pad = lambda a: np.pad(np.asarray(a, np.int32), (0, CAP - n))  # noqa: E731
    x, y, t, p = (pad(ev[k]) for k in ("x", "y", "t", "p"))
    mask = np.arange(CAP) < n
    t_s = (t / max(int(t[max(n - 1, 0)]), 1)).astype(np.float32)
    noise = np.random.default_rng(n).normal(size=CAP).astype(np.float32)
    return x, y, t, p, mask, {"t": t_s, "p": p.astype(np.float32), "noise": noise}


@pytest.fixture(params=["fixture", "empty"])
def inputs(request, fake_events):
    ev = fake_events if request.param == "fixture" else fake_events[:0]
    return _inputs(ev)


def _both(fn_name, *args, **kw):
    """(port result, JAX result) of one primitive on the same inputs."""
    got = getattr(scatter, fn_name)(*(torch.from_numpy(np.asarray(a)) if isinstance(a, np.ndarray)
                                      else a for a in args), **kw)
    want = getattr(jax_scatter, fn_name)(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                           for a in args), **kw)
    return got.numpy(), np.asarray(want)


def test_flat_pixel_index(inputs):
    x, y, *_ = inputs
    got, want = _both("flat_pixel_index", x, y, W)
    assert got.dtype == np.int32
    assert_close("flat_pixel_index", got, want, atol=0)


@pytest.mark.parametrize("fn", ["segment_sum", "segment_mean", "segment_max", "segment_min",
                                "segment_var"])
@pytest.mark.parametrize("col", ["t", "noise"])
def test_reductions(inputs, fn, col):
    x, y, t, p, mask, values = inputs
    seg = (y * W + x).astype(np.int32)
    sel = mask & (p > 0) if col == "t" else mask  # a selector, as the MDES channels use
    got, want = _both(fn, values[col], seg, sel, S)
    assert got.shape == (S,) and got.dtype == np.float32
    assert_close(f"{fn} of {col}", got, want, rtol=1e-6, atol=1e-6 if fn == "segment_var" else 0)


@pytest.mark.parametrize("zero_empty", [True, False])
def test_extrema_empty_fill(inputs, zero_empty):
    x, y, t, p, mask, values = inputs
    seg = (y * W + x).astype(np.int32)
    for fn in ("segment_max", "segment_min"):
        got, want = _both(fn, values["noise"], seg, mask, S, zero_empty=zero_empty)
        assert_close(f"{fn} zero_empty={zero_empty}", got, want, atol=0)


def test_counts_and_last(inputs):
    x, y, t, p, mask, values = inputs
    seg = (y * W + x).astype(np.int32)
    got, want = _both("segment_count", seg, mask, S)
    assert_close("segment_count", got, want, atol=0)
    got, want = _both("segment_last_pos", seg, mask, S)
    assert got.dtype == np.int32
    assert_close("segment_last_pos", got, want, atol=0)
    got, want = _both("scatter_last", values["p"], seg, mask, S)
    assert_close("scatter_last", got, want, atol=0)


@pytest.mark.parametrize("k", [1, 6])
def test_topk_recent(inputs, k):
    """TORE's top-k: positions and payloads of the k most recent qualifying
    events per (polarity, pixel) segment, empty slots -1 / fill."""
    x, y, t, p, mask, values = inputs
    n_seg = 2 * S
    seg = np.where(p > 0, y * W + x, S + y * W + x).astype(np.int32)
    order = np.arange(CAP, dtype=np.int32)
    qualifies = mask & (t < t[max(int(mask.sum()) - 1, 0)])
    got, want = _both("segment_topk_recent", order, seg, qualifies, n_seg, k)
    assert got.shape == (n_seg, k) and got.dtype == np.int32
    assert_close(f"segment_topk_recent k={k}", got, want, atol=0)
    got, want = _both("segment_topk_recent_values", order, seg, qualifies,
                      t.astype(np.float32), n_seg, k, -np.inf)
    assert_close(f"segment_topk_recent_values k={k}", got, want, atol=0)
