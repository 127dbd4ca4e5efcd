"""The port's fused segment reduce (plain PyTorch version, CPU) against the
JAX package's ``ops/pallas_scatter.py::fused_segment_reduce`` with its Pallas
kernels in interpret mode.

Tolerance: sums rtol=atol=2e-4 (the Pallas kernel sums by one-hot matmul,
the port in event order); max columns and count columns exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event_representation_study_tpu.ops.pallas_scatter import (
    fused_segment_reduce as jax_fused_segment_reduce,
)
from event_representation_study_tpu_torch.ops import fused_scatter
from event_representation_study_tpu_torch.ops.fused_scatter import (
    NEG_INF,
    fused_segment_reduce,
    sort_columns,
)
from torch_port_helpers import assert_close

S = 16 * 64  # 1024 pixels = 2 Pallas tiles
B, N = 2, 512


def _seg(case, rng):
    seg = rng.integers(0, S, size=(B, N))
    if case == "invalid":  # padding ids == S and stray ids far above it
        seg[:, -100:] = S
        seg[0, 10:30] = S + 7
        seg[1, 50:60] = 10 * S
    elif case == "empty":  # events in a few pixels only; most pixels empty
        seg = rng.choice(np.array([3, 4, 700, 1023]), size=(B, N))
    elif case == "hot":  # one pixel holds most events
        seg[:, : N - 40] = 517
        seg = np.stack([rng.permutation(r) for r in seg])
    return seg.astype(np.int32)


def _columns(xp, km):
    """columns_fn for either framework: 4 sum columns (value, value^2,
    count, masked value) and ``km`` max columns."""
    stack = (lambda c: jnp.stack(c, axis=1)) if xp is jnp else (lambda c: torch.stack(c, dim=1))

    def columns_fn(pos_s, a, b):
        m = (b > 0)
        mf = m.astype(jnp.float32) if xp is jnp else m.to(torch.float32)
        vs = stack([a, a * a, xp.ones_like(a), a * mf])
        if km == 0:
            return vs, None
        pos_f = pos_s.astype(jnp.float32) if xp is jnp else pos_s.to(torch.float32)
        vm = [xp.where(m, a, NEG_INF), b, pos_f][:km]
        return vs, stack(vm)

    return columns_fn


@pytest.mark.parametrize("km", [2, 3, 0], ids=lambda k: f"km{k}")
@pytest.mark.parametrize("case", ["random", "invalid", "empty", "hot"])
def test_plain_vs_pallas_interpret(case, km):
    rng = np.random.default_rng(10 * ["random", "invalid", "empty", "hot"].index(case) + km)
    seg = _seg(case, rng)
    a = rng.normal(size=(B, N)).astype(np.float32)
    b = rng.normal(size=(B, N)).astype(np.float32)

    want_s, want_m = jax_fused_segment_reduce(
        jnp.asarray(seg), (jnp.asarray(a), jnp.asarray(b)), _columns(jnp, km), S,
        interpret=True,
    )
    got_s, got_m = fused_segment_reduce(
        torch.from_numpy(seg), (torch.from_numpy(a), torch.from_numpy(b)),
        _columns(torch, km), S,
    )
    assert got_s.shape == (B, S, 4)
    assert_close("sums", got_s, want_s, rtol=2e-4, atol=2e-4)
    assert_close("count column", got_s[..., 2], np.asarray(want_s)[..., 2], atol=0)
    if km == 0:
        assert got_m is None and want_m is None
    else:
        assert got_m.shape == (B, S, km)
        assert_close("maxes", got_m, want_m, atol=0)


def test_sort_glue_offsets():
    """The CSR offsets bound every pixel's events in the stably sorted
    stream, and the sorted positions keep event order within a pixel."""
    rng = np.random.default_rng(5)
    seg = torch.from_numpy(_seg("invalid", rng))
    seen = {}

    def columns_fn(pos_s, a):
        seen["pos"] = pos_s
        return a[:, None], None

    seg_s, offs, vs, vm = sort_columns(seg, (seg.to(torch.float32),), columns_fn, S)
    assert offs.dtype == torch.int32 and offs.shape == (B, S + 1) and vm is None
    for bi in range(B):
        o = offs[bi].tolist()
        assert o[S] == int((seg[bi] < S).sum())
        for s in (0, 517, S - 1):
            assert torch.all(seg_s[bi, o[s]:o[s + 1]] == s)
            pos = seen["pos"][bi, o[s]:o[s + 1]]
            assert torch.all(pos[1:] > pos[:-1])
    torch.testing.assert_close(vs[:, 0], seg_s.to(torch.float32))


def test_wrapper_checks_inputs():
    seg_s = torch.zeros((B, N), dtype=torch.int32)
    offs = torch.zeros((B, S + 1), dtype=torch.int32)
    vs = torch.zeros((B, 4, N))
    with pytest.raises(ValueError, match="Ks"):
        fused_scatter.segment_reduce_sorted(seg_s, offs, torch.zeros((B, 33, N)), None, S)
    with pytest.raises(ValueError, match="Km"):
        fused_scatter.segment_reduce_sorted(seg_s, offs, vs, torch.zeros((B, 9, N)), S)
    with pytest.raises(ValueError, match="offs"):
        fused_scatter.segment_reduce_sorted(seg_s, offs.to(torch.int64), vs, None, S)
    with pytest.raises(ValueError, match="contiguous"):
        fused_scatter.segment_reduce_sorted(
            seg_s, offs, torch.zeros((B, N, 4)).transpose(1, 2), None, S
        )
    # the plain version on CPU tensors launches nothing
    fused_scatter.reset_launches()
    fused_scatter.segment_reduce_sorted(seg_s, offs, vs, None, S)
    assert fused_scatter.LAUNCHES == {fused_scatter.K1: 0, fused_scatter.K2: 0}
