"""The port's fused segment reduce (plain PyTorch version, CPU) against the
JAX package's ``ops/pallas_scatter.py::fused_segment_reduce`` with its Pallas
kernels in interpret mode.

Tolerance: sums rtol=atol=2e-4 (the Pallas kernel sums by one-hot matmul,
the port in event order); max columns and count columns exactly.
"""
import jax
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
N_UNALIGNED = 509  # N % 4 != 0: the kernel's 4-byte copy path
CASES = ["random", "invalid", "empty", "hot", "unaligned"]


def _seg(case, rng):
    seg = rng.integers(0, S, size=(B, N_UNALIGNED if case == "unaligned" else N))
    if case in ("invalid", "unaligned"):  # padding ids == S and stray ids far above it
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
@pytest.mark.parametrize("case", CASES)
def test_plain_vs_pallas_interpret(case, km):
    rng = np.random.default_rng(10 * CASES.index(case) + km)
    seg = _seg(case, rng)
    a = rng.normal(size=seg.shape).astype(np.float32)
    b = rng.normal(size=seg.shape).astype(np.float32)

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


@pytest.mark.parametrize("km", [12, 16, 20], ids=lambda k: f"km{k}")
def test_wide_max_columns(km):
    """Km = 12 (the event stack), 16 (the compiled limit) and 20 (two column
    groups, the second without a sum column of its own): the plain version
    against the Pallas kernel in interpret mode and against
    ``ops/scatter.py::segment_max`` column by column, exactly."""
    from event_representation_study_tpu_torch.ops import scatter

    rng = np.random.default_rng(km)
    seg = _seg("invalid", rng)
    a = rng.normal(size=seg.shape).astype(np.float32)

    def columns(xp):
        stack = (lambda c: jnp.stack(c, axis=1)) if xp is jnp else (lambda c: torch.stack(c, dim=1))

        def columns_fn(pos_s, a_s):
            pos_f = pos_s.astype(jnp.float32) if xp is jnp else pos_s.to(torch.float32)
            # column k keeps the events past position 32 k, as the stack's suffixes
            vm = [xp.where(pos_s >= 32 * k, a_s + pos_f / 1024, NEG_INF) for k in range(km)]
            return stack([xp.ones_like(a_s)]), stack(vm)

        return columns_fn

    want_s, want_m = jax_fused_segment_reduce(jnp.asarray(seg), (jnp.asarray(a),), columns(jnp), S,
                                              interpret=True)
    got_s, got_m = fused_segment_reduce(torch.from_numpy(seg), (torch.from_numpy(a),),
                                        columns(torch), S)
    assert got_m.shape == (B, S, km)
    assert_close(f"km={km} maxes vs Pallas interpret", got_m, want_m, atol=0)
    assert_close(f"km={km} counts vs Pallas interpret", got_s, want_s, atol=0)
    pos = torch.arange(N, dtype=torch.float32)
    for b in range(B):
        for k in range(km):
            valid = (torch.from_numpy(seg[b]) < S) & (pos >= 32 * k)
            oracle = scatter.segment_max(torch.from_numpy(a[b]) + pos / 1024,
                                         torch.from_numpy(seg[b]), valid, S, zero_empty=False)
            assert torch.equal(torch.where(got_m[b, :, k] <= NEG_INF / 2, -torch.inf,
                                           got_m[b, :, k]), oracle), (b, k)


def test_sort_glue_offsets():
    """``sort_columns`` orders ids and events as the JAX package's two-key
    ``lax.sort`` on (segment, position) does (``pallas_scatter.py:173``):
    stable within a pixel (the hot case: most events in one pixel), padding
    ids last (the invalid case), carry streams riding along."""
    rng = np.random.default_rng(5)
    for case in ("invalid", "hot"):
        seg = _seg(case, rng)
        pos = np.broadcast_to(np.arange(N, dtype=np.int32), (B, N))
        carry = rng.normal(size=(B, N)).astype(np.float32)
        want_seg, want_pos, want_carry = jax.lax.sort(
            (jnp.asarray(seg), jnp.asarray(pos), jnp.asarray(carry)), num_keys=2,
            is_stable=False,
        )
        seen = {}

        def columns_fn(pos_s, c):
            seen["pos"] = pos_s
            return c[:, None], None

        seg_s, vs, vm = sort_columns(torch.from_numpy(seg), (torch.from_numpy(carry),),
                                     columns_fn)
        assert seg_s.dtype == torch.int32 and seen["pos"].dtype == torch.int32 and vm is None
        assert_close(f"{case}: sorted ids", seg_s, want_seg, atol=0)
        assert_close(f"{case}: sorted positions", seen["pos"], want_pos, atol=0)
        assert_close(f"{case}: sorted carry", vs[:, 0], want_carry, atol=0)


@pytest.mark.parametrize("ks,km", [(36, 0), (40, 3), (33, 17)], ids=lambda v: str(v))
def test_wide_tables_vs_pallas_interpret(ks, km):
    """More columns than the kernel's compiled 32 sums / 16 maxes, which the
    JAX kernel takes in one call: the port reduces column groups over the
    same sorted ids and concatenates them. Sums rtol 2e-4, maxes exact."""
    rng = np.random.default_rng(ks + km)
    seg = _seg("invalid", rng)
    a = rng.normal(size=seg.shape).astype(np.float32)

    def columns(xp):
        stack = (lambda c: jnp.stack(c, axis=1)) if xp is jnp else (lambda c: torch.stack(c, dim=1))

        def columns_fn(pos_s, a_s):
            pos_f = pos_s.astype(jnp.float32) if xp is jnp else pos_s.to(torch.float32)
            vs = stack([a_s * (k + 1) + pos_f / 512 for k in range(ks)])
            if not km:
                return vs, None
            return vs, stack([xp.where(pos_s >= 16 * k, a_s - k, NEG_INF) for k in range(km)])

        return columns_fn

    want_s, want_m = jax_fused_segment_reduce(jnp.asarray(seg), (jnp.asarray(a),), columns(jnp), S,
                                              interpret=True)
    got_s, got_m = fused_segment_reduce(torch.from_numpy(seg), (torch.from_numpy(a),),
                                        columns(torch), S)
    assert got_s.shape == (B, S, ks)
    assert_close(f"Ks={ks} sums vs Pallas interpret", got_s, want_s, rtol=2e-4, atol=2e-4)
    if km:
        assert got_m.shape == (B, S, km)
        assert_close(f"Km={km} maxes vs Pallas interpret", got_m, want_m, atol=0)
    else:
        assert got_m is None and want_m is None


def test_column_groups():
    """Tables within the compiled limits stay one launch (ERGO-12, the
    widest, the narrowest); wider ones split as evenly as the limits allow."""
    groups = fused_scatter.column_groups
    for ks, km in [(18, 3), (18, 0), (32, 16), (1, 12), (1, 0)]:
        assert groups(ks, km) == [(range(ks), range(km))]
    assert groups(36, 0) == [(range(0, 18), range(0, 0)), (range(18, 36), range(0, 0))]
    assert groups(33, 1) == [(range(0, 17), range(0, 1)), (range(17, 33), range(1, 1))]
    assert groups(1, 20) == [(range(0, 1), range(0, 10)), (range(1, 1), range(10, 20))]
    assert len(groups(65, 0)) == 3 and len(groups(2, 33)) == 3


def test_wrapper_checks_inputs():
    seg_s = torch.zeros((B, N), dtype=torch.int32)
    vs = torch.zeros((B, 4, N))
    with pytest.raises(ValueError, match="Ks"):
        fused_scatter.segment_reduce_sorted(seg_s, torch.zeros((B, 0, N)), None, S)
    with pytest.raises(ValueError, match="vm"):
        fused_scatter.segment_reduce_sorted(seg_s, vs, torch.zeros((B, 17, N - 1)), S)
    with pytest.raises(ValueError, match="seg_s"):
        fused_scatter.segment_reduce_sorted(seg_s.to(torch.int64), vs, None, S)
    with pytest.raises(ValueError, match="seg_s"):
        fused_scatter.segment_reduce_sorted(seg_s[:, :-1], vs, None, S)
    with pytest.raises(ValueError, match="contiguous"):
        fused_scatter.segment_reduce_sorted(
            seg_s, torch.zeros((B, N, 4)).transpose(1, 2), None, S
        )
    # the plain version on CPU tensors launches nothing
    fused_scatter.reset_launches()
    fused_scatter.segment_reduce_sorted(seg_s, vs, None, S)
    assert fused_scatter.LAUNCHES == {fused_scatter.K1: 0, fused_scatter.K2: 0}
