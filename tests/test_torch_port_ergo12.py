"""The port's batched MDES / ERGO-12 (plain segment reduce on the CPU)
against the JAX package's fused Pallas builder in interpret mode and the
golden NumPy semantics of ``reps/numpy_ref.py``, on the cases of
``tests/test_fused_mdes.py`` at the same tolerance (2e-4: float32 sums in
another order, float64 in the NumPy reference)."""
import numpy as np
import pytest
import torch

from event_representation_study_tpu.events import from_structured as jax_from_structured
from event_representation_study_tpu.events import stack_blocks as jax_stack_blocks
from event_representation_study_tpu.reps import numpy_ref
from event_representation_study_tpu.reps.fused_mdes import (
    mdes_fused_batched as jax_mdes_fused_batched,
)
from event_representation_study_tpu_torch.events import (
    EventBlock,
    from_structured,
    generate_fake_events,
    stack_blocks,
)
from event_representation_study_tpu_torch.reps import (
    batched_representation,
    ergo12_fused_batched,
    mdes_fused_batched,
)
from event_representation_study_tpu_torch.reps.ergo12 import (
    AGGREGATIONS,
    FUNCTIONS,
    WINDOW_INDEXES,
)
from torch_port_helpers import assert_close

H, W = 16, 64
CAP = 512

CASES = {
    "ergo12": ([400, 210], [0, 1], WINDOW_INDEXES, FUNCTIONS, AGGREGATIONS, "SBN"),
    "all_aggs": (
        [300, 350], [2, 3], (0, 2, 5, 6, 1, 3, 4),
        ("count", "timestamp", "polarity", "timestamp_neg", "count_pos",
         "timestamp_pos", "count_neg"),
        ("sum", "max", "variance", "mean", "sum", "max", "mean"), "SBN",
    ),
    "sbt": (
        [380, 260], [4, 5], (0, 1, 2, 3, 4, 5, 6, 7),
        ("count", "timestamp", "polarity", "count_pos", "timestamp_neg",
         "count_neg", "timestamp_pos", "timestamp"),
        ("sum", "max", "variance", "mean", "mean", "sum", "max", "variance"), "SBT",
    ),
    "tiny_empty_windows": ([6, 40], [4, 5], (6, 0), ("count", "count"), ("sum", "sum"), "SBN"),
    # wider than the kernel's 32 sum columns: 12 variances of distinct
    # (function, window) need 36 sum columns, reduced in two column groups
    "variance_ks36": (
        [420, 330], [8, 9], (0, 1, 2, 3, 4, 5, 6, 0, 1, 2, 3, 4),
        ("timestamp",) * 7 + ("timestamp_pos",) * 5, ("variance",) * 12, "SBN",
    ),
    # 33 sum columns and a max column: a K1 group and a K2 group on the card
    "variance_ks33_km1": (
        [390, 280], [10, 11], (0, 1, 2, 3, 4, 5, 6, 0, 1, 2, 3, 5),
        ("timestamp",) * 7 + ("polarity",) * 4 + ("timestamp_neg",),
        ("variance",) * 11 + ("max",), "SBN",
    ),
    "zero_span": ([1, 0], [6, 7], WINDOW_INDEXES, FUNCTIONS, AGGREGATIONS, "SBN"),
}


def _events(sizes, seeds):
    return [
        generate_fake_events(n, height=H, width=W, duration_us=50_000, seed=s)
        for n, s in zip(sizes, seeds)
    ]


@pytest.mark.parametrize("case", list(CASES))
def test_mdes_vs_pallas_interpret_and_numpy(case):
    sizes, seeds, windows, funcs, aggs, stacking = CASES[case]
    evs = _events(sizes, seeds)
    got = mdes_fused_batched(
        stack_blocks([from_structured(e, CAP) for e in evs]), H, W,
        tuple(windows), tuple(funcs), tuple(aggs), stacking,
    ).numpy()
    want = np.asarray(jax_mdes_fused_batched(
        jax_stack_blocks([jax_from_structured(e, CAP) for e in evs]), H, W,
        tuple(windows), tuple(funcs), tuple(aggs), stacking, interpret=True,
    ))
    assert got.shape == (len(evs), H, W, len(windows)) and got.dtype == np.float32
    assert_close("vs Pallas interpret", got, want, rtol=2e-4, atol=2e-4)
    for i, ev in enumerate(evs):
        if len(ev) == 0:  # the NumPy reference takes no empty stream
            assert not got[i].any()
            continue
        ref = numpy_ref.mdes_np(ev, H, W, windows, funcs, aggs, stacking)
        assert_close(f"window {i} vs numpy_ref", got[i], ref, rtol=2e-4, atol=2e-4)


def test_max_only_table_vs_numpy():
    """A table of max channels only, as a channel search's first candidate
    can be: the JAX fused function stacks an empty list of sum columns and
    raises; the port reduces a zero sum column that no channel reads.
    Against the golden NumPy semantics (2e-4)."""
    windows, funcs, aggs = (0, 4), ("timestamp", "timestamp_neg"), ("max", "max")
    evs = _events([400, 210], [12, 13])
    got = mdes_fused_batched(stack_blocks([from_structured(e, CAP) for e in evs]), H, W,
                             windows, funcs, aggs).numpy()
    for i, ev in enumerate(evs):
        ref = numpy_ref.mdes_np(ev, H, W, windows, funcs, aggs, "SBN")
        assert_close(f"window {i} vs numpy_ref", got[i], ref, rtol=2e-4, atol=2e-4)


def test_ergo12_gen1_fixtures(fake_events, gen1_shape):
    """ERGO-12 at the Gen1 sensor size on the shared conftest streams."""
    h, w = gen1_shape
    block = stack_blocks([from_structured(fake_events, 4096)])
    got = ergo12_fused_batched(block, h, w)[0].numpy()
    assert_close("vs numpy_ref", got, numpy_ref.ergo12_np(fake_events, h, w),
                 rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", ["OptimizedRepresentation", "MixedDensityEventStack", "ERGO12"])
def test_dispatch_wire_format(name):
    """batched_representation = ERGO-12 x 255, and a compact wire block
    (x/y int16, p int8) gives the same result as its int32 form."""
    evs = _events([300, 120], [8, 9])
    block = stack_blocks([from_structured(e, CAP) for e in evs])
    wire = EventBlock(block.x.to(torch.int16), block.y.to(torch.int16), block.t,
                      block.p.to(torch.int8), block.num)
    fn = batched_representation(name, H, W)
    want = ergo12_fused_batched(block, H, W) * 255.0
    torch.testing.assert_close(fn(block), want, rtol=0, atol=0)
    torch.testing.assert_close(fn(wire), want, rtol=0, atol=0)
