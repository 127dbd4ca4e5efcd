"""The port's representation library (``reps/``: histogram, voxel grid, event
stack, time surface, TORE, MDES/ERGO-12, the fused batched forms and the
dispatcher) against the JAX package's on the same NumPy inputs.

- per sample (``build_representation``, ``get_item_transform``): the
  conftest streams at 240x304 against JAX's jitted per-sample function;
  ``reps/numpy_ref.py`` is a second oracle for the MDES grid;
- batched (``batched_representation``, ``fused_reps.*``): a ragged batch with
  an empty window at 32x64 against JAX's ``batched_representation`` on the
  CPU (its per-sample function, mapped) and against JAX's fused functions with
  their Pallas kernels in interpret mode.

Tolerances (values x255 where the dispatcher scales): histogram, event
stack, TORE slots and counts exact; time surface and TORE rtol 1e-6 (exp and
log of equal inputs); voxel grid rtol 1e-5 + atol 1e-3 (the fused form
sums each event's two halves before the pixel sum, the per-sample form sums
them apart; the Pallas kernel sums by matmul); MDES/ERGO-12 rtol = atol =
2e-4 (x255: atol 0.05), as ``test_torch_port_ergo12.py``.
"""
import jax
import numpy as np
import pytest
import torch

from event_representation_study_tpu.events import from_structured as jax_from_structured
from event_representation_study_tpu.events import stack_blocks as jax_stack_blocks
from event_representation_study_tpu.reps import dispatch as jax_dispatch
from event_representation_study_tpu.reps import fused_reps as jax_fused_reps
from event_representation_study_tpu.reps import numpy_ref
from event_representation_study_tpu.reps.mdes import (
    mixed_density_event_stack as jax_mixed_density_event_stack,
)
from event_representation_study_tpu_torch.events import (
    EventBlock,
    from_structured,
    generate_fake_events,
    stack_blocks,
)
from event_representation_study_tpu_torch.ops import fused_scatter
from event_representation_study_tpu_torch.reps import (
    REPRESENTATION_CHANNELS,
    batched_representation,
    build_representation,
    fused_reps,
    get_item_transform,
    mixed_density_event_stack,
)
from event_representation_study_tpu_torch.reps.mdes import AGGREGATIONS, FUNCTIONS
from torch_port_helpers import assert_close

H, W, CAP = 240, 304, 4096
SH, SW, SCAP = 32, 64, 1024  # the batched cases: 2048 pixels, 4 Pallas tiles
NAMES = ["VoxelGrid", "MixedDensityEventStack", "OptimizedRepresentation", "EventStack",
         "EventHistogram", "TORE", "TimeSurface"]
# name -> (rtol, atol) of the port against JAX, on the x255 scale
TOL = {
    "VoxelGrid": (1e-5, 1e-3),
    "MixedDensityEventStack": (2e-4, 0.05),
    "OptimizedRepresentation": (2e-4, 0.05),
    "EventStack": (0, 0),
    "EventHistogram": (0, 0),
    "TORE": (1e-6, 1e-6),
    "TimeSurface": (1e-6, 1e-6),
}
# the kernel each batched function launches on a CUDA tensor: (Ks, Km), Km=0 is K2
KERNEL_WIDTHS = {"VoxelGrid": (12, 0), "MixedDensityEventStack": (18, 3),
                 "OptimizedRepresentation": (18, 3), "EventStack": (1, 12),
                 "EventHistogram": (2, 0), "TORE": None, "TimeSurface": (1, 6)}


def _jax_per_sample(name, ev, h, w, cap):
    return np.asarray(jax_dispatch._build_jit(name, jax_from_structured(ev, cap), h, w))


@pytest.mark.parametrize("name", NAMES)
def test_build_representation(name, fake_events):
    got = build_representation(name, from_structured(fake_events, CAP), H, W).numpy()
    want = _jax_per_sample(name, fake_events, H, W, CAP)
    assert got.shape == (H, W, REPRESENTATION_CHANNELS[name]) and got.dtype == np.float32
    assert_close(f"{name} per sample", got, want, *TOL[name][::-1])


@pytest.fixture(scope="module")
def ragged():
    """Three windows at 32x64: 700 events, 250 events and an empty one."""
    evs = [generate_fake_events(n, height=SH, width=SW, duration_us=80_000, seed=s)
           for n, s in [(700, 31), (250, 32), (0, 33)]]
    return evs, stack_blocks([from_structured(e, SCAP) for e in evs])


@pytest.mark.parametrize("name", NAMES)
def test_batched_representation(name, ragged, monkeypatch):
    """The batched function against JAX's; it runs the kernel of its name
    once (its plain version here), TORE none."""
    evs, blocks = ragged
    widths = []
    real = fused_scatter.segment_reduce_sorted

    def spy(seg_s, vs, vm, num_segments):
        widths.append((vs.shape[1], 0 if vm is None else vm.shape[1]))
        return real(seg_s, vs, vm, num_segments)

    monkeypatch.setattr(fused_scatter, "segment_reduce_sorted", spy)
    fused_scatter.reset_launches()
    got = batched_representation(name, SH, SW)(blocks).numpy()
    assert widths == ([] if KERNEL_WIDTHS[name] is None else [KERNEL_WIDTHS[name]])
    assert fused_scatter.LAUNCHES == {fused_scatter.K1: 0, fused_scatter.K2: 0}  # CPU: plain
    want = np.asarray(jax_dispatch.batched_representation(name, SH, SW)(
        jax_stack_blocks([jax_from_structured(e, SCAP) for e in evs])))
    assert got.shape == (3, SH, SW, REPRESENTATION_CHANNELS[name])
    assert_close(f"{name} batched", got, want, *TOL[name][::-1])


FUSED = {
    "histogram_fused_batched": "EventHistogram",
    "voxel_grid_fused_batched": "VoxelGrid",
    "event_stack_fused_batched": "EventStack",
    "time_surface_fused_batched": "TimeSurface",
}


@pytest.mark.parametrize("fn", list(FUSED))
def test_fused_vs_pallas_interpret(fn, ragged):
    evs, blocks = ragged
    got = getattr(fused_reps, fn)(blocks, SH, SW).numpy()
    want = np.asarray(getattr(jax_fused_reps, fn)(
        jax_stack_blocks([jax_from_structured(e, SCAP) for e in evs]), SH, SW, interpret=True))
    rtol, atol = TOL[FUSED[fn]]
    assert_close(f"{fn} vs Pallas interpret", got, want, rtol=rtol, atol=atol / 255)


@pytest.mark.parametrize("name", ["ToVoxelGrid", "MixedDensityEventStack", "EventStack",
                                  "ToImage", "TORE", "ToTimesurface"])
def test_get_item_transform(name, monkeypatch):
    """The reference-signature host API, TORE on its dynamic bounding-box
    frame (a capacity of CAP shares JAX's compiles with the tests above;
    JAX's TORE branch runs eagerly, so it is jitted here: the same
    arithmetic, one compile instead of one per operation)."""
    monkeypatch.setattr(jax_dispatch, "tore", jax.jit(jax_dispatch.tore, static_argnums=(1, 2),
                                                      static_argnames="k"))
    ev = generate_fake_events(1500, height=H, width=W, duration_us=400_000, seed=41)
    if name == "TORE":  # a stream away from the origin: the frame is cropped
        ev["x"] = ev["x"] // 2 + 40
        ev["y"] = ev["y"] // 3 + 17
    got = get_item_transform(ev, name, None, H, W, num_events=CAP, device="cpu")
    want = np.asarray(jax_dispatch.get_item_transform(ev, name, None, H, W, num_events=CAP))
    if name == "TORE":
        assert got.shape == (ev["y"].max() - 17 + 1, ev["x"].max() - 40 + 1, 12)
    tol = TOL.get(name, TOL[{"ToVoxelGrid": "VoxelGrid", "ToImage": "EventHistogram",
                             "ToTimesurface": "TimeSurface"}.get(name, name)])
    assert_close(f"{name} get_item_transform", got, want, *tol[::-1])


@pytest.mark.parametrize("stacking", ["SBN", "SBT"])
def test_mdes_all_funcs_aggs(stacking):
    """Every (window, function, aggregation) once (the grid of
    tests/test_reps_parity.py), per sample, against JAX and numpy_ref."""
    h, w = 120, 152
    ev = generate_fake_events(2500, height=h, width=w, seed=3)
    n_windows = 8 if stacking == "SBT" else 7
    windows, funcs, aggs = [], [], []
    for wi in range(n_windows):
        for i, f in enumerate(FUNCTIONS):
            windows.append(wi)
            funcs.append(f)
            aggs.append(AGGREGATIONS[(wi + i) % len(AGGREGATIONS)])
    got = mixed_density_event_stack(from_structured(ev, 4096), h, w, windows, funcs, aggs,
                                    stacking).numpy()
    want = np.asarray(jax_mixed_density_event_stack(
        jax_from_structured(ev, 4096), h, w, windows, funcs, aggs, stacking))
    assert_close(f"MDES {stacking} grid vs JAX", got, want, rtol=2e-4, atol=2e-4)
    assert_close(f"MDES {stacking} grid vs numpy_ref", got,
                 numpy_ref.mdes_np(ev, h, w, windows, funcs, aggs, stacking), rtol=2e-4, atol=2e-4)


def test_names_and_limits():
    blocks = stack_blocks([from_structured(generate_fake_events(50, SH, SW, seed=1), 64)])
    with pytest.raises(ValueError, match="unknown representation"):
        batched_representation("NoSuchRep", SH, SW)
    with pytest.raises(ValueError, match="unknown representation"):
        build_representation("LearnedRepresentation", blocks, SH, SW)
    # 2*pos + [p>0] is exact in float32 only up to 2^22 events
    n = 2**22 + 4
    zeros = torch.zeros((1, n), dtype=torch.int32)
    big = EventBlock(zeros, zeros, zeros, zeros, torch.tensor([n], dtype=torch.int32))
    with pytest.raises(ValueError, match="2\\*pos"):
        fused_reps.event_stack_fused_batched(big, SH, SW)
