"""The event-space strong augmentation of the port
(``reps/event_mosaic.py::mosaic_event_rep``) against the JAX package's, Pallas
in interpret mode, on the same event blocks and plans: ERGO-12 (under three
of its names) and EventHistogram, with an identity plan, mosaic + mixup +
flips, and a plan whose mixup partners include partner-pool rows.

The event destinations (``seg``, the pixel each transformed event lands on,
or the drop id) must be equal; the images agree within 1e-3 on the 0..255
scale (float32 sums of the timestamp columns in another order)."""
import jax
import numpy as np
import pytest
import torch

from event_representation_study_tpu.data.augment import plan_augment_batch as jax_plan
from event_representation_study_tpu.events.core import EventBlock as JaxEventBlock
from event_representation_study_tpu.ops.warp import AugPlan as JaxAugPlan
from event_representation_study_tpu.ops.warp import identity_plan as jax_identity_plan
from event_representation_study_tpu.reps import event_mosaic as jax_event_mosaic
from event_representation_study_tpu_torch.data.augment import plan_augment_batch
from event_representation_study_tpu_torch.events.core import EventBlock
from event_representation_study_tpu_torch.ops import fused_scatter
from event_representation_study_tpu_torch.ops.warp import AugPlan, identity_plan
from event_representation_study_tpu_torch.reps.event_mosaic import (
    mosaic_event_rep,
    supports_event_mosaic,
)
from torch_port_helpers import assert_close, small_cfg

HW, S, B, POOL, E = (48, 60), 72, 4, 2, 384  # a non-square sensor: letterbox bands


def _blocks():
    """B + POOL rows of sorted-time events; the last row has a zero time
    span (renders as an empty tile)."""
    P = B + POOL
    rng = np.random.default_rng(0)
    num = rng.integers(E // 2, E + 1, P).astype(np.int32)
    ev = dict(
        x=rng.integers(0, HW[1], (P, E)).astype(np.int32),
        y=rng.integers(0, HW[0], (P, E)).astype(np.int32),
        t=np.sort(rng.integers(0, 100_000, (P, E)), axis=1).astype(np.int32),
        p=rng.choice(np.array([-1, 1], np.int32), (P, E)),
        num=num,
    )
    ev["t"][-1] = 7
    return ev


def _plan(kind):
    """NumPy plan arrays of ``kind``."""
    if kind == "identity":
        return identity_plan(B, S)._asdict()
    hyp = dict(small_cfg()["data_aug"], mosaic=1.0, mixup=1.0, fliplr=0.5, flipud=0.5)
    P = B + POOL if kind == "pool" else B
    labels = [np.zeros((0, 5), np.float32)] * P
    plan, _, _ = plan_augment_batch(labels, S, hyp, np.random.default_rng(3), 8, n_out=B)
    want, _, _ = jax_plan(labels, S, hyp, np.random.default_rng(3), 8, n_out=B)
    assert all(np.array_equal(plan[k], want[k]) for k in plan)
    if kind == "pool":
        assert (plan["mix_idx"][:B] >= B).any(), "no mixup partner from the pool"
    else:
        assert (plan["mix_r"] < 1).all() and (plan["fwd_affine"][:, 0, 0] < 0).any()
    return plan


CASES = [("ERGO12", "identity"), ("ERGO12", "mosaic_mixup_flip"),
         ("OptimizedRepresentation", "pool"), ("MixedDensityEventStack", "mosaic_mixup_flip"),
         ("EventHistogram", "identity"), ("EventHistogram", "pool")]


def _jax_run(ev, plan, rep):
    """JAX images and the seg its fused segment-reduce received."""
    seen = []
    real = jax_event_mosaic.fused_segment_reduce

    def spy(seg, *args, **kw):
        jax.debug.callback(lambda s: seen.append(np.asarray(s)), seg)
        return real(seg, *args, **kw)

    jax.clear_caches()  # trace anew, so the spy is in the program
    jax_event_mosaic.fused_segment_reduce = spy
    try:
        img = jax_event_mosaic.mosaic_event_rep(
            JaxEventBlock(**{k: jax.numpy.asarray(v) for k, v in ev.items()}),
            JaxAugPlan(**{k: jax.numpy.asarray(v) for k, v in plan.items()}),
            rep, HW, S, interpret=True)
        img = np.asarray(img)
    finally:
        jax_event_mosaic.fused_segment_reduce = real
    assert len(seen) == 1
    return img, seen[0]


def _port_run(ev, plan, rep):
    seen = []
    real = fused_scatter.sort_columns

    def spy(seg, *args):
        seen.append(seg.numpy().copy())
        return real(seg, *args)

    fused_scatter.sort_columns = spy
    try:
        img = mosaic_event_rep(EventBlock(**{k: torch.from_numpy(v) for k, v in ev.items()}),
                               AugPlan(**plan).to("cpu"), rep, HW, S)
    finally:
        fused_scatter.sort_columns = real
    assert len(seen) == 1
    return img.numpy(), seen[0]


@pytest.mark.parametrize("rep,kind", CASES, ids=[f"{r}-{k}" for r, k in CASES])
def test_mosaic_event_rep_like_jax(rep, kind):
    ev, plan = _blocks(), _plan(kind)
    got, got_seg = _port_run(ev, plan, rep)
    want, want_seg = _jax_run(ev, plan, rep)
    rows = plan["src_idx"].shape[0]
    channels = 2 if rep == "EventHistogram" else 12
    assert got.shape == want.shape == (rows, S, S, channels)
    assert_close(f"{rep} {kind} seg", got_seg, want_seg, atol=0)
    assert (got_seg < S * S).mean() > 0.05  # events land in the frame
    assert_close(f"{rep} {kind} image (0..255)", got, want, atol=1e-3)
    assert np.isfinite(got).all() and (got == 114.0).any()


def test_unsupported_representation():
    assert supports_event_mosaic("MixedDensityEventStack_v3")
    assert not supports_event_mosaic("VoxelGrid")
    ev, plan = _blocks(), _plan("identity")
    with pytest.raises(ValueError, match="aug_mode='image'"):
        mosaic_event_rep(EventBlock(**{k: torch.from_numpy(v) for k, v in ev.items()}),
                         AugPlan(**plan).to("cpu"), "VoxelGrid", HW, S)
    with pytest.raises(ValueError, match="fwd_affine"):
        mosaic_event_rep(EventBlock(**{k: torch.from_numpy(v) for k, v in ev.items()}),
                         AugPlan(**plan).to("cpu")._replace(fwd_affine=None), "ERGO12", HW, S)


def test_identity_plan_matches_jax_identity():
    """The port's identity plan is the JAX package's, leaf for leaf."""
    got, want = identity_plan(B, S), jax_identity_plan(B, S)
    for k in want._fields:
        assert_close(f"identity_plan.{k}", np.asarray(getattr(got, k)),
                     np.asarray(getattr(want, k)), atol=0)
