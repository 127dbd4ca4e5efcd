"""One whole train step with the event-space strong augmentation
(``aug_mode="event"``: ``reps/event_mosaic.py`` builds the augmented
ERGO-12 input in one segment-reduce) of the port against the JAX package's
``make_train_step(..., aug_mode="event")`` on the same converted random
weights, batch and plan (mosaic and mixup at 1.0), at 128 px on the shrunk
paper config, for an ATSS and a TAL epoch.

Bounds as in ``test_torch_port_train_step.py``: loss terms 1e-4 relative;
gradients and parameter updates 2e-2 of each leaf's scale (its largest JAX
entry plus 1e-3 of the largest over all leaves); positive anchors exact.
The optimizer starts past its warmup (update 1,500), so every group moves.

The sensor (96x128, 8,000 events a window) is at the frame's scale: the
event executor rasterizes points, so a sensor at half the frame's scale
fills at most a quarter of the output pixels, and on such sparse inputs the
float32 gradients of either framework stray from each other by several
times a leaf's scale (measured 4.1 at 48x64 with 1,500 events; two thread
counts of the port alone differ by 3e-2 there), so the comparison would
measure rounding.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from event_representation_study_tpu.data.augment import plan_augment_batch as jax_plan
from event_representation_study_tpu.events import from_structured as jax_from_structured
from event_representation_study_tpu.events import stack_blocks as jax_stack_blocks
from event_representation_study_tpu.models import build_model as jax_build_model
from event_representation_study_tpu.ops.warp import AugPlan as JaxAugPlan
from event_representation_study_tpu.parallel import train_step as jax_train_step
from event_representation_study_tpu.train import ema as jax_ema
from event_representation_study_tpu.train import losses as jax_losses
from event_representation_study_tpu.train import optim as jax_optim
from event_representation_study_tpu_torch.data.augment import plan_augment_batch
from event_representation_study_tpu_torch.events import (
    from_structured,
    generate_fake_events,
    stack_blocks,
)
from event_representation_study_tpu_torch.models import build_model
from event_representation_study_tpu_torch.ops.image import letterbox_labels
from event_representation_study_tpu_torch.ops.warp import AugPlan
from event_representation_study_tpu_torch.parallel.train_step import (
    Batch,
    TrainState,
    make_train_step,
)
from event_representation_study_tpu_torch.train.ema import ema_init
from event_representation_study_tpu_torch.train.losses import LossConfig
from event_representation_study_tpu_torch.train.optim import SolverConfig, build_optimizer
from event_representation_study_tpu_torch.utils.convert import flax_to_torch, to_flax_leaves
from test_torch_port_train_step import _flat, _leafwise, _with_grad_spy
from torch_port_helpers import assert_close, random_jax_variables, small_cfg

H, W = 96, 128
IMG, B, CAP, M = 128, 4, 8192, 16
SOLVER = dict(epochs=300, steps_per_epoch=1000)
START_UPDATE = 1500
EPOCHS = {"atss": 0, "tal": 5}


@pytest.fixture(scope="module")
def steps():
    cfg = small_cfg()
    jax_model = jax_build_model(cfg, num_classes=2)
    variables = random_jax_variables(jax_model, IMG)
    rng = np.random.default_rng(12)
    evs = [generate_fake_events(8000, H, W, 50_000, seed=40 + i) for i in range(B)]
    labels = []
    for _ in range(B):
        xywh = np.concatenate([rng.uniform(0.25, 0.75, (2, 2)), rng.uniform(0.15, 0.4, (2, 2))], 1)
        norm = np.concatenate([rng.integers(0, 2, (2, 1)), xywh], 1).astype(np.float32)
        labels.append(letterbox_labels(norm, H, W, IMG))
    hyp = dict(cfg["data_aug"], mosaic=1.0, mixup=1.0)
    plan, lab, nl = plan_augment_batch(labels, IMG, hyp, np.random.default_rng(9), M)
    plan_j, lab_j, _ = jax_plan(labels, IMG, hyp, np.random.default_rng(9), M)
    assert all(np.array_equal(plan[k], plan_j[k]) for k in plan) and np.array_equal(lab, lab_j)
    mask = (np.arange(M)[None] < nl[:, None]).astype(np.float32)

    tx_j = _with_grad_spy(jax_optim.build_optimizer(variables["params"],
                                                    jax_optim.SolverConfig(**SOLVER)))
    opt0 = tx_j.init(variables["params"])
    state_j = jax_train_step.TrainState(
        variables["params"], variables["batch_stats"],
        (opt0[0]._replace(count=jnp.int32(START_UPDATE)), opt0[1]),
        jax_ema.ema_init(variables), jnp.int32(0))
    step_j = jax_train_step.make_train_step(
        jax_model, jax_losses.LossConfig(2), tx_j, representation="OptimizedRepresentation",
        rep_hw=(H, W), img_size=IMG, donate=False, aug_mode="event")
    batch_j = jax_train_step.Batch(
        None, jax_stack_blocks([jax_from_structured(e, CAP) for e in evs]),
        lab[..., 0].astype(np.int32), lab[..., 1:5], mask,
        JaxAugPlan(**{k: jnp.asarray(v) for k, v in plan.items()}))

    step = make_train_step(LossConfig(2), "OptimizedRepresentation", (H, W), IMG,
                           aug_mode="event", device="cpu")
    batch = Batch(None, stack_blocks([from_structured(e, CAP) for e in evs]), lab[..., 0],
                  lab[..., 1:5], mask, AugPlan(**plan))
    model0 = build_model(cfg, 2, device="cpu")
    model0.load_state_dict(flax_to_torch(variables), strict=True)
    before = _flat(variables["params"], "params")

    out = {}
    for name, epoch in EPOCHS.items():
        new_j, parts_j = step_j(state_j, batch_j, epoch)
        want = {
            "grads": _flat(new_j.opt_state[1], "params"),
            "params": _flat(new_j.params, "params"),
            "parts": {k: float(v) for k, v in parts_j.items()},
        }
        model = copy.deepcopy(model0)
        opt = build_optimizer(model, SolverConfig(**SOLVER))
        opt.count = START_UPDATE
        state = TrainState(model, opt, ema_init(model), 0)
        state, parts = step(state, batch, epoch)
        got = {
            "grads": to_flax_leaves({n: p.grad for n, p in model.named_parameters()}),
            "params": to_flax_leaves(dict(model.named_parameters())),
            "parts": {k: float(v) for k, v in parts.items()},
        }
        out[name] = (got, want)
    return out, before, step, batch


@pytest.mark.parametrize("epoch", list(EPOCHS))
def test_event_aug_loss_terms(steps, epoch):
    got, want = steps[0][epoch]
    for k in ("loss", "cls", "iou", "dfl"):
        assert_close(f"event aug {k}", got["parts"][k], want["parts"][k], atol=0, rtol=1e-4)
    assert got["parts"]["num_pos"] == want["parts"]["num_pos"] > 0


@pytest.mark.parametrize("epoch", list(EPOCHS))
def test_event_aug_gradients_and_updates(steps, epoch):
    (got, want), before = steps[0][epoch], steps[1]
    assert set(got["grads"]) == set(want["grads"])
    assert_close("event aug gradients / leaf scale", *_leafwise(got["grads"], want["grads"]),
                 atol=2e-2)
    assert_close("event aug parameter update / leaf scale",
                 *_leafwise(got["params"], want["params"], minus=before), atol=2e-2)


def test_event_aug_images_are_the_mosaic(steps):
    """The step's model input is ``mosaic_event_rep(...)[:B] / 255``, and a
    batch without a plan takes ERGO-12 -> letterbox."""
    from event_representation_study_tpu_torch.parallel.train_step import batch_on_device
    from event_representation_study_tpu_torch.reps.event_mosaic import mosaic_event_rep

    _, _, step, batch = steps
    b = batch_on_device(batch, "cpu")
    want = mosaic_event_rep(b.events, b.aug, "OptimizedRepresentation", (H, W), IMG)[:B] / 255
    assert_close("images_of (event)", step.images_of(b).permute(0, 2, 3, 1).numpy(),
                 want.numpy(), atol=0)
    plain = step.images_of(b._replace(aug=None))
    assert plain.shape == (B, 12, IMG, IMG)


def test_event_aug_refuses_other_representations():
    with pytest.raises(ValueError, match="aug_mode='event'"):
        make_train_step(LossConfig(2), None, aug_mode="event", device="cpu")
