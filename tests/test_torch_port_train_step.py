"""One whole train step of the port against the JAX package's
``parallel/train_step.py::make_train_step(..., warp_impl="separable")``:
fake Gen1-style windows -> ERGO-12 -> letterbox -> mosaic + affine + flip +
mixup (the paper recipe with mosaic and mixup at 1.0) -> detector -> ATSS
(epoch 0) or TAL (epoch 5) -> loss -> backward -> SGD -> EMA, from the same
converted random weights, on the shrunk paper config.

The frame is 128 px. At 64 px the stride-64 level is 1x1, so its
BatchNorms see 4 values a channel and the step is ill-conditioned: the
float32 gradients of either framework stray far from a float64 run of the
same step, and the comparison would measure rounding.

The optimizer starts at update 1,500, past the 1,000-update warmup, so
every group moves (at update 0 the weight and BN learning rates are 0); the
EMA starts from perturbed weights at update 3,000, so its blend is neither
~0 nor ~1.

Tolerances (gradients, update deltas and EMA deltas are compared per leaf,
each divided by its largest JAX entry plus 1e-3 of the largest over all
leaves, so that leaves whose exact gradient is ~0, such as biases ahead of
a BatchNorm, compare against the step's scale): loss terms 1e-4 relative;
gradients, parameter updates and EMA changes 2e-2 (measured up to 7.5e-3:
a leaf's gradient sums over the whole batch through train-mode BatchNorms,
and XLA's and oneDNN's float32 convolutions round differently); BatchNorm
statistics 2e-3 relative; positive-anchor counts exact.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

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
from event_representation_study_tpu_torch.ops.warp import AugPlan, compose_warp
from event_representation_study_tpu_torch.parallel.train_step import (
    Batch,
    TrainState,
    batch_on_device,
    init_train_state,
    make_eval_step,
    make_train_step,
)
from event_representation_study_tpu_torch.train.ema import EMAState
from event_representation_study_tpu_torch.train.losses import LossConfig
from event_representation_study_tpu_torch.train.optim import SolverConfig, build_optimizer
from event_representation_study_tpu_torch.utils.convert import flax_to_torch, to_flax_leaves
from torch_port_helpers import assert_close, random_jax_variables, small_cfg

H = W = 64
IMG, B, CAP, M = 128, 4, 2048, 16
SOLVER = dict(epochs=300, steps_per_epoch=1000)
START_UPDATE, EMA_UPDATES = 1500, 3000
EPOCHS = {"atss": 0, "tal": 5}


def _flat(tree, prefix):
    return {prefix + "/" + "/".join(k.key for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _with_grad_spy(tx):
    """Wrap an optax transform so its state also carries the last
    gradients it was given."""
    def init(params):
        return tx.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        upd, inner = tx.update(grads, state[0], params)
        return upd, (inner, grads)

    return optax.GradientTransformation(init, update)


@pytest.fixture(scope="module")
def steps():
    """Both packages' step from the same state and batch at each epoch:
    {epoch name: (port, jax)} with (grads, params before/after, batch
    stats, EMA before/after, parts) as flat Flax-path dicts."""
    cfg = small_cfg()
    jax_model = jax_build_model(cfg, num_classes=2)
    variables = random_jax_variables(jax_model, IMG)
    rng = np.random.default_rng(11)
    ema_vars = jax.tree.map(lambda a: (a + rng.normal(0, 0.05, a.shape)).astype(np.float32),
                            variables)
    evs = [generate_fake_events(1500, H, W, 50_000, seed=30 + i) for i in range(B)]
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
        jax_ema.EMAState(ema_vars, jnp.int32(EMA_UPDATES)), jnp.int32(0))
    step_j = jax_train_step.make_train_step(
        jax_model, jax_losses.LossConfig(2), tx_j, representation="OptimizedRepresentation",
        rep_hw=(H, W), img_size=IMG, donate=False, warp_impl="separable")
    batch_j = jax_train_step.Batch(
        None, jax_stack_blocks([jax_from_structured(e, CAP) for e in evs]),
        lab[..., 0].astype(np.int32), lab[..., 1:5], mask,
        JaxAugPlan(**{k: jnp.asarray(v) for k, v in plan.items()}))

    step = make_train_step(LossConfig(2), "OptimizedRepresentation", (H, W), IMG,
                           warp_impl="separable", device="cpu")
    batch = Batch(None, stack_blocks([from_structured(e, CAP) for e in evs]), lab[..., 0],
                  lab[..., 1:5], mask, AugPlan(**plan))
    model0 = build_model(cfg, 2, device="cpu")
    model0.load_state_dict(flax_to_torch(variables), strict=True)
    ema0 = {k: v for k, v in flax_to_torch(ema_vars).items() if v.is_floating_point()}
    before = {**_flat(variables["params"], "params"), **_flat(ema_vars, "ema")}

    out = {}
    for name, epoch in EPOCHS.items():
        new_j, parts_j = step_j(state_j, batch_j, epoch)
        want = {
            "grads": _flat(new_j.opt_state[1], "params"),
            "params": _flat(new_j.params, "params"),
            "batch_stats": _flat(new_j.batch_stats, "batch_stats"),
            "ema": {**_flat(new_j.ema.variables["params"], "params"),
                    **_flat(new_j.ema.variables["batch_stats"], "batch_stats")},
            "ema_updates": int(new_j.ema.updates),
            "parts": {k: float(v) for k, v in parts_j.items()},
        }
        model = copy.deepcopy(model0)
        opt = build_optimizer(model, SolverConfig(**SOLVER))
        opt.count = START_UPDATE
        state = TrainState(model, opt, EMAState({k: v.clone() for k, v in ema0.items()},
                                                EMA_UPDATES), 0)
        state, parts = step(state, batch, epoch)
        got = {
            "grads": to_flax_leaves({n: p.grad for n, p in model.named_parameters()}),
            "params": to_flax_leaves(dict(model.named_parameters())),
            "batch_stats": {k: v for k, v in to_flax_leaves(model.state_dict()).items()
                            if k.startswith("batch_stats/")},
            "ema": to_flax_leaves(state.ema.variables),
            "ema_updates": state.ema.updates,
            "parts": {k: float(v) for k, v in parts.items()},
            "state": state,
        }
        out[name] = (got, want)
    return out, before, step, batch


def _leafwise(got, want, minus=None):
    """Concatenate every leaf (minus its value before the step) divided by
    its largest JAX entry plus 1e-3 of the largest over all leaves."""
    if minus is not None:
        got = {k: got[k] - minus[k] for k in want}
        want = {k: want[k] - minus[k] for k in want}
    top = max(float(np.abs(w).max()) for w in want.values())
    g, w = [], []
    for k in sorted(want):
        scale = float(np.abs(want[k]).max()) + 1e-3 * top
        g.append(got[k].ravel() / scale)
        w.append(want[k].ravel() / scale)
    return np.concatenate(g), np.concatenate(w)


@pytest.mark.parametrize("epoch", list(EPOCHS))
def test_loss_terms(steps, epoch):
    got, want = steps[0][epoch]
    for k in ("loss", "cls", "iou", "dfl"):
        assert_close(k, got["parts"][k], want["parts"][k], atol=0, rtol=1e-4)
    assert got["parts"]["num_pos"] == want["parts"]["num_pos"] > 0


@pytest.mark.parametrize("epoch", list(EPOCHS))
def test_gradients(steps, epoch):
    got, want = steps[0][epoch]
    assert set(got["grads"]) == set(want["grads"])
    assert_close("gradients / leaf scale", *_leafwise(got["grads"], want["grads"]), atol=2e-2)


@pytest.mark.parametrize("epoch", list(EPOCHS))
def test_updated_parameters(steps, epoch):
    (got, want), before = steps[0][epoch], steps[1]
    assert_close("parameter update / leaf scale",
                 *_leafwise(got["params"], want["params"], minus=before), atol=2e-2)


@pytest.mark.parametrize("epoch", list(EPOCHS))
def test_batch_statistics(steps, epoch):
    got, want = steps[0][epoch]
    assert set(got["batch_stats"]) == set(want["batch_stats"])
    g, w = zip(*[(got["batch_stats"][k], want["batch_stats"][k]) for k in sorted(want["batch_stats"])])
    g, w = np.concatenate([a.ravel() for a in g]), np.concatenate([a.ravel() for a in w])
    assert_close("BN statistics", g, w, atol=1e-4, rtol=2e-3)


@pytest.mark.parametrize("epoch", list(EPOCHS))
def test_ema(steps, epoch):
    (got, want), before = steps[0][epoch], steps[1]
    assert got["ema_updates"] == want["ema_updates"] == EMA_UPDATES + 1
    ema_before = {k.replace("ema/", "", 1): v for k, v in before.items() if k.startswith("ema/")}
    assert_close("EMA change / leaf scale",
                 *_leafwise(got["ema"], want["ema"], minus=ema_before), atol=2e-2)


def test_eval_step_reads_the_ema(steps):
    """The eval step on the EMA's variables equals the model carrying them."""
    got, _ = steps[0]["tal"]
    state = got["state"]
    _, _, step, batch = steps
    ev = make_eval_step(state.model, "OptimizedRepresentation", (H, W), IMG, device="cpu")
    b = batch._replace(aug=None)
    preds = ev(state.ema.variables, b)
    model = copy.deepcopy(state.model)
    model.load_state_dict(state.ema.variables, strict=False)
    want = make_eval_step(model, "OptimizedRepresentation", (H, W), IMG, device="cpu")(None, b)
    assert_close("EMA eval", preds.numpy(), want.numpy(), atol=0)
    assert preds.shape == (B, 16**2 + 8**2 + 4**2 + 2**2, 7)
    assert not torch.equal(preds, ev(None, b))  # the EMA is not the live weights


def test_exact_warp_on_images_without_ema():
    """The other step variants, port only: prebuilt 0..255 images through
    the exact warp, and ``update_ema=False``, which leaves the EMA to its
    caller."""
    cfg = small_cfg()
    model = build_model(cfg, 2, device="cpu", generator=torch.Generator().manual_seed(0))
    state = init_train_state(model, build_optimizer(model, SolverConfig(**SOLVER)))
    ema_before = {k: v.clone() for k, v in state.ema.variables.items()}
    rng = np.random.default_rng(2)
    imgs = rng.uniform(0, 255, (B, 64, 64, 12)).astype(np.float32)
    labels = [np.array([[i % 2, 8.0, 10.0, 40.0, 44.0]], np.float32) for i in range(B)]
    plan, lab, nl = plan_augment_batch(labels, 64, dict(small_cfg()["data_aug"], mixup=1.0),
                                       rng, M)
    mask = (np.arange(M)[None] < nl[:, None]).astype(np.float32)
    batch = Batch(imgs, None, lab[..., 0], lab[..., 1:5], mask, AugPlan(**plan))
    step = make_train_step(LossConfig(2), img_size=64, warp_impl="exact", update_ema=False,
                           device="cpu")
    want = compose_warp(torch.from_numpy(imgs), AugPlan(**plan).to("cpu"), 64) / 255.0
    got = step.images_of(batch_on_device(batch, "cpu")).permute(0, 2, 3, 1)
    assert_close("images_of", got.numpy(), want.numpy(), atol=0)
    state, parts = step(state, batch, 0)
    assert all(bool(torch.isfinite(v)) for v in parts.values())
    assert state.step == 1 and state.opt_state.count == 1 and state.ema.updates == 0
    assert all(torch.equal(v, ema_before[k]) for k, v in state.ema.variables.items())
