"""The bfloat16 train step (``make_train_step`` with a
``build_model(dtype=torch.bfloat16)`` detector) against the JAX package's
bf16 step, at 128 px on the shrunk paper config: ERGO-12, letterbox, the
separable warp with mosaic and mixup at 1.0 (image-mode strong
augmentation), TAL, from random weights with the class preds at their init.

JAX's side is its step's forward as its ``make_train_step`` composes it:
the representation, the letterbox, ``compose_warp_separable`` with the
source gathered in bf16 for a bf16 model (its ``_warp_gd``), the train-mode
apply with the batch statistics mutable, and ``detection_loss``. The
checks need the loss and the BatchNorm statistics only, and a whole JAX
step compiles for ~20 s a dtype here.

- The port's bf16-vs-f32 deviation of the loss and of each term is at most
  2x JAX's bf16-vs-f32 deviation plus a floor of 1e-3 of the f32 value (a
  bf16 rounding is 3.9e-3 relative; the zoo tests' rule for bf16 outputs).
- The bf16 step's gradients are finite and float32, as are the weights and
  the optimizer's momentum.
- The warp's source reaches the roll (K3's wrapper) in bf16, both passes.
- The updated BatchNorm running statistics, each leaf's largest difference
  over its largest entry: the port's bf16 step against JAX's bf16 step, and
  the port's bf16 against its f32 step, each within 2x JAX's own bf16-vs-f32
  deviation (5.6e-2 measured; 5.3e-2 and 5.0e-2 for the two port figures:
  bf16 rounding of the activations dominates, the f32 statistics of the two
  packages agree to 1.1e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event_representation_study_tpu.events import from_structured as jax_from_structured
from event_representation_study_tpu.events import stack_blocks as jax_stack_blocks
from event_representation_study_tpu.models import build_model as jax_build_model
from event_representation_study_tpu.ops.image import letterbox_image as jax_letterbox
from event_representation_study_tpu.ops.warp import AugPlan as JaxAugPlan
from event_representation_study_tpu.ops.warp import compose_warp_separable as jax_warp
from event_representation_study_tpu.reps.dispatch import (
    batched_representation as jax_batched_representation,
)
from event_representation_study_tpu.train import losses as jax_losses
from event_representation_study_tpu_torch.data.augment import plan_augment_batch
from event_representation_study_tpu_torch.events import (
    from_structured,
    generate_fake_events,
    stack_blocks,
)
from event_representation_study_tpu_torch.models import build_model
from event_representation_study_tpu_torch.ops import warp
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
from event_representation_study_tpu_torch.utils.convert import flax_to_torch
from torch_port_helpers import (
    assert_close,
    jax_leaves,
    port_bn_stats,
    random_jax_variables,
    small_cfg,
)

H = W = 64
IMG, B, CAP, M, EPOCH = 128, 4, 2048, 16, 5
REP = "OptimizedRepresentation"
TERMS = ("loss", "iou", "dfl", "cls")
FLOOR = 1e-3  # of the f32 value, on top of 2x JAX's bf16-vs-f32 deviation


def _inputs():
    cfg = small_cfg()
    rng = np.random.default_rng(11)
    evs = [generate_fake_events(1500, H, W, 50_000, seed=30 + i) for i in range(B)]
    labels = []
    for _ in range(B):
        xywh = np.concatenate([rng.uniform(0.25, 0.75, (2, 2)), rng.uniform(0.15, 0.4, (2, 2))], 1)
        norm = np.concatenate([rng.integers(0, 2, (2, 1)), xywh], 1).astype(np.float32)
        labels.append(letterbox_labels(norm, H, W, IMG))
    hyp = dict(cfg["data_aug"], mosaic=1.0, mixup=1.0)
    plan, lab, nl = plan_augment_batch(labels, IMG, hyp, np.random.default_rng(9), M)
    mask = (np.arange(M)[None] < nl[:, None]).astype(np.float32)
    return cfg, evs, plan, lab, mask


def _jax_forward(cfg, variables, evs, plan, lab, mask):
    """{dtype name: (loss parts, updated batch statistics)} of JAX's step
    forward in float32 and in bfloat16."""
    rep_fn = jax_batched_representation(REP, H, W)
    blocks = jax_stack_blocks([jax_from_structured(e, CAP) for e in evs])
    aug = JaxAugPlan(**{k: jnp.asarray(v) for k, v in plan.items()})
    out = {}
    for name, dtype in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        model = jax_build_model(cfg, num_classes=2, dtype=dtype)
        gd = jnp.bfloat16 if dtype == jnp.bfloat16 else None

        @jax.jit
        def forward(v, blocks, aug, gt_labels, gt_bboxes, gt_mask):
            img = jax_letterbox(rep_fn(blocks), IMG)
            img = jax_warp(img, aug, IMG, gather_dtype=gd)[:B] / 255.0
            outputs, upd = model.apply(v, img, True, mutable=["batch_stats"])
            feat_shapes = [(f.shape[1], f.shape[2]) for f in outputs[0]]
            loss, parts = jax_losses.detection_loss(
                outputs, gt_labels, gt_bboxes, gt_mask, feat_shapes, EPOCH,
                jax_losses.LossConfig(2))
            return dict(parts, loss=loss), upd["batch_stats"]

        parts, stats = forward(variables, blocks, aug, lab[..., 0].astype(np.int32),
                               lab[..., 1:5], mask)
        out[name] = ({k: float(v) for k, v in parts.items()}, jax_leaves(stats, "batch_stats"))
    return out


def _port_step(cfg, variables, evs, plan, lab, mask, dtype):
    """One port step in ``dtype``: (parts, state, the dtypes of the roll's
    sources)."""
    model = build_model(cfg, 2, device="cpu", dtype=dtype)
    model.load_state_dict(flax_to_torch(variables), strict=True)
    opt = build_optimizer(model, SolverConfig(epochs=300, steps_per_epoch=1000))
    opt.count = 1500
    state = TrainState(model, opt, ema_init(model), 0)
    step = make_train_step(LossConfig(2), REP, (H, W), IMG, warp_impl="separable", device="cpu")
    batch = Batch(None, stack_blocks([from_structured(e, CAP) for e in evs]), lab[..., 0],
                  lab[..., 1:5], mask, AugPlan(**plan))
    seen, real = [], warp.roll_rows
    warp.roll_rows = lambda x, *a: seen.append(x.dtype) or real(x, *a)
    try:
        state, parts = step(state, batch, EPOCH)
    finally:
        warp.roll_rows = real
    return {k: float(v) for k, v in parts.items()}, state, seen


@pytest.fixture(scope="module")
def steps():
    cfg, evs, plan, lab, mask = _inputs()
    jax_model = jax_build_model(cfg, num_classes=2)
    variables = random_jax_variables(jax_model, IMG)
    for name, leaf in variables["params"]["head"].items():
        if name.startswith("cls_pred_"):  # at their init, as a run starts
            leaf["kernel"] = np.zeros_like(leaf["kernel"])
            leaf["bias"] = np.full_like(leaf["bias"], -np.log(99.0))
    port = {name: _port_step(cfg, variables, evs, plan, lab, mask, dtype)
            for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16))}
    return port, _jax_forward(cfg, variables, evs, plan, lab, mask)


@pytest.mark.parametrize("term", TERMS)
def test_bf16_loss_deviation_within_jax(steps, term):
    port, jax_ = steps
    p32, p16 = port["f32"][0][term], port["bf16"][0][term]
    j32, j16 = jax_["f32"][0][term], jax_["bf16"][0][term]
    assert_close(f"{term}: port f32 vs JAX f32", p32, j32, atol=0, rtol=1e-4)
    assert_close(f"{term}: port bf16 - f32 (atol: 2 x JAX's + {FLOOR} of f32)", p16 - p32, 0.0,
                 atol=2 * abs(j16 - j32) + FLOOR * abs(j32))
    assert port["bf16"][0]["num_pos"] > 0


def test_bf16_step_gradients_and_state_stay_float32(steps):
    _, state, _ = steps[0]["bf16"]
    for n, p in state.model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, n
        assert bool(torch.isfinite(p.grad).all()), n
    assert all(m.dtype == torch.float32 for m in state.opt_state.momentum.values())
    assert state.step == 1 and state.ema.updates == 1


def test_bf16_warp_source_reaches_the_roll_in_bf16(steps):
    assert steps[0]["bf16"][2] == [torch.bfloat16, torch.bfloat16]
    assert steps[0]["f32"][2] == [torch.float32, torch.float32]


def _leaf_dev(a, b):
    """The largest difference of a leaf over its largest entry in ``b``."""
    return max(float(np.abs(a[k] - b[k]).max() / np.abs(b[k]).max()) for k in b)


def test_bf16_batch_statistics(steps):
    """bf16 rounding dominates the statistics: JAX's own bf16 statistics
    stray ~5e-2 of a leaf's scale from its f32 ones. The port's bf16
    statistics are held to JAX's bf16 ones, and the port's bf16-vs-f32
    deviation to JAX's, each within 2x JAX's bf16-vs-f32 deviation."""
    port, jax_ = steps
    p16, p32 = (port_bn_stats(port[d][1].model) for d in ("bf16", "f32"))
    j16, j32 = jax_["bf16"][1], jax_["f32"][1]
    assert set(p16) == set(j16) and j16
    allowed = 2 * _leaf_dev(j16, j32)
    assert_close("bf16 BN statistics, port vs JAX, / leaf scale (atol: 2 x JAX's bf16 - f32)",
                 _leaf_dev(p16, j16), 0.0, atol=allowed)
    assert_close("BN statistics, port bf16 - f32, / leaf scale (atol: 2 x JAX's)",
                 _leaf_dev(p16, p32), 0.0, atol=allowed)
