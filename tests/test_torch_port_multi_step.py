"""K train steps a call: ``train/ema.py::ema_update_k`` and
``parallel/train_step.py::make_multi_train_step`` / ``stack_batches``
against the JAX package, and the Trainer's K-step epoch.

- ``ema_update_k`` against JAX's on seeded random trees (rtol 1e-6 plus
  one float32 ulp of a leaf's largest operand), and
  against K ``ema_update`` calls on constant parameters (rtol 1e-6, the
  counter advanced by K), as JAX's ``test_ema_update_k_collapses_constant_params``.
- A K = 2 call of the shrunk paper detector at 128 px (random images and
  boxes, TAL) from random weights, with the optimizer past its warmup and
  the EMA at update 3,000, against
  JAX's ``make_train_step`` called twice plus, for ``ema_cadence="dispatch"``,
  JAX's ``ema_update_k`` (the JAX package's own scanned test shows these
  equal its ``lax.scan`` in parameters; its scan compile is marked slow
  there). Loss terms of both steps 1e-4 relative; the second step's
  gradients and the parameter updates 2e-2 of each leaf's scale (the
  whole-step tolerances of ``test_torch_port_train_step.py``); the EMA
  2e-3 absolute, its counter 3,002.
- The port's K = 2 call against two of its single steps, plain and
  distillation (a teacher), on event batches (ERGO-12, letterbox,
  separable warp with mosaic and mixup at 1.0): bit-equal on the CPU.
- The Trainer at K = 2 on 5 batches an epoch (2 calls and 1 remainder
  step): the steps and EMA updates under both cadences, bit-equal to K = 1
  under ``"step"``, a resume, and ``cli/train.py --steps-per-dispatch 2
  --ema-cadence dispatch``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event_representation_study_tpu.models import build_model as jax_build_model
from event_representation_study_tpu.parallel import train_step as jax_train_step
from event_representation_study_tpu.train import ema as jax_ema
from event_representation_study_tpu.train import losses as jax_losses
from event_representation_study_tpu.train import optim as jax_optim
from event_representation_study_tpu_torch.data.augment import plan_augment_batch
from event_representation_study_tpu_torch.events import (
    EventBlock,
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
    make_multi_train_step,
    make_train_step,
    stack_batches,
)
from event_representation_study_tpu_torch.train.ema import (
    EMAState,
    ema_init,
    ema_update,
    ema_update_k,
)
from event_representation_study_tpu_torch.train.losses import LossConfig
from event_representation_study_tpu_torch.train.optim import SolverConfig, build_optimizer
from event_representation_study_tpu_torch.utils.convert import flax_to_torch, to_flax_leaves
from torch_port_helpers import (
    _leafwise,
    _with_grad_spy,
    assert_close,
    jax_leaves,
    port_bn_stats,
    random_jax_variables,
    small_cfg,
)

H = W = 64
IMG, B, CAP, M, K = 128, 4, 2048, 16, 2
SOLVER = dict(epochs=300, steps_per_epoch=1000)
START_UPDATE, EMA_UPDATES, EPOCH = 1500, 3000, 5
STEP_KW = dict(representation="OptimizedRepresentation", rep_hw=(H, W), img_size=IMG,
               warp_impl="separable", device="cpu")


# -- ema_update_k -------------------------------------------------------------


def _module(seed):
    gen = torch.Generator().manual_seed(seed)
    m = torch.nn.Sequential(torch.nn.Linear(8, 3), torch.nn.BatchNorm1d(3))
    with torch.no_grad():
        for v in m.state_dict().values():
            if v.is_floating_point():
                v.copy_(torch.randn(v.shape, generator=gen))
    return m


@pytest.mark.parametrize("u0,k", [(0, 5), (2999, 4)])
def test_ema_update_k_like_jax(u0, k):
    """One blend of K decays, port and JAX, from the same random EMA and
    model state."""
    model = _module(0)
    state = EMAState(ema_init(_module(1)).variables, u0)
    tree = {n: jnp.asarray(np.array(v)) for n, v in state.variables.items()}
    new = {n: jnp.asarray(np.array(v)) for n, v in ema_init(model).variables.items()}
    want = jax_ema.ema_update_k(jax_ema.EMAState(tree, jnp.int32(u0)), new, k)
    # an element that cancels to near 0 keeps the operands' rounding: one
    # float32 ulp of the leaf's largest operand on top of rtol 1e-6
    ulp = {n: float(np.spacing(np.float32(max(np.abs(tree[n]).max(), np.abs(new[n]).max()))))
           for n in tree}
    got = ema_update_k(state, model, k)
    assert got.updates == int(want.updates) == u0 + k
    for n in tree:
        assert_close(f"ema_update_k {n}", got.variables[n].numpy(), want.variables[n],
                     atol=ulp[n], rtol=1e-6)


@pytest.mark.parametrize("u0", [0, 2999])
def test_ema_update_k_collapses_constant_params(u0):
    """K per-step blends of constant parameters equal one blend of K."""
    model = _module(0)
    seq = EMAState(ema_init(_module(1)).variables, u0)
    one = EMAState({n: v.clone() for n, v in seq.variables.items()}, u0)
    for _ in range(5):
        seq = ema_update(seq, model)
    one = ema_update_k(one, model, 5)
    assert one.updates == seq.updates == u0 + 5
    for n, v in seq.variables.items():
        assert_close(f"K blends vs one {n}", one.variables[n].numpy(), v.numpy(), atol=0,
                     rtol=1e-6)


# -- a K = 2 call against JAX ---------------------------------------------------


def _event_batches(cfg):
    """Two train batches of the same 4 fake windows, each with its own
    strong-augmentation plan (mosaic and mixup at 1.0)."""
    rng = np.random.default_rng(11)
    evs = [generate_fake_events(1500, H, W, 50_000, seed=30 + i) for i in range(B)]
    labels = []
    for _ in range(B):
        xywh = np.concatenate([rng.uniform(0.25, 0.75, (2, 2)), rng.uniform(0.15, 0.4, (2, 2))], 1)
        norm = np.concatenate([rng.integers(0, 2, (2, 1)), xywh], 1).astype(np.float32)
        labels.append(letterbox_labels(norm, H, W, IMG))
    hyp = dict(cfg["data_aug"], mosaic=1.0, mixup=1.0)
    out = []
    for seed in (9, 10):
        plan, lab, nl = plan_augment_batch(labels, IMG, hyp, np.random.default_rng(seed), M)
        mask = (np.arange(M)[None] < nl[:, None]).astype(np.float32)
        out.append(Batch(None, stack_blocks([from_structured(e, CAP) for e in evs]),
                         lab[..., 0], lab[..., 1:5], mask, AugPlan(**plan)))
    return out


def _image_batches():
    """Two batches of random 0..1 images with random boxes: the detector,
    loss, optimizer and EMA of each step, without the representation and
    the warp (``test_torch_port_train_step.py`` holds those)."""
    rng = np.random.default_rng(13)
    out = []
    for _ in range(K):
        xy = rng.uniform(8, 70, (B, M, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(20, 55, (B, M, 2))], -1).astype(np.float32)
        out.append((rng.uniform(0, 1, (B, IMG, IMG, 12)).astype(np.float32),
                    rng.integers(0, 2, (B, M)).astype(np.int32), boxes,
                    (np.arange(M)[None] < rng.integers(2, M + 1, (B, 1))).astype(np.float32)))
    return ([Batch(b[0], None, *b[1:]) for b in out],
            [jax_train_step.Batch(b[0], None, *b[1:]) for b in out])


def _port_state(cfg, variables, ema_vars):
    model = build_model(cfg, 2, device="cpu")
    model.load_state_dict(flax_to_torch(variables), strict=True)
    opt = build_optimizer(model, SolverConfig(**SOLVER))
    opt.count = START_UPDATE
    # clones: the converted tensors may share the NumPy leaves' memory
    ema = {k: v.clone() for k, v in flax_to_torch(ema_vars).items() if v.is_floating_point()}
    return TrainState(model, opt, EMAState(ema, EMA_UPDATES), 0)


@pytest.fixture(scope="module")
def setup():
    """The shrunk config, random weights with the class preds at their init
    (random ones put every score near 0.5, and the first step's float32
    noise then moves the second step's class loss by ~1%), a perturbed EMA,
    and the image and event batches."""
    cfg = small_cfg()
    jax_model = jax_build_model(cfg, num_classes=2)
    variables = random_jax_variables(jax_model, IMG)
    for name, leaf in variables["params"]["head"].items():
        if name.startswith("cls_pred_"):
            leaf["kernel"] = np.zeros_like(leaf["kernel"])
            leaf["bias"] = np.full_like(leaf["bias"], -np.log(99.0))
    rng = np.random.default_rng(12)
    ema_vars = jax.tree.map(lambda a: (a + rng.normal(0, 0.05, a.shape)).astype(np.float32),
                            variables)
    return cfg, jax_model, variables, ema_vars, _image_batches(), _event_batches(cfg)


@pytest.fixture(scope="module")
def k_call(setup):
    """JAX's step twice (and ``ema_update_k`` for the dispatch EMA), and the
    port's K = 2 call under each cadence, from the same state: {"jax": ...,
    "step": ..., "dispatch": ...} of flat Flax-path dicts."""
    cfg, jax_model, variables, ema_vars, (batches, batches_j), _ = setup
    before = jax_leaves(variables["params"], "params")
    tx_j = _with_grad_spy(jax_optim.build_optimizer(variables["params"],
                                                    jax_optim.SolverConfig(**SOLVER)))
    opt0 = tx_j.init(variables["params"])
    ema0 = jax_ema.EMAState(ema_vars, jnp.int32(EMA_UPDATES))
    state_j = jax_train_step.TrainState(
        variables["params"], variables["batch_stats"],
        (opt0[0]._replace(count=jnp.int32(START_UPDATE)), opt0[1]), ema0, jnp.int32(0))
    step_j = jax_train_step.make_train_step(jax_model, jax_losses.LossConfig(2), tx_j,
                                            img_size=IMG, donate=False)
    parts_j = []
    for b in batches_j:
        state_j, p = step_j(state_j, b, EPOCH)
        parts_j.append({k: float(v) for k, v in p.items()})
    ema_k = jax.jit(jax_ema.ema_update_k, static_argnums=2)(
        ema0, {"params": state_j.params, "batch_stats": state_j.batch_stats}, K)
    out = {"jax": {
        "grads": jax_leaves(state_j.opt_state[1], "params"),
        "params": jax_leaves(state_j.params, "params"),
        "batch_stats": jax_leaves(state_j.batch_stats, "batch_stats"),
        "ema_step": {**jax_leaves(state_j.ema.variables["params"], "params"),
                     **jax_leaves(state_j.ema.variables["batch_stats"], "batch_stats")},
        "ema_dispatch": {**jax_leaves(ema_k.variables["params"], "params"),
                         **jax_leaves(ema_k.variables["batch_stats"], "batch_stats")},
        "ema_updates": int(state_j.ema.updates), "parts": parts_j}}
    assert int(ema_k.updates) == out["jax"]["ema_updates"] == EMA_UPDATES + K
    for cadence in ("step", "dispatch"):
        state = _port_state(cfg, variables, ema_vars)
        multi = make_multi_train_step(LossConfig(2), K, ema_cadence=cadence, img_size=IMG,
                                      device="cpu")
        state, parts = multi(state, stack_batches(batches), EPOCH)
        model = state.model
        out[cadence] = {
            "grads": to_flax_leaves({n: p.grad for n, p in model.named_parameters()}),
            "params": to_flax_leaves(dict(model.named_parameters())),
            "batch_stats": port_bn_stats(model),
            "ema": to_flax_leaves(state.ema.variables), "ema_updates": state.ema.updates,
            "parts": [{k: float(v[i]) for k, v in parts.items()} for i in range(K)],
            "shapes": {k: tuple(v.shape) for k, v in parts.items()}, "step": state.step}
    return out, before


CADENCES = ("step", "dispatch")


@pytest.mark.parametrize("cadence", CADENCES)
def test_k_call_loss_terms(k_call, cadence):
    out, _ = k_call
    got, want = out[cadence], out["jax"]
    assert got["shapes"] == {k: (K,) for k in got["shapes"]} and got["step"] == K
    for i in range(K):
        for k in ("loss", "cls", "iou", "dfl"):
            assert_close(f"step {i} {k}", got["parts"][i][k], want["parts"][i][k], atol=0,
                         rtol=1e-4)
        assert got["parts"][i]["num_pos"] == want["parts"][i]["num_pos"] > 0


@pytest.mark.parametrize("cadence", CADENCES)
def test_k_call_gradients_and_updates(k_call, cadence):
    out, before = k_call
    got, want = out[cadence], out["jax"]
    assert set(got["grads"]) == set(want["grads"])
    assert_close("second step's gradients / leaf scale", _leafwise(got["grads"], want["grads"]),
                 0.0, atol=2e-2)
    assert_close("K = 2 parameter update / leaf scale",
                 _leafwise(got["params"], want["params"], before), 0.0, atol=2e-2)
    for k in want["batch_stats"]:
        assert_close(f"BN {k}", got["batch_stats"][k], want["batch_stats"][k], atol=1e-4,
                     rtol=2e-3)


@pytest.mark.parametrize("cadence", CADENCES)
def test_k_call_ema(k_call, cadence):
    out, _ = k_call
    got, want = out[cadence], out["jax"][f"ema_{cadence}"]
    assert got["ema_updates"] == out["jax"]["ema_updates"] == EMA_UPDATES + K
    assert set(got["ema"]) == set(want)
    err = max(float(np.abs(got["ema"][k] - want[k]).max()) for k in want)
    assert_close(f"EMA ({cadence} cadence), max over leaves", err, 0.0, atol=2e-3)


# -- the K-step call against the port's single steps ---------------------------


@pytest.mark.parametrize("mode", ["plain", "distill"])
def test_k_call_equals_single_steps(setup, mode):
    """A K = 2 ``"step"`` call is the two single steps, bit for bit on the
    CPU: parameters, BN statistics, momentum, EMA and loss parts."""
    cfg, _, variables, ema_vars, _, batches = setup
    kw = dict(STEP_KW)
    if mode == "distill":
        teacher = build_model(cfg, 2, device="cpu")
        teacher.load_state_dict(flax_to_torch(ema_vars), strict=True)
        kw.update(mode="distill", teacher=teacher.requires_grad_(False), max_epoch=10)
    got = _port_state(cfg, variables, ema_vars)
    got, parts = make_multi_train_step(LossConfig(2), K, **kw)(got, stack_batches(batches), 2)
    want = _port_state(cfg, variables, ema_vars)
    step = make_train_step(LossConfig(2), **kw)
    want_parts = []
    for b in batches:
        want, p = step(want, b, 2)
        want_parts.append(p)
    for k in want_parts[0]:
        assert torch.equal(parts[k], torch.stack([p[k] for p in want_parts])), k
    for name, a, b in (("model", got.model.state_dict(), want.model.state_dict()),
                       ("momentum", got.opt_state.momentum, want.opt_state.momentum),
                       ("ema", got.ema.variables, want.ema.variables)):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a), name
    assert (got.step, got.ema.updates, got.opt_state.count) == \
        (want.step, want.ema.updates, want.opt_state.count)


def test_stack_batches(setup):
    """Every leaf gains a leading K axis, event-block and plan fields
    included; a stack of the wrong depth is refused."""
    cfg, _, variables, ema_vars, _, batches = setup
    stacked = stack_batches(batches)
    assert isinstance(stacked.events, EventBlock) and isinstance(stacked.aug, AugPlan)
    assert stacked.images is None
    for field in ("x", "y", "t", "p", "num"):
        assert torch.equal(getattr(stacked.events, field)[1], getattr(batches[1].events, field))
    for a, b in zip(stacked.aug, batches[1].aug):
        assert (a is None and b is None) or np.array_equal(a[1], b)
    assert isinstance(stacked.gt_mask, np.ndarray) and stacked.gt_mask.shape == (K, B, M)
    three = stack_batches(batches + batches[:1])
    multi = make_multi_train_step(LossConfig(2), K, **STEP_KW)
    with pytest.raises(ValueError, match="leading dim 3"):
        multi(_port_state(cfg, variables, ema_vars), three, 0)
