"""The data-parallel train step (``make_train_step(group=...)``, M11) on 2
gloo ranks, each on half of a batch of 4, against the port's one-process
step and the JAX package's single-device step on the whole batch.

The batch: fake 64x64 windows at 128 px through ERGO-12, the letterbox and
the paper recipe's mosaic + affine + flip + mixup (a plan per rank, as each
rank's loader plans; the whole batch's plan is the two concatenated, the
second's partner rows shifted by 2). Rank 1's rows carry no box, so its
own target-score sum is 0: only a global normaliser gives the global step.
The optimizer starts past its warmup and the EMA from perturbed weights at
update 3,000, as ``test_torch_port_train_step.py``.

One spawned group (the module fixture) also holds:
- the tensor-parallel step (``parallel/tensor_parallel.py``, M18) from the
  same weights on the whole batch, its convolutions split by output
  channel over a "model" axis of 2, against the same two references:
  loss 2e-4 relative (JAX's dp x tp tolerance), parameter updates 2e-2 of
  leaf scale, and the stem moved by more than 1e-3 of its scale;
- the K-step call (``make_multi_train_step``, K = 2) under the group
  against two group steps;
- every loss term under the group (``detection_loss``, the fuse-ab
  branch, the distillation terms with feature KD and the ltrb branch) on
  random head outputs: the ranks' losses sum to the one-process loss on
  the whole batch, and each rank's output gradients are that loss's
  gradients of its rows.

Tolerances, those of ``test_torch_port_train_step.py``: loss terms 1e-4
relative; gradients, parameter updates and EMA changes 2e-2 of leaf scale;
BatchNorm statistics 1e-4 + 2e-3 relative; positive counts exact. The two
ranks' parameters after a step are bit-equal, and so are the K-step call's
and the two steps'. The loss terms on random outputs: 1e-5 relative, and
their gradients 1e-5 of the largest.
"""
import numpy as np
import pytest
import torch

from event_representation_study_tpu_torch.data.augment import plan_augment_batch
from event_representation_study_tpu_torch.events import (
    from_structured,
    generate_fake_events,
    stack_blocks,
)
from event_representation_study_tpu_torch.models import build_model
from event_representation_study_tpu_torch.models.layers import BatchNorm2d
from event_representation_study_tpu_torch.ops.image import letterbox_labels
from event_representation_study_tpu_torch.ops.warp import AugPlan
from event_representation_study_tpu_torch.parallel.batch_norm import GlobalBatchNorm2d
from event_representation_study_tpu_torch.parallel.dist import all_gather
from event_representation_study_tpu_torch.parallel.mesh import make_mesh
from event_representation_study_tpu_torch.parallel.tensor_parallel import (
    count_tp_sharded,
    shard_state_tp,
)
from event_representation_study_tpu_torch.parallel.train_step import (
    Batch,
    TrainState,
    make_multi_train_step,
    make_train_step,
    stack_batches,
)
from event_representation_study_tpu_torch.train.ema import EMAState
from event_representation_study_tpu_torch.train.losses import LossConfig, detection_loss
from event_representation_study_tpu_torch.train.losses_variants import (
    detection_loss_distill,
    detection_loss_fuseab,
)
from event_representation_study_tpu_torch.train.optim import SolverConfig, build_optimizer
from event_representation_study_tpu_torch.utils.config import load_config
from event_representation_study_tpu_torch.utils.convert import to_flax_leaves
from torch_port_helpers import CFG_PATH, SMALL, SpawnedGroup, _leafwise, assert_close

H = W = 64
IMG, B, CAP, M = 128, 4, 2048, 16
HALF = B // 2
SOLVER = dict(epochs=300, steps_per_epoch=1000)
START_UPDATE, EMA_UPDATES = 1500, 3000
EPOCH = 0  # ATSS


def make_batches(seed: int = 11):
    """(the whole batch, each rank's half, the events, the whole batch's
    plan arrays): Batch leaves in NumPy."""
    rng = np.random.default_rng(seed)
    evs = [generate_fake_events(1500, H, W, 50_000, seed=30 + seed + i) for i in range(B)]
    labels = []
    for i in range(B):
        if i >= HALF:  # rank 1 holds no box
            labels.append(np.zeros((0, 5), np.float32))
            continue
        xywh = np.concatenate([rng.uniform(0.25, 0.75, (2, 2)), rng.uniform(0.15, 0.4, (2, 2))],
                              1)
        norm = np.concatenate([rng.integers(0, 2, (2, 1)), xywh], 1).astype(np.float32)
        labels.append(letterbox_labels(norm, H, W, IMG))
    hyp = dict(load_config(CFG_PATH, overrides=SMALL)["data_aug"], mosaic=1.0, mixup=1.0)
    blocks = stack_blocks([from_structured(e, CAP) for e in evs])
    halves, plans = [], []
    for r in range(2):
        rows = slice(r * HALF, (r + 1) * HALF)
        plan, lab, nl = plan_augment_batch(labels[rows], IMG, hyp, rng, M)
        mask = (np.arange(M)[None] < nl[:, None]).astype(np.float32)
        halves.append(Batch(None, stack_blocks([from_structured(e, CAP) for e in evs[rows]]),
                            lab[..., 0], lab[..., 1:5], mask, AugPlan(**plan)))
        plans.append(plan)
    shifted = dict(plans[1], src_idx=plans[1]["src_idx"] + HALF,
                   mix_idx=plans[1]["mix_idx"] + HALF)
    whole_plan = {k: np.concatenate([plans[0][k], shifted[k]]) for k in plans[0]}
    whole = Batch(None, blocks, *(np.concatenate([h[i] for h in halves]) for i in (2, 3, 4)),
                  AugPlan(**whole_plan))
    return whole, halves, evs, whole_plan


def _state(variables, ema_variables):
    """A train state from flat port state dicts (NumPy), its optimizer at
    ``START_UPDATE`` and its gradients recorded as the optimizer sees them."""
    model = build_model(load_config(CFG_PATH, overrides=SMALL), 2, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in variables.items()},
                          strict=True)
    opt = build_optimizer(model, SolverConfig(**SOLVER))
    opt.count = START_UPDATE
    seen = {}
    real = opt.update

    def spy(grads):
        seen.clear()
        seen.update({n: g.detach().clone() for n, g in grads.items()})
        real(grads)

    opt.update = spy
    ema = EMAState({k: torch.from_numpy(v.copy()) for k, v in ema_variables.items()},
                   EMA_UPDATES)
    return TrainState(model, opt, ema, 0), seen


def _record(state, seen, parts):
    return {
        "grads": to_flax_leaves(seen),
        "params": to_flax_leaves(dict(state.model.named_parameters())),
        "batch_stats": {k: v for k, v in to_flax_leaves(state.model.state_dict()).items()
                        if k.startswith("batch_stats/")},
        "ema": to_flax_leaves(state.ema.variables),
        "ema_updates": state.ema.updates,
        "parts": {k: float(v) for k, v in parts.items()},
    }


def loss_inputs(seed: int = 5, nc: int = 2, reg_max: int = 16):
    """Random head outputs of the whole batch at 128 px (strides 8-64) for
    every loss: (student, teacher, cls_ab, reg_ab, reg_lrtb, gt, shapes)."""
    g = torch.Generator().manual_seed(seed)
    shapes = [(IMG // s, IMG // s) for s in (8, 16, 32, 64)]
    A = sum(h * w for h, w in shapes)

    def outputs():
        feats = [torch.randn(B, 8, h, w, generator=g) for h, w in shapes]
        cls = torch.rand(B, A, nc, generator=g) * 0.9 + 0.05
        reg = torch.randn(B, A, 4 * (reg_max + 1), generator=g)
        return feats, cls, reg

    whole = make_batches()[0]
    gt = (torch.as_tensor(whole.gt_labels).long(), torch.as_tensor(whole.gt_bboxes),
          torch.as_tensor(whole.gt_mask))
    cls_ab = torch.rand(B, A, nc, generator=g) * 0.9 + 0.05
    reg_ab = torch.cat([torch.rand(B, A, 2, generator=g), torch.rand(B, A, 2, generator=g) + 1],
                       -1)
    reg_lrtb = torch.rand(B, A, 4, generator=g) * 3 + 0.5
    return outputs(), outputs(), cls_ab, reg_ab, reg_lrtb, gt, shapes


def all_losses(rows, group, epoch):
    """Every loss on ``rows`` of :func:`loss_inputs`: {name: (loss, parts,
    gradients of the differentiable outputs)}."""
    student, teacher, cls_ab, reg_ab, reg_lrtb, gt, shapes = loss_inputs()
    pick = lambda t: t[rows].clone().requires_grad_(True)  # noqa: E731
    s_feats, s_cls, s_reg = [pick(f) for f in student[0]], pick(student[1]), pick(student[2])
    t_out = ([f[rows] for f in teacher[0]], teacher[1][rows], teacher[2][rows])
    gt = tuple(t[rows] for t in gt)
    ab = (pick(cls_ab), pick(reg_ab))
    lrtb = pick(reg_lrtb)
    cfg = LossConfig(2)
    out = {}
    for name in ("plain", "fuseab", "distill"):
        leaves = [s_feats[0], s_cls, s_reg, *ab, lrtb]
        for leaf in leaves:
            leaf.grad = None
        if name == "plain":
            loss, parts = detection_loss((s_feats, s_cls, s_reg), *gt, shapes, epoch, cfg,
                                         group=group)
        elif name == "fuseab":
            loss, parts = detection_loss_fuseab(*ab, *gt, shapes, cfg, group=group)
        else:
            loss, parts = detection_loss_distill(
                (s_feats, s_cls, s_reg), t_out, *gt, shapes, epoch, 10, cfg,
                distill_feat=True, reg_lrtb=lrtb, group=group)
        loss.backward()
        grads = [np.zeros(tuple(leaf.shape), np.float32) if leaf.grad is None
                 else leaf.grad.numpy().copy() for leaf in leaves]
        out[name] = (float(loss.detach()), {k: float(v.detach()) for k, v in parts.items()},
                     grads)
    return out


def group_worker(rank, world, variables, ema_variables):
    group = torch.distributed.group.WORLD
    halves = make_batches()[1]
    kw = dict(representation="OptimizedRepresentation", rep_hw=(H, W), img_size=IMG,
              warp_impl="separable", device="cpu", group=group)
    step = make_train_step(LossConfig(2), **kw)
    state, seen = _state(variables, ema_variables)
    state, parts = step(state, halves[rank], EPOCH)
    out = {"step": _record(state, seen, parts),
           "batch_norms": [sum(isinstance(m, cls) for m in state.model.modules())
                           for cls in (BatchNorm2d, GlobalBatchNorm2d)]}

    # tensor parallel over a "model" axis of 2: the whole batch on both ranks
    mesh = make_mesh(axis_names=("data", "model"), shape=(1, world), device="cpu")
    tp = shard_state_tp(_state(variables, ema_variables)[0], mesh)
    tp, tp_parts = make_train_step(LossConfig(2), **dict(kw, group=mesh.group("data")))(
        tp, make_batches()[0], EPOCH)
    full = {n: torch.cat(all_gather(p.detach(), mesh.group("model")))
            if getattr(p, "tp_axis", None) else p for n, p in tp.model.named_parameters()}
    out["tp"] = {"params": to_flax_leaves(full), "sharded": count_tp_sharded(tp.model),
                 "parts": {k: float(v) for k, v in tp_parts.items()}}

    # K = 2 in one call against two group steps, each from the same state
    second = make_batches(seed=12)[1][rank]
    multi = make_multi_train_step(LossConfig(2), 2, **kw)
    a, _ = _state(variables, ema_variables)
    b, _ = _state(variables, ema_variables)
    for batch in (halves[rank], second):
        a, _ = step(a, batch, EPOCH)
    b, parts_k = multi(b, stack_batches([halves[rank], second]), EPOCH)
    out["k_steps"] = {"single": to_flax_leaves(dict(a.model.named_parameters())),
                      "multi": to_flax_leaves(dict(b.model.named_parameters())),
                      "loss": parts_k["loss"].tolist()}

    rows = slice(rank * HALF, (rank + 1) * HALF)
    out["losses"] = {e: all_losses(rows, group, e) for e in (0, 5)}
    return out


def _jax_step(variables_j, ema_j):
    """JAX's separable-warp step on the whole batch: a recorded dict as
    :func:`_record`'s (Flax paths)."""
    import jax
    import jax.numpy as jnp

    from event_representation_study_tpu.events import from_structured as jax_from_structured
    from event_representation_study_tpu.events import stack_blocks as jax_stack_blocks
    from event_representation_study_tpu.models import build_model as jax_build_model
    from event_representation_study_tpu.ops.warp import AugPlan as JaxAugPlan
    from event_representation_study_tpu.parallel import train_step as jax_train_step
    from event_representation_study_tpu.train import ema as jax_ema
    from event_representation_study_tpu.train import losses as jax_losses
    from event_representation_study_tpu.train import optim as jax_optim
    from torch_port_helpers import _with_grad_spy, jax_leaves, small_cfg

    jax_model = jax_build_model(small_cfg(), num_classes=2)
    tx = _with_grad_spy(jax_optim.build_optimizer(variables_j["params"],
                                                  jax_optim.SolverConfig(**SOLVER)))
    opt0 = tx.init(variables_j["params"])
    state = jax_train_step.TrainState(
        variables_j["params"], variables_j["batch_stats"],
        (opt0[0]._replace(count=jnp.int32(START_UPDATE)), opt0[1]),
        jax_ema.EMAState(ema_j, jnp.int32(EMA_UPDATES)), jnp.int32(0))
    step = jax_train_step.make_train_step(
        jax_model, jax_losses.LossConfig(2), tx, representation="OptimizedRepresentation",
        rep_hw=(H, W), img_size=IMG, donate=False, warp_impl="separable")
    whole, _, evs, plan = make_batches()
    blocks = jax_stack_blocks([jax_from_structured(e, CAP) for e in evs])
    batch = jax_train_step.Batch(None, blocks, whole.gt_labels.astype(np.int32),
                                 whole.gt_bboxes, whole.gt_mask,
                                 JaxAugPlan(**{k: jnp.asarray(v) for k, v in plan.items()}))
    new, parts = step(state, batch, EPOCH)
    return {
        "grads": jax_leaves(new.opt_state[1], "params"),
        "params": jax_leaves(new.params, "params"),
        "batch_stats": jax_leaves(new.batch_stats, "batch_stats"),
        "ema": {**jax_leaves(new.ema.variables["params"], "params"),
                **jax_leaves(new.ema.variables["batch_stats"], "batch_stats")},
        "ema_updates": int(new.ema.updates),
        "parts": {k: float(v) for k, v in parts.items()},
    }


@pytest.fixture(scope="module")
def steps():
    """(the group's per-rank results, the port's one-process step, JAX's
    step, the values before the step) on the same weights."""
    import jax

    from event_representation_study_tpu.models import build_model as jax_build_model
    from event_representation_study_tpu_torch.utils.convert import flax_to_torch
    from torch_port_helpers import random_jax_variables, small_cfg

    variables_j = random_jax_variables(jax_build_model(small_cfg(), num_classes=2), IMG)
    rng = np.random.default_rng(11)
    ema_j = jax.tree.map(lambda a: (a + rng.normal(0, 0.05, a.shape)).astype(np.float32),
                         variables_j)
    variables = {k: v.numpy().copy() for k, v in flax_to_torch(variables_j).items()}
    ema = {k: v.numpy().copy() for k, v in flax_to_torch(ema_j).items()
           if v.is_floating_point()}
    group = SpawnedGroup(group_worker, world=2, variables=variables, ema_variables=ema)
    want = _jax_step(jax.tree.map(np.copy, variables_j), jax.tree.map(np.copy, ema_j))
    whole = make_batches()[0]

    step = make_train_step(LossConfig(2), "OptimizedRepresentation", (H, W), IMG,
                           warp_impl="separable", device="cpu")
    state, seen = _state(variables, ema)
    state, parts = step(state, whole, EPOCH)
    one = _record(state, seen, parts)
    before = {**to_flax_leaves({k: torch.from_numpy(v) for k, v in variables.items()}),
              **{"ema/" + k: v for k, v in to_flax_leaves(
                  {k: torch.from_numpy(v) for k, v in ema.items()}).items()}}
    return group.results(), one, want, before


def test_ranks_agree(steps):
    ranks = steps[0]
    a, b = (r["step"] for r in ranks)
    for what in ("params", "batch_stats", "ema"):
        for k in a[what]:
            np.testing.assert_array_equal(a[what][k], b[what][k], err_msg=f"{what} {k}")
    assert a["parts"] == b["parts"]
    n_bn, n_global = ranks[0]["batch_norms"]  # every BatchNorm went global
    assert n_bn == n_global > 0 and ranks[1]["batch_norms"] == [n_bn, n_global]


@pytest.mark.parametrize("ref", ["port", "jax"])
def test_loss_terms(steps, ref):
    ranks, one, want, _ = steps
    want = one if ref == "port" else want
    got = ranks[0]["step"]["parts"]
    for k in ("loss", "cls", "iou", "dfl"):
        assert_close(f"{k} vs {ref}", got[k], want["parts"][k], atol=0, rtol=1e-4)
    assert got["num_pos"] == want["parts"]["num_pos"] > 0


@pytest.mark.parametrize("ref", ["port", "jax"])
def test_gradients(steps, ref):
    ranks, one, want, _ = steps
    want = one if ref == "port" else want
    got = ranks[0]["step"]["grads"]
    assert set(got) == set(want["grads"])
    assert_close(f"gradients / leaf scale vs {ref}", _leafwise(got, want["grads"]), 0.0,
                 atol=2e-2)


@pytest.mark.parametrize("ref", ["port", "jax"])
def test_updated_parameters(steps, ref):
    ranks, one, want, before = steps
    want = one if ref == "port" else want
    assert_close(f"parameter update / leaf scale vs {ref}",
                 _leafwise(ranks[0]["step"]["params"], want["params"], minus=before), 0.0,
                 atol=2e-2)


@pytest.mark.parametrize("ref", ["port", "jax"])
def test_batch_statistics(steps, ref):
    ranks, one, want, _ = steps
    want = one if ref == "port" else want
    got = ranks[0]["step"]["batch_stats"]
    assert set(got) == set(want["batch_stats"])
    keys = sorted(want["batch_stats"])
    g = np.concatenate([got[k].ravel() for k in keys])
    w = np.concatenate([want["batch_stats"][k].ravel() for k in keys])
    assert_close(f"BN statistics vs {ref}", g, w, atol=1e-4, rtol=2e-3)


@pytest.mark.parametrize("ref", ["port", "jax"])
def test_ema(steps, ref):
    ranks, one, want, before = steps
    want = one if ref == "port" else want
    got = ranks[0]["step"]
    assert got["ema_updates"] == want["ema_updates"] == EMA_UPDATES + 1
    ema_before = {k.replace("ema/", "", 1): v for k, v in before.items() if k.startswith("ema/")}
    assert_close(f"EMA change / leaf scale vs {ref}",
                 _leafwise(got["ema"], want["ema"], minus=ema_before), 0.0, atol=2e-2)


@pytest.mark.parametrize("ref", ["port", "jax"])
def test_tensor_parallel_step(steps, ref):
    ranks, one, want, before = steps
    want = one if ref == "port" else want
    stem = next(k for k in want["params"] if k.endswith("kernel"))
    assert np.abs(want["params"][stem] - before[stem]).max() > 1e-3 * np.abs(before[stem]).max()
    for rank, r in enumerate(ranks):
        tp = r["tp"]
        assert tp["sharded"] > 10
        assert_close(f"tp loss vs {ref}, rank {rank}", tp["parts"]["loss"],
                     want["parts"]["loss"], atol=0, rtol=2e-4)
        assert_close(f"tp parameter update / leaf scale vs {ref}, rank {rank}",
                     _leafwise(tp["params"], want["params"], minus=before), 0.0, atol=2e-2)


def test_k_steps_under_the_group(steps):
    for r in steps[0]:
        k = r["k_steps"]
        assert len(k["loss"]) == 2 and all(np.isfinite(k["loss"]))
        for name in k["single"]:
            np.testing.assert_array_equal(k["multi"][name], k["single"][name], err_msg=name)


@pytest.mark.parametrize("epoch", [0, 5])
@pytest.mark.parametrize("mode", ["plain", "fuseab", "distill"])
def test_loss_shares_sum_to_the_global_loss(steps, mode, epoch):
    whole = all_losses(slice(0, B), None, epoch)[mode]
    shares = [r["losses"][epoch][mode] for r in steps[0]]
    assert_close(f"{mode} loss", sum(s[0] for s in shares), whole[0], atol=0, rtol=1e-5)
    for k, v in whole[1].items():
        assert_close(f"{mode} {k}", sum(s[1][k] for s in shares), v, atol=1e-7, rtol=1e-5)
    for i, g in enumerate(whole[2]):  # the output gradients of each rank's rows
        got = np.concatenate([s[2][i] for s in shares])
        assert_close(f"{mode} output gradient {i}", got, g,
                     atol=1e-5 * float(np.abs(g).max() + 1e-30))
