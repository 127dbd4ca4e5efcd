"""Training math of the port against the JAX package on the same NumPy
inputs: anchors, boxes, the ATSS and task-aligned assigners (ties
included), the detection loss, the 3-group SGD with accumulation, the EMA
and the BatchNorm running-variance update.

Tolerances: assignments (labels, boxes, foreground) exactly; target scores
and loss terms 1e-5 relative (float32 reductions in another order); the
optimizer trajectory 1e-5 absolute on O(1) weights over 2,200 microsteps
(per-update ulps of float32 accumulate); EMA 1e-6; BatchNorm statistics
1e-5 (different float32 variance formulas).
"""
import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from event_representation_study_tpu.ops import boxes as jax_boxes
from event_representation_study_tpu.train import anchors as jax_anchors
from event_representation_study_tpu.train import assigners as jax_assigners
from event_representation_study_tpu.train import ema as jax_ema
from event_representation_study_tpu.train import losses as jax_losses
from event_representation_study_tpu.train import optim as jax_optim
from event_representation_study_tpu_torch.models.layers import BatchNorm2d
from event_representation_study_tpu_torch.ops import boxes
from event_representation_study_tpu_torch.train import anchors, assigners, ema, losses, optim
from torch_port_helpers import assert_close

FEATS = [(16, 16), (8, 8), (4, 4), (2, 2)]  # a 128-px frame
STRIDES = (8, 16, 32, 64)
NC = 2


def _t(a):
    return torch.from_numpy(np.array(a))


def _gt(seed, B=2, M=6, n_valid=(4, 2)):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 90, (B, M, 2))
    wh = rng.uniform(12, 60, (B, M, 2))
    bboxes = np.concatenate([xy, np.minimum(xy + wh, 127.0)], -1).astype(np.float32)
    labels = rng.integers(0, NC, (B, M)).astype(np.int32)
    mask = (np.arange(M)[None] < np.asarray(n_valid)[:, None]).astype(np.float32)
    return labels, bboxes, mask


def _preds(seed, B=2, tie=False):
    """Predicted scores (B, A, nc) and image-unit boxes (B, A, 4) around the
    anchors; ``tie`` makes every anchor predict the same score and box, so
    the align metric ties across each GT's anchors."""
    A = sum(h * w for h, w in FEATS)
    rng = np.random.default_rng(seed)
    _, pts, _, _ = jax_anchors.generate_anchors_train(FEATS, STRIDES)
    pts = np.asarray(pts)
    if tie:
        scores = np.full((B, A, NC), 0.5, np.float32)
        bx = np.broadcast_to(np.array([30.0, 30.0, 90.0, 90.0], np.float32), (B, A, 4)).copy()
        return scores, bx
    scores = rng.uniform(0.01, 0.99, (B, A, NC)).astype(np.float32)
    half = rng.uniform(4, 40, (B, A, 2))
    bx = np.concatenate([pts - half, pts + half], -1).astype(np.float32)
    return scores, bx


def test_anchors_and_boxes():
    got = anchors.generate_anchors_train(FEATS, STRIDES)
    want = jax_anchors.generate_anchors_train(FEATS, STRIDES)
    for name, g, w in zip(("cells", "points", "counts", "strides"), got, want):
        assert_close(name, np.asarray(g), np.asarray(w), atol=0)
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 50, (3, 7, 2))
    b1 = np.concatenate([xy, xy + rng.uniform(1, 30, (3, 7, 2))], -1).astype(np.float32)
    b2 = (b1 + rng.normal(0, 5, b1.shape)).astype(np.float32)
    for t in ("iou", "giou", "diou", "ciou", "siou"):
        assert_close(t, boxes.iou_loss(_t(b1), _t(b2), t).numpy(),
                     np.asarray(jax_boxes.iou_loss(b1, b2, t)), atol=1e-6)
    pts = rng.uniform(10, 40, (3, 7, 2)).astype(np.float32)
    assert_close("bbox2dist", boxes.bbox2dist(_t(pts), _t(b1), 16).numpy(),
                 np.asarray(jax_boxes.bbox2dist(pts, b1, 16)), atol=1e-6)
    assert_close("xyxy2xywh", boxes.xyxy2xywh(_t(b1)).numpy(),
                 np.asarray(jax_boxes.xyxy2xywh(b1)), atol=1e-6)
    with pytest.raises(ValueError, match="unknown iou_type"):
        boxes.iou_loss(_t(b1), _t(b2), "wiou")


def _compare_assignment(got, want):
    names = ("target_labels", "target_bboxes", "target_scores", "fg_mask")
    for name, g, w in zip(names, got, want):
        g, w = g.numpy(), np.asarray(w)
        if name == "target_scores":
            assert_close(name, g, w, atol=1e-6, rtol=1e-5)
        elif name == "fg_mask":
            assert_close(name, g, w, atol=0)
        else:
            # background anchors carry whatever GT row 0 holds; compare the
            # assigned ones
            fg = np.asarray(want[3]).astype(bool)
            assert_close(f"{name} (foreground)", g[fg], w[fg], atol=0)


@pytest.mark.parametrize("case", ["random", "tied", "empty_gt"])
def test_task_aligned_assigner(case):
    labels, bboxes, mask = _gt(1)
    if case == "empty_gt":
        mask[:] = 0
    scores, pd = _preds(2, tie=case == "tied")
    _, pts, _, _ = jax_anchors.generate_anchors_train(FEATS, STRIDES)
    args = (scores, pd, np.asarray(pts), labels[..., None].astype(np.float32), bboxes,
            mask[..., None])
    got = assigners.task_aligned_assigner(*map(_t, args))
    want = jax_assigners.task_aligned_assigner(*args)
    _compare_assignment(got, want)
    n_fg = int(np.asarray(want[3]).sum())
    assert (n_fg == 0) if case == "empty_gt" else n_fg > 0
    if case == "tied":
        # every candidate ties: the 13 lowest anchor indices inside a GT win
        assert int(got[3].sum()) == n_fg


@pytest.mark.parametrize("case", ["random", "tied", "empty_gt"])
def test_atss_assigner(case):
    labels, bboxes, mask = _gt(3)
    if case == "tied":
        # GT centres on cell corners: candidate distances tie in pairs/fours
        c = np.array([[32.0, 32.0], [64.0, 48.0], [48.0, 96.0]], np.float32)
        bboxes[:, :3] = np.concatenate([c - 20, c + 20], -1)
    if case == "empty_gt":
        mask[:] = 0
    _, pd = _preds(4)
    cells, _, counts, _ = jax_anchors.generate_anchors_train(FEATS, STRIDES)
    args = (np.asarray(cells), list(counts), labels[..., None].astype(np.float32), bboxes,
            mask[..., None], pd)
    got = assigners.atss_assigner(*map(_t, args[:1]), args[1], *map(_t, args[2:]), NC)
    want = jax_assigners.atss_assigner(*args, NC)
    _compare_assignment(got, want)
    n_fg = int(np.asarray(want[3]).sum())
    assert (n_fg == 0) if case == "empty_gt" else n_fg > 0


@pytest.mark.parametrize("epoch", [0, 5], ids=["atss", "tal"])
@pytest.mark.parametrize("gt", ["boxes", "empty"])
def test_detection_loss(epoch, gt):
    """Loss terms and their gradients with respect to the predictions. The
    empty case exercises the tss > 1 normalisation guard."""
    rng = np.random.default_rng(epoch)
    A = sum(h * w for h, w in FEATS)
    cls = rng.uniform(0.02, 0.98, (2, A, NC)).astype(np.float32)
    reg = rng.normal(0, 1, (2, A, 68)).astype(np.float32)
    labels, bboxes, mask = _gt(7)
    if gt == "empty":
        mask[:] = 0
    cfg = losses.LossConfig(NC)

    def jax_loss(c, r):
        return jax_losses.detection_loss((None, c, r), jnp.asarray(labels), jnp.asarray(bboxes),
                                         jnp.asarray(mask), FEATS, epoch,
                                         jax_losses.LossConfig(NC))

    (want, want_parts), want_g = jax.jit(
        jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(cls), jnp.asarray(reg))
    c_t, r_t = _t(cls).requires_grad_(), _t(reg).requires_grad_()
    got, parts = losses.detection_loss((None, c_t, r_t), _t(labels), _t(bboxes), _t(mask),
                                       FEATS, epoch, cfg)
    got.backward()
    assert_close("loss", got.item(), float(want), atol=0, rtol=1e-5)
    for k in ("cls", "iou", "dfl", "num_pos"):
        assert_close(k, parts[k].item(), float(want_parts[k]), atol=1e-7, rtol=1e-5)
    assert_close("d loss / d cls", c_t.grad.numpy(), np.asarray(want_g[0]), atol=1e-6, rtol=1e-4)
    assert_close("d loss / d reg", r_t.grad.numpy(), np.asarray(want_g[1]), atol=1e-6, rtol=1e-4)
    if gt == "empty":
        assert float(want_parts["num_pos"]) == 0


class _Tiny(nn.Module):
    """One of each parameter group: a conv kernel and bias, a BatchNorm
    scale and bias, a residual scale ``alpha``."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(2, 3, 3)
        self.bn = nn.BatchNorm2d(3)
        self.alpha = nn.Parameter(torch.ones(1))


# port name -> Flax-style path (the JAX optimizer groups by leaf name)
TINY = {"conv.weight": ("conv", "kernel"), "conv.bias": ("conv", "bias"),
        "bn.weight": ("bn", "scale"), "bn.bias": ("bn", "bias"), "alpha": ("blk", "alpha")}


def test_param_groups():
    assert optim.param_groups(_Tiny()) == {
        "weight": ["alpha", "conv.weight"], "bias": ["conv.bias", "bn.bias"],
        "bn": ["bn.weight"]}


def test_fused_sgd_with_accumulation_matches_jax():
    """2,200 microsteps with k = 2 and the accumulation ramp over the first
    40 microsteps, across the 1,000-update warmup boundary (the weight and
    BN groups start at LR 0, so a single step proves nothing) and several
    epochs of the LR staircase."""
    cfg = dict(epochs=15, steps_per_epoch=100, warmup_epochs=2.0)
    model = _Tiny()
    rng = np.random.default_rng(7)
    init = {n: rng.normal(0, 0.3, p.shape).astype(np.float32)
            for n, p in model.named_parameters()}
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(_t(init[n]))
    tx = optim.with_accumulation(optim.build_optimizer(model, optim.SolverConfig(**cfg)), 2, 40)

    def tree(d):
        out = {}
        for n, (mod, leaf) in TINY.items():
            out.setdefault(mod, {})[leaf] = jnp.asarray(d[n])
        return out

    params_j = tree(init)
    tx_j = jax_optim.with_accumulation(
        jax_optim.build_optimizer(params_j, jax_optim.SolverConfig(**cfg)), 2, 40)
    state_j = tx_j.init(params_j)

    @jax.jit
    def step_j(params, state, grads):
        upd, state = tx_j.update(grads, state, params)
        return optax.apply_updates(params, upd), state

    for i in range(2200):
        g_rng = np.random.default_rng(1000 + i)
        grads = {n: g_rng.normal(0, 0.5, p.shape).astype(np.float32)
                 for n, p in model.named_parameters()}
        tx.update({n: _t(g) for n, g in grads.items()})
        params_j, state_j = step_j(params_j, state_j, tree(grads))
        if i % 550 == 549:
            for n, (mod, leaf) in TINY.items():
                assert_close(f"{n} after {i + 1} microsteps",
                             dict(model.named_parameters())[n].detach().numpy(),
                             np.asarray(params_j[mod][leaf]), atol=1e-5)
    assert tx.count == int(state_j.inner_opt_state.count) > 1000
    assert_close("momentum", tx.inner.decay_m, jax_optim.find_momentum(state_j), atol=1e-7)


def test_ema_matches_jax():
    model = _Tiny()
    state = ema.ema_init(model)
    state_j = jax_ema.ema_init({k: jnp.asarray(v.numpy()) for k, v in state.variables.items()})
    rng = np.random.default_rng(3)
    for _ in range(5):
        with torch.no_grad():
            for v in model.state_dict().values():
                if v.is_floating_point():
                    v.add_(_t(rng.normal(0, 1, v.shape).astype(np.float32)))
        state = ema.ema_update(state, model)
        new = {k: jnp.asarray(v.numpy()) for k, v in model.state_dict().items()
               if v.is_floating_point()}
        state_j = jax_ema.ema_update(state_j, new)
    assert state.updates == int(state_j.updates) == 5
    assert "bn.running_var" in state.variables
    for k, v in state.variables.items():
        assert_close(k, v.numpy(), np.asarray(state_j.variables[k]), atol=1e-6)


def test_batchnorm_running_var_is_biased_like_flax():
    """Two train-mode steps of the port's BatchNorm2d against flax's
    BatchNorm(momentum=0.9) on the same NHWC input; torch's own update,
    which uses the unbiased variance, differs by n / (n - 1)."""
    rng = np.random.default_rng(0)
    xs = [rng.normal(1.0, 2.0, (2, 3, 3, 4)).astype(np.float32) for _ in range(2)]
    bn_j = flax_nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = bn_j.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))
    bn = BatchNorm2d(4, eps=1e-5, momentum=0.1).train()
    plain = nn.BatchNorm2d(4, eps=1e-5, momentum=0.1).train()
    for x in xs:
        y_j, upd = bn_j.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
        variables = {"params": variables["params"], **upd}
        y = bn(_t(x).permute(0, 3, 1, 2))
        plain(_t(x).permute(0, 3, 1, 2))
    stats = variables["batch_stats"]
    assert_close("output", y.permute(0, 2, 3, 1).detach().numpy(), np.asarray(y_j), atol=1e-5)
    assert_close("running_mean", bn.running_mean.numpy(), np.asarray(stats["mean"]), atol=1e-5)
    assert_close("running_var", bn.running_var.numpy(), np.asarray(stats["var"]), atol=1e-5)
    assert not np.allclose(plain.running_var.numpy(), np.asarray(stats["var"]), atol=1e-3)
    bn.eval()
    x = _t(xs[0]).permute(0, 3, 1, 2)
    assert torch.equal(bn(x), nn.BatchNorm2d.forward(bn, x))
