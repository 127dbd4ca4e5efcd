"""The detector's training variants, port against JAX on the CPU: the
fuse-ab and distill_ns heads and the losses that read them.

- ``EffiDeHeadFuseAB`` / ``EffiDeHeadDistillNS`` at 3 levels (strides 8,
  16, 32 on a 128 px frame), na = 3 priors a level, on the same random
  weights (carried by ``utils/convert.py``, the ab and dist preds 1x1 convs):
  every train output to 1e-4 of its largest entry, the eval decode's boxes
  to 1e-3 px and scores to 1e-4;
- ``detection_loss(..., return_aux=True)``; ``detection_loss_fuseab`` with
  na 1 and 3 (TAL topk 26, anchor points tiled per level); each KD term;
  ``distill_weight_decay``; ``detection_loss_distill`` plain (ATSS epoch)
  and ns (``reg_lrtb``, TAL): values rtol 1e-5, input gradients rtol 1e-4
  plus 1e-4 of the gradient's largest entry. The class KD term at T = 20
  sums ~10^3 near-cancelling KL terms in float32: both packages sit ~4e-5
  from its float64 value, so it, and the class and total losses that hold
  it, are held to 5e-5 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event_representation_study_tpu.models import heads as jax_heads
from event_representation_study_tpu.models.yolo import _default_anchors as jax_default_anchors
from event_representation_study_tpu.train import losses as jax_losses
from event_representation_study_tpu.train import losses_variants as jax_lv
from event_representation_study_tpu_torch.models import heads
from event_representation_study_tpu_torch.models.yolo import _default_anchors
from event_representation_study_tpu_torch.train import losses, losses_variants as lv
from event_representation_study_tpu_torch.utils.convert import flax_to_torch
from torch_port_helpers import assert_close, close_to_scale, nchw, nhwc, random_variables

STRIDES = (8, 16, 32)
CH = (16, 32, 64)
IMG = 128
SHAPES = [(IMG // s, IMG // s) for s in STRIDES]
B, M, NC, REG_MAX = 2, 4, 2, 16
KD_CLS_RTOL = 5e-5  # float32 noise of the T = 20 class KL (module docstring)


def _feats(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, h, w, c)).astype(np.float32) for (h, w), c in zip(SHAPES, CH)]


def _head_pair(kind):
    feats = _feats()
    if kind == "fuseab":
        jm = jax_heads.EffiDeHeadFuseAB(num_classes=NC, in_channels=CH,
                                        anchors=jax_default_anchors(STRIDES), strides=STRIDES)
        pm = heads.EffiDeHeadFuseAB(NC, CH, CH, _default_anchors(STRIDES), STRIDES)
    else:
        jm = jax_heads.EffiDeHeadDistillNS(num_classes=NC, in_channels=CH, strides=STRIDES)
        pm = heads.EffiDeHeadDistillNS(NC, CH, CH, STRIDES)
    assert _default_anchors(STRIDES) == jax_default_anchors(STRIDES)
    variables = random_variables(jm, [jnp.asarray(f) for f in feats], seed=2, train=True)
    pm.load_state_dict(flax_to_torch(variables), strict=True)
    return jm, variables, pm, feats


@pytest.fixture(scope="module", params=["fuseab", "distill_ns"])
def head_outputs(request):
    jm, variables, pm, feats = _head_pair(request.param)
    train_j = jax.jit(lambda v, f: jm.apply(v, f, True, mutable=["batch_stats"])[0])(
        variables, feats)
    eval_j = np.asarray(jax.jit(lambda v, f: jm.apply(v, f, False))(variables, feats))
    x = [nchw(f) for f in feats]
    with torch.no_grad():  # eval first: a train-mode forward updates the statistics
        eval_p = pm.eval()(x).numpy()
        train_p = pm.train()(x)
    return request.param, train_j, train_p, eval_j, eval_p


def test_head_train_outputs(head_outputs):
    kind, train_j, train_p, _, _ = head_outputs
    assert len(train_p) == len(train_j) == (5 if kind == "fuseab" else 4)
    for i, (fj, fp) in enumerate(zip(train_j[0], train_p[0])):
        close_to_scale(f"{kind} stem feats {i}", nhwc(fp), np.asarray(fj))
    names = (["cls_ab", "reg_ab", "cls_af", "reg_af"] if kind == "fuseab"
             else ["cls", "reg_lrtb", "reg_dist"])
    for name, j, p in zip(names, train_j[1:], train_p[1:]):
        close_to_scale(f"{kind} {name}", p.numpy(), np.asarray(j))


def test_head_eval_decode(head_outputs):
    kind, _, _, eval_j, eval_p = head_outputs
    assert eval_p.shape == eval_j.shape == (B, sum(h * w for h, w in SHAPES), 5 + NC)
    assert_close(f"{kind} eval boxes (px)", eval_p[..., :4], eval_j[..., :4], atol=1e-3)
    assert_close(f"{kind} eval scores", eval_p[..., 4:], eval_j[..., 4:], atol=1e-4)


def _gt(seed=3):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(10, 80, (B, M, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(16, 45, (B, M, 2))], -1).astype(np.float32)
    labels = rng.integers(0, NC, (B, M)).astype(np.int32)
    mask = np.ones((B, M), np.float32)
    mask[1, 3] = 0.0
    return jnp.asarray(labels), jnp.asarray(boxes), jnp.asarray(mask)


def _torch_gt(gt):
    labels, boxes, mask = (np.asarray(a) for a in gt)
    return torch.from_numpy(labels).long(), torch.from_numpy(boxes), torch.from_numpy(mask)


CFG = dict(num_classes=NC, strides=STRIDES)


def _check_grads(what, got, want):
    for k in want:
        g, w = got[k], np.asarray(want[k])
        assert_close(f"{what} d/d{k}", g, w, atol=1e-4 * float(np.abs(w).max()) + 1e-12,
                     rtol=1e-4)


@pytest.mark.parametrize("na", [1, 3])
def test_detection_loss_fuseab(na):
    rng = np.random.default_rng(5 + na)
    n = na * sum(h * w for h, w in SHAPES)
    cls = (1 / (1 + np.exp(-rng.normal(-1.0, 1.5, (B, n, NC))))).astype(np.float32)
    reg = np.concatenate([rng.normal(0, 0.5, (B, n, 2)), rng.uniform(0.5, 6, (B, n, 2))],
                         -1).astype(np.float32)
    gt = _gt()
    cfg_j = jax_losses.LossConfig(**CFG)

    def f(c, r):
        return jax_lv.detection_loss_fuseab(c, r, *gt, SHAPES, cfg_j, na=na)

    (loss_j, parts_j), grads_j = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        jnp.asarray(cls), jnp.asarray(reg))
    c, r = torch.from_numpy(cls).requires_grad_(True), torch.from_numpy(reg).requires_grad_(True)
    loss, parts = lv.detection_loss_fuseab(c, r, *_torch_gt(gt), SHAPES,
                                           losses.LossConfig(**CFG), na=na)
    loss.backward()
    assert float(parts["ab_num_pos"]) == float(parts_j["ab_num_pos"]) > 0
    for k in ("ab_cls", "ab_iou"):
        assert_close(f"fuseab na={na} {k}", float(parts[k]), float(parts_j[k]), atol=0,
                     rtol=1e-5)
    assert_close(f"fuseab na={na} loss", float(loss), float(loss_j), atol=0, rtol=1e-5)
    _check_grads(f"fuseab na={na}", {"cls": c.grad.numpy(), "reg": r.grad.numpy()},
                 {"cls": grads_j[0], "reg": grads_j[1]})


def test_distill_weight_decay():
    for e in (0, 1, 37, 50, 100):
        assert_close(f"distill_weight_decay({e}, 100)", float(lv.distill_weight_decay(e, 100)),
                     float(jax_lv.distill_weight_decay(jnp.int32(e), 100)), atol=0, rtol=1e-6)


def _student_teacher(seed):
    rng = np.random.default_rng(seed)
    a = sum(h * w for h, w in SHAPES)

    def outs(scale):
        feats = [rng.normal(0, scale, (B, h, w, c)).astype(np.float32)
                 for (h, w), c in zip(SHAPES, CH)]
        cls = (1 / (1 + np.exp(-rng.normal(-2.0, 1.5, (B, a, NC))))).astype(np.float32)
        dist = rng.normal(0, 2.0, (B, a, 4 * (REG_MAX + 1))).astype(np.float32)
        return feats, cls, dist

    lrtb = rng.uniform(0.2, 4.0, (B, a, 4)).astype(np.float32)
    return outs(1.0), outs(1.5), lrtb


@pytest.mark.parametrize("term", ["cls", "dfl", "cw"])
def test_kd_terms(term):
    (sf, sc, sd), (tf, tc, td), _ = _student_teacher(11)
    if term == "cls":
        jf, args_j = jax_lv.kd_cls_loss, (sc, tc, 20.0)
        pf, args_p = lv.kd_cls_loss, (sc, tc, 20.0)
    elif term == "dfl":
        rng = np.random.default_rng(12)
        fg = rng.random((B, sd.shape[1])) < 0.1
        bw = (rng.random((B, sd.shape[1])) * fg).astype(np.float32)
        extra = (fg, bw, np.float32(7.5), REG_MAX, 20.0)
        jf, args_j = jax_lv.kd_dfl_loss, (sd, td) + extra
        pf, args_p = lv.kd_dfl_loss, (sd, td, torch.from_numpy(fg), torch.from_numpy(bw),
                                      torch.tensor(7.5), REG_MAX, 20.0)
    else:
        jf, args_j = jax_lv.kd_cw_loss, (sf, tf)
        pf, args_p = lv.kd_cw_loss, ([nchw(f) for f in sf], [nchw(f) for f in tf])
    val_j, g_j = jax.value_and_grad(lambda s: jf(s, *args_j[1:]))(
        [jnp.asarray(f) for f in args_j[0]] if term == "cw" else jnp.asarray(args_j[0]))
    if term == "cw":
        s = [t.clone().requires_grad_(True) for t in args_p[0]]
    else:
        s = torch.from_numpy(np.asarray(args_p[0])).requires_grad_(True)
    rest = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args_p[1:]]
    val = pf(s, *rest)
    val.backward()
    assert_close(f"kd_{term}", float(val), float(val_j), atol=0,
                 rtol=KD_CLS_RTOL if term == "cls" else 1e-5)
    if term == "cw":
        _check_grads("kd_cw", {i: nhwc(t.grad) for i, t in enumerate(s)},
                     {i: g for i, g in enumerate(g_j)})
    else:
        _check_grads(f"kd_{term}", {"s": s.grad.numpy()}, {"s": g_j})


@pytest.mark.parametrize("variant", ["plain", "ns"])
def test_detection_loss_distill(variant):
    (sf, sc, sd), (tf, tc, td), lrtb = _student_teacher(21)
    gt = _gt(4)
    ns = variant == "ns"
    cfg_j = jax_losses.LossConfig(**CFG, warmup_epoch=0 if ns else 4)
    epoch = 3

    def f(sf_, sc_, sd_, lr_):
        return jax_lv.detection_loss_distill(
            (sf_, sc_, sd_), (tf, tc, td), *gt, SHAPES, epoch, 10, cfg_j, temperature=20.0,
            distill_feat=True, reg_lrtb=lr_ if ns else None)

    (loss_j, parts_j), g_j = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2, 3), has_aux=True))(
        [jnp.asarray(a) for a in sf], jnp.asarray(sc), jnp.asarray(sd), jnp.asarray(lrtb))
    s_feats = [nchw(a).clone().requires_grad_(True) for a in sf]
    s_cls, s_dist, s_lrtb = (torch.from_numpy(a).requires_grad_(True) for a in (sc, sd, lrtb))
    loss, parts = lv.detection_loss_distill(
        (s_feats, s_cls, s_dist), ([nchw(a) for a in tf], torch.from_numpy(tc),
                                   torch.from_numpy(td)),
        *_torch_gt(gt), SHAPES, epoch, 10, losses.LossConfig(**CFG, warmup_epoch=0 if ns else 4),
        temperature=20.0, distill_feat=True, reg_lrtb=s_lrtb if ns else None)
    loss.backward()
    assert float(parts["num_pos"]) == float(parts_j["num_pos"]) > 0
    for k in ("cls", "iou", "dfl", "kd_cls", "kd_dfl", "kd_cw"):
        assert_close(f"distill {variant} {k}", float(parts[k]), float(parts_j[k]), atol=0,
                     rtol=KD_CLS_RTOL if k in ("cls", "kd_cls") else 1e-5)
    assert_close(f"distill {variant} loss", float(loss), float(loss_j), atol=0,
                 rtol=KD_CLS_RTOL)
    got = {"cls": s_cls.grad.numpy(), "dist": s_dist.grad.numpy(),
           **{f"feat{i}": nhwc(t.grad) for i, t in enumerate(s_feats)}}
    want = {"cls": g_j[1], "dist": g_j[2], **{f"feat{i}": g for i, g in enumerate(g_j[0])}}
    if ns:
        got["lrtb"], want["lrtb"] = s_lrtb.grad.numpy(), g_j[3]
    _check_grads(f"distill {variant}", got, want)


def test_loss_aux_matches_jax():
    (_, sc, sd), _, _ = _student_teacher(31)
    gt = _gt(5)
    feats = [np.zeros((B, h, w, 1), np.float32) for h, w in SHAPES]
    _, _, aux_j = jax_losses.detection_loss((feats, sc, sd), *gt, SHAPES, 5,
                                            jax_losses.LossConfig(**CFG), return_aux=True)
    _, _, aux = losses.detection_loss(([nchw(f) for f in feats], torch.from_numpy(sc),
                                       torch.from_numpy(sd)), *_torch_gt(gt), SHAPES, 5,
                                      losses.LossConfig(**CFG), return_aux=True)
    assert np.array_equal(aux.fg_mask.numpy(), np.asarray(aux_j.fg_mask))
    for k in ("raw_cls", "raw_iou", "raw_dfl", "bbox_weight", "denom", "target_bboxes"):
        assert_close(f"LossAux.{k}", getattr(aux, k).numpy(), np.asarray(getattr(aux_j, k)),
                     atol=1e-6, rtol=1e-5)
