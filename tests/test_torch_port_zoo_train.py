"""Training the detector zoo, port against JAX on the CPU:

- one whole train step (ERGO-12 -> letterbox -> separable warp with mosaic
  and mixup -> detector -> TAL -> loss -> backward -> SGD) of a shrunk
  EfficientRep with RepVGG blocks (``training_mode="repvgg"``) from the same
  random weights at 128 px (``torch_port_helpers.zoo_step_pair``): loss
  terms, gradients, parameter updates, BatchNorm statistics; the ResNet50
  family's is ``test_torch_port_zoo_train_resnet.py``;
- ``iou_loss`` with diou, ciou and siou: values and gradients;
- ``SolverConfig.momentum_dtype="bfloat16"``: the updates and buffers of
  ``FusedSGD`` against the JAX fused SGD;
- ``param_groups`` against the JAX ``_group_of`` on a Swin tree (every
  LayerNorm ``scale`` in the no-decay ``bn`` group).

Tolerances: the whole step as ``test_torch_port_train_step.py`` (loss terms
1e-4 relative; gradients and updates 2e-2 of each leaf's largest JAX entry
plus 1e-3 of the largest over all leaves, an update's difference taken
beyond one float32 ulp of its parameter, the rounding of storing it;
BatchNorm statistics 2e-3 relative plus 1e-4). The class preds start at
their init, as a run does: random ones make the varifocal loss's gradient
swamp the step in float32 noise. IoU values 1e-6, their gradients 1e-5 relative; the
bf16-momentum updates 1e-6 of the parameter scale and the stored buffers
exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event_representation_study_tpu.models.swin_vit import SwinTransformerV2ViT
from event_representation_study_tpu.ops import boxes as jax_boxes
from event_representation_study_tpu.train import optim as jax_optim
from event_representation_study_tpu_torch.models.swin_vit import (
    SwinTransformerV2ViT as PortSwin,
)
from event_representation_study_tpu_torch.ops import boxes
from event_representation_study_tpu_torch.train import optim
from event_representation_study_tpu_torch.utils.convert import to_flax_leaves
from torch_port_helpers import ZOO_STEP_PARTS, assert_close, check_zoo_step, zoo_step_pair


@pytest.fixture(scope="module")
def step_pair():
    return zoo_step_pair("gen1_efficientrep")


@pytest.mark.parametrize("part", ZOO_STEP_PARTS)
def test_efficientrep_repvgg_step(step_pair, part):
    check_zoo_step("efficientrep_repvgg", part, *step_pair)


@pytest.mark.parametrize("iou_type", ["iou", "giou", "diou", "ciou", "siou"])
def test_iou_loss_values_and_gradients(iou_type):
    rng = np.random.default_rng(4)
    xy = rng.uniform(0, 50, (64, 2))
    b1 = np.concatenate([xy, xy + rng.uniform(2, 30, (64, 2))], 1).astype(np.float32)
    xy = xy + rng.normal(0, 6, (64, 2))
    b2 = np.concatenate([xy, xy + rng.uniform(2, 30, (64, 2))], 1).astype(np.float32)

    def jax_sum(a, b):
        return jnp.sum(jax_boxes.iou_loss(a, b, iou_type))

    want = np.asarray(jax_boxes.iou_loss(b1, b2, iou_type))
    gj = np.asarray(jax.grad(jax_sum)(jnp.asarray(b1), jnp.asarray(b2)))
    t1 = torch.from_numpy(b1).requires_grad_(True)
    got = boxes.iou_loss(t1, torch.from_numpy(b2), iou_type)
    got.sum().backward()
    assert_close(f"{iou_type} value", got.detach().numpy(), want, atol=1e-6)
    assert_close(f"{iou_type} grad", t1.grad.numpy(), gj, atol=1e-7, rtol=1e-5)


def test_iou_loss_unknown_type():
    with pytest.raises(ValueError, match="unknown iou_type"):
        boxes.iou_loss(torch.zeros(1, 4), torch.zeros(1, 4), "wiou")


def test_bf16_momentum_matches_jax():
    """12 updates with momentum stored in bf16 across the warmup boundary
    (update 995 on): the parameters after each update and the stored
    buffers, against the JAX fused SGD with ``momentum_dtype='bfloat16'``."""
    cfg = dict(epochs=10, steps_per_epoch=100, momentum_dtype="bfloat16")
    rng = np.random.default_rng(5)
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.BatchNorm2d(4))
    init = {n: rng.normal(0, 0.3, p.shape).astype(np.float32) for n, p in model.named_parameters()}
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.from_numpy(init[n]))
    tx = optim.build_optimizer(model, optim.SolverConfig(**cfg))
    tx.count = 995
    assert all(m.dtype == torch.bfloat16 for m in tx.momentum.values())
    # the JAX tree with the port's names as paths, leaves in the port's layout
    # (the optimizer is elementwise; only the group of a leaf matters)
    leaf = {"0.weight": "kernel", "0.bias": "bias", "1.weight": "scale", "1.bias": "bias"}
    params = {n: {leaf[n]: jnp.asarray(v)} for n, v in init.items()}
    tx_j = jax_optim.build_fused_sgd(params, jax_optim.SolverConfig(**cfg))
    st = tx_j.init(params)._replace(count=jnp.int32(995))
    for i in range(12):
        grads = {n: rng.normal(0, 1.0, v.shape).astype(np.float32) for n, v in init.items()}
        upd, st = tx_j.update({n: {leaf[n]: jnp.asarray(g)} for n, g in grads.items()}, st,
                              params)
        params = jax.tree.map(lambda p, u: p + u, params, upd)
        tx.update({n: torch.from_numpy(g) for n, g in grads.items()})
        for n, p in model.named_parameters():
            w = np.asarray(params[n][leaf[n]])
            assert_close(f"bf16 momentum step {i} {n}", p.detach().numpy(), w,
                         atol=1e-6 * float(np.abs(w).max()))
            m = tx.momentum[n].to(torch.float32).numpy()
            assert_close(f"bf16 buffer step {i} {n}", m,
                         np.asarray(st.momentum[n][leaf[n]].astype(jnp.float32)), 0.0)


def test_param_groups_match_jax_on_swin():
    """Every Flax ``scale`` (the Swin's LayerNorms too) in ``bn``; biases in
    ``bias``; kernels, ``logit_scale`` in ``weight``."""
    swin = dict(embed_dim=16, depths=(1, 1, 1, 1), num_heads=(1, 1, 2, 2), window_size=4)
    jm = SwinTransformerV2ViT(**swin)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 12)))
    want = {}
    for path, _ in jax.tree_util.tree_flatten_with_path(shapes["params"])[0]:
        want["params/" + "/".join(p.key for p in path)] = jax_optim._group_of(path)
    model = PortSwin(12, **swin)
    params = dict(model.named_parameters())
    got = {next(iter(to_flax_leaves({n: params[n]}))): g
           for g, ns in optim.param_groups(model).items() for n in ns}
    assert got == want
    assert sum(g == "bn" for g in got.values()) == sum(
        isinstance(m, torch.nn.LayerNorm) for m in model.modules())
