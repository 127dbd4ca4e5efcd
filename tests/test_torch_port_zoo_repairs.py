"""The paper backbone's two config options that the port once ignored,
against JAX on the CPU: ``model.backbone.space_to_depth`` (a 2x2
pixel-unshuffle stem with a stride-1 conv, another weight shape) and
``model.remat`` (the BepC3 stages recomputed in backward, their BatchNorm
statistics updated once, as under ``nn.remat``).

Tolerance: float32; decoded boxes 1e-3 px and scores 1e-4; the remat
gradients over each leaf's scale 2e-2 against JAX (as the whole-step
tests) and 1e-6 against the port without remat.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event_representation_study_tpu.models import yolo as JY
from event_representation_study_tpu_torch.models import backbones as TB
from event_representation_study_tpu_torch.models import yolo as TY
from event_representation_study_tpu_torch.utils.config import load_config
from event_representation_study_tpu_torch.utils.convert import flax_to_torch, to_flax_leaves
from torch_port_helpers import (
    SMALL,
    assert_close,
    eval_outputs,
    jax_leaves,
    nchw,
    nhwc,
    random_variables,
)


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _paper_small(*overrides):
    return load_config("configs/gen1_optimized.py", overrides=[*SMALL, *overrides])


def test_space_to_depth_matches_jax():
    """The stem takes 48 channels at stride 1 in the JAX order (dy, dx, c
    with c fastest), which ``F.pixel_unshuffle`` (c, dy, dx) is not; the
    detector's eval output is JAX's."""
    x = _x((2, 64, 64, 12), 11)
    got = TB.space_to_depth(nchw(x))
    b, h, w, c = x.shape
    want = x.reshape(b, h // 2, 2, w // 2, 2, c).transpose(0, 1, 3, 2, 4, 5).reshape(
        b, h // 2, w // 2, 4 * c)
    assert_close("s2d order", nhwc(got), want, 0.0)
    assert not torch.equal(torch.nn.functional.pixel_unshuffle(nchw(x), 2), got)

    cfg = _paper_small("model.backbone.space_to_depth=True")
    jm = JY.build_model(cfg, num_classes=2)
    variables = random_variables(jm, jnp.asarray(x), seed=6)
    model = TY.build_model(cfg, 2, device="cpu")
    model.load_state_dict(flax_to_torch(variables), strict=True)
    assert model.backbone.stem.conv.weight.shape[1:] == (48, 3, 3)
    got, want = eval_outputs(jm, variables, model, x)
    assert_close("s2d boxes px", got[..., :4], want[..., :4], atol=1e-3)
    assert_close("s2d scores", got[..., 4:], want[..., 4:], atol=1e-4)


def _port_run(model, x):
    model.train().zero_grad()
    _, cls, reg = model(nchw(x))
    loss = (cls ** 2).sum() + (reg ** 2).mean()
    loss.backward()
    return (loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()},
            {k: v.clone() for k, v in model.state_dict().items() if "running" in k})


@pytest.fixture(scope="module")
def remat_runs():
    """One train-mode forward/backward of the shrunk paper detector at 128²
    (batch 4) with ``model.remat``, in JAX and in the port, and the port's
    without; the class preds at their zero init, so that the reg branch
    carries the gradient into the stages."""
    cfg = _paper_small("model.remat=True")
    jm = JY.build_model(cfg, num_classes=2)
    x = _x((4, 128, 128, 12), 12)  # >= 16 values a channel in the stride-64 BatchNorms
    variables = random_variables(jm, jnp.asarray(x), seed=7)
    for name, leaf in variables["params"]["head"].items():  # class preds at init
        if name.startswith("cls_pred_"):
            leaf["kernel"] = np.zeros_like(leaf["kernel"])

    def jloss(params, stats):
        (_, cls, reg), upd = jm.apply({"params": params, "batch_stats": stats}, x, True,
                                      mutable=["batch_stats"])
        return (cls ** 2).sum() + (reg ** 2).mean(), upd

    (lj, updj), gj = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"], variables["batch_stats"])
    out = {"jax": (float(lj), jax_leaves(gj, "params"),
                   jax_leaves(updj["batch_stats"], "batch_stats"))}
    for remat in (True, False):
        model = TY.build_model(_paper_small(f"model.remat={remat}"), 2, device="cpu")
        model.load_state_dict(flax_to_torch(variables), strict=True)
        assert model.backbone.remat is remat
        out[remat] = _port_run(model, x)
    return out


def test_remat_matches_no_remat(remat_runs):
    """The recompute leaves the BN statistics updated once and the
    gradients those of the plain forward."""
    (l1, g1, s1), (l0, g0, s0) = remat_runs[True], remat_runs[False]
    assert l1 == l0
    for k in s0:
        assert torch.equal(s1[k], s0[k]), k
    for n in g0:
        assert_close(f"remat grad {n}", g1[n].numpy(), g0[n].numpy(),
                     atol=1e-6 * float(g0[n].abs().max()) + 1e-12)


def test_remat_matches_jax(remat_runs):
    """Against JAX's ``nn.remat``: loss, BN statistics, and gradients over
    each leaf's scale."""
    lj, gj, sj = remat_runs["jax"]
    lp, gp, sp = remat_runs[True]
    assert_close("remat loss", lp, lj, atol=1e-4 * abs(lj))
    got_s = to_flax_leaves(sp)
    assert set(got_s) == set(sj)
    for k, w in sj.items():
        assert_close(f"remat {k}", got_s[k], w, atol=1e-4, rtol=1e-3)
    got_g = to_flax_leaves(gp)
    assert set(got_g) == set(gj)
    top = max(float(np.abs(v).max()) for v in gj.values())
    worst = max(float(np.abs(got_g[k] - w).max() / (np.abs(w).max() + 1e-3 * top))
                for k, w in gj.items())
    assert_close("remat grads over leaf scale", worst, 0.0, atol=2e-2)
