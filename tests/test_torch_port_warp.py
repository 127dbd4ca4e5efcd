"""Image-space strong augmentation: the port's host planner
(``data/augment.py``) and both warp executors (``ops/warp.py``) against the
JAX package's, on the plans of tests/test_augment.py at S = 64.

Tolerances: plans and labels bit-equal (the same NumPy code and generator
state); warps 2e-3 on the 0..255 scale (both run float32 elementwise
arithmetic in the same order; XLA may contract a multiply-add, so ulps of
255 differ).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event_representation_study_tpu.data import augment as jax_augment
from event_representation_study_tpu.ops import warp as jax_warp
from event_representation_study_tpu_torch.data import augment
from event_representation_study_tpu_torch.ops import warp
from torch_port_helpers import assert_close

S, B, C = 64, 4, 3
RECIPE = dict(mosaic=1.0, mixup=0.243, degrees=0.373, translate=0.245, scale=0.898,
              shear=0.602, fliplr=0.5, flipud=0.00856)
HYPS = {
    "affine": dict(mosaic=0.0, mixup=0.0, degrees=0.0, translate=0.3, scale=0.5, shear=0.0,
                   fliplr=0.5, flipud=0.5),
    "mosaic_mixup": dict(mosaic=1.0, mixup=0.5, degrees=0.0, translate=0.2, scale=0.4,
                         shear=0.0, fliplr=0.5, flipud=0.0),
    "recipe": RECIPE,
    "flip": dict(mosaic=0.0, mixup=0.0, degrees=0.0, translate=0.0, scale=0.0, shear=0.0,
                 fliplr=1.0, flipud=0.0),
    "mixup": dict(mosaic=0.0, mixup=1.0, degrees=0.0, translate=0.0, scale=0.0, shear=0.0,
                  fliplr=0.0, flipud=0.0),
    "rotate_shear": dict(mosaic=1.0, mixup=0.5, degrees=10.0, translate=0.2, scale=0.5,
                         shear=2.0, fliplr=0.5, flipud=0.0),
}


def _labels(seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(B):
        n = int(rng.integers(0, 4))
        xy = rng.uniform(0, S * 0.6, (n, 2))
        wh = rng.uniform(4, S * 0.4, (n, 2))
        out.append(np.concatenate([rng.integers(0, 2, (n, 1)), xy, xy + wh], 1).astype(np.float32))
    return out


def _plans(name, seed=1):
    labels = _labels(seed)
    got = augment.plan_augment_batch(labels, S, HYPS[name], np.random.default_rng(seed), 16)
    want = jax_augment.plan_augment_batch(labels, S, HYPS[name], np.random.default_rng(seed), 16)
    return got, want


@pytest.mark.parametrize("name", list(HYPS))
def test_plan_augment_batch_bit_equal(name):
    (plan, lab, nl), (plan_j, lab_j, nl_j) = _plans(name)
    for k in plan_j:
        assert_close(f"plan {k}", plan[k], plan_j[k], atol=0)
    assert_close("labels", lab, lab_j, atol=0)
    assert_close("label counts", nl, nl_j, atol=0)


def test_plan_with_partner_pool_and_transform_matrix():
    labels = _labels(3) + _labels(4)[:2]
    got = augment.plan_augment_batch(labels, S, RECIPE, np.random.default_rng(2), 16, n_out=B)
    want = jax_augment.plan_augment_batch(labels, S, RECIPE, np.random.default_rng(2), 16,
                                          n_out=B)
    for g, w in zip(got[1:], want[1:]):
        assert_close("pool labels", g, w, atol=0)
    for k in want[0]:
        assert_close(f"pool plan {k}", got[0][k], want[0][k], atol=0)
    import random

    m, s = augment.get_transform_matrix((S, S), (S, S), 5.0, 0.5, 2.0, 0.2, random.Random(7))
    mj, sj = jax_augment.get_transform_matrix((S, S), (S, S), 5.0, 0.5, 2.0, 0.2,
                                              random.Random(7))
    assert_close("transform matrix", m, mj, atol=0)
    assert s == sj


def _images(seed=0):
    return np.random.default_rng(seed).uniform(0, 255, (B, S, S, C)).astype(np.float32)


EXECUTORS = {"exact": None, "separable_pad16": 16, "separable_pad192": 192}


@pytest.mark.parametrize("executor", list(EXECUTORS))
@pytest.mark.parametrize("name", list(HYPS))
def test_warp_matches_jax(name, executor):
    (plan, _, _), _ = _plans(name)
    imgs = _images()
    pad = EXECUTORS[executor]
    plan_t = warp.AugPlan(**plan)
    plan_j = jax_warp.AugPlan(**{k: jnp.asarray(v) for k, v in plan.items()})
    if pad is None:
        got = warp.compose_warp(torch.from_numpy(imgs), plan_t.to("cpu"), S)
        want = jax_warp.compose_warp(jnp.asarray(imgs), plan_j, S)
    else:
        # an ineligible plan (rotate_shear at pad 16) runs too: rows whose
        # roll overflows the pad degrade to the pad value in both
        assert warp.separable_eligible(plan_t, S, pad=pad) == jax_warp.separable_eligible(
            plan_j, S, pad=pad) == (name != "rotate_shear" or pad == 192)
        got = warp.compose_warp_separable(torch.from_numpy(imgs), plan_t.to("cpu"), S, pad=pad)
        want = jax_warp.compose_warp_separable(jnp.asarray(imgs), plan_j, S, pad=pad)
    assert got.shape == (B, S, S, C)
    assert_close(f"{executor} 0..255", got.numpy(), np.asarray(want), atol=2e-3)


def test_identity_plan_and_separable_bf16_gather():
    """The identity plan reproduces its input; the bf16 ``gather_dtype``
    path (K3's 2-byte case) matches JAX's bf16 path."""
    imgs = _images(1)
    ident = warp.identity_plan(B, S).to("cpu")
    assert_close("identity", warp.compose_warp(torch.from_numpy(imgs), ident, S).numpy(),
                 imgs, atol=1e-4)
    (plan, _, _), _ = _plans("recipe", seed=4)
    got = warp.compose_warp_separable(torch.from_numpy(imgs), warp.AugPlan(**plan).to("cpu"), S,
                                      gather_dtype=torch.bfloat16, pad=16)
    want = jax_warp.compose_warp_separable(
        jnp.asarray(imgs), jax_warp.AugPlan(**{k: jnp.asarray(v) for k, v in plan.items()}), S,
        gather_dtype=jnp.bfloat16, pad=16)
    assert_close("bf16 gather 0..255", got.numpy(), np.asarray(want), atol=2e-3)


@pytest.mark.parametrize("hyp", [
    dict(degrees=0.373, scale=0.898, shear=0.602),
    dict(degrees=30.0, scale=0.5),
    dict(scale=1.0),
    dict(degrees=5.0, scale=0.5, shear=3.0),
], ids=["recipe", "rotation", "singular", "moderate"])
@pytest.mark.parametrize("out_size", [64, 640])
def test_separable_hyp_eligible_answers_equal(hyp, out_size):
    assert warp.separable_hyp_eligible(hyp, out_size) == jax_warp.separable_hyp_eligible(
        hyp, out_size)
