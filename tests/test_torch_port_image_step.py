"""One whole train step of the port on an augmented image-folder batch
(``data.type=images``: the loader's 0..255 RGB tiles, the separable warp,
the shrunk paper detector at 3 channels, ATSS, SGD past its warmup)
against the JAX package's ``make_train_step(representation=None,
warp_impl="separable")`` in float32 from the same converted random weights,
at 64 px on 4 tiles plus a partner pool of 2
(``torch_port_helpers.image_step_batch``).

Tolerances: loss terms 1e-4 relative, positive anchors equal. The epoch is
an ATSS one: with the class preds at their init, TAL weighs the box terms
~1e-6. The gradients are held in float64 in
test_torch_port_image_step_f64.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from event_representation_study_tpu.ops import warp as jax_warp
from event_representation_study_tpu.parallel import train_step as jax_train_step
from event_representation_study_tpu_torch.parallel.train_step import TrainState, make_train_step
from event_representation_study_tpu_torch.train import optim
from event_representation_study_tpu_torch.train.ema import ema_init
from event_representation_study_tpu_torch.train.losses import LossConfig
from torch_port_helpers import (
    IMAGE_STEP,
    assert_close,
    image_step_batch,
    image_step_models,
    jax_image_step,
)


@pytest.fixture(scope="module")
def image_step(tmp_path_factory):
    c = IMAGE_STEP
    batch = image_step_batch(tmp_path_factory.mktemp("image_step"))
    assert batch.images.shape == (6, c["S"], c["S"], 3) and batch.gt_labels.shape[0] == 4
    loss_kw, variables, jax_model, model = image_step_models(np.float32)
    _, want = jax_image_step(jax_model, loss_kw, variables, jax_train_step.Batch(
        batch.images, None, batch.gt_labels, batch.gt_bboxes, batch.gt_mask,
        jax_warp.AugPlan(*map(jnp.asarray, batch.aug))))
    opt = optim.build_optimizer(model, optim.SolverConfig(**c["SOLVER"]))
    opt.count = c["START_UPDATE"]
    step = make_train_step(LossConfig(**loss_kw), None, (c["S"], c["S"]), c["S"],
                           warp_impl="separable", update_ema=False, device="cpu")
    _, parts = step(TrainState(model, opt, ema_init(model), 0), batch, c["EPOCH"])
    return {k: float(v) for k, v in parts.items()}, want


@pytest.mark.parametrize("term", ["loss", "cls", "iou", "dfl"])
def test_image_step_loss_like_jax(image_step, term):
    got, want = image_step
    assert_close(f"image step {term}", got[term], want[term], atol=0, rtol=1e-4)
    assert want[term] > 0


def test_image_step_positive_anchors_like_jax(image_step):
    got, want = image_step
    assert got["num_pos"] == want["num_pos"] > 0
