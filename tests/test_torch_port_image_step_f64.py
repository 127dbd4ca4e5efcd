"""The gradients of the image-folder train step
(test_torch_port_image_step.py's batch and weights) in float64, port
against JAX: the JAX step under ``jax.enable_x64`` with its detector built
in float64, the port's step ``loss_fn`` on a float64 model, both from the
port's warped input (the warp is held apart at 2e-3 in
test_torch_port_image_data.py).

In float32 these gradients are rounding-limited: on some draws of the
folder either package's float32 step lies 0.1-0.4 of a leaf's scale from
its own float64 one (train-mode BatchNorms over flat colour, letterbox pad
and a 1x1 stride-64 level at 64 px), so a float32 comparison would measure
rounding. Tolerances: loss 1e-6 relative; gradients 1e-6 of each leaf's
scale (``torch_port_helpers._leafwise``).
"""
import jax
import numpy as np
import pytest
import torch

from event_representation_study_tpu.parallel import train_step as jax_train_step
from event_representation_study_tpu_torch.parallel.train_step import (
    Batch,
    batch_on_device,
    make_train_step,
)
from event_representation_study_tpu_torch.train.losses import LossConfig
from event_representation_study_tpu_torch.utils.convert import to_flax_leaves
from torch_port_helpers import (
    IMAGE_STEP,
    _leafwise,
    assert_close,
    image_step_batch,
    image_step_models,
    jax_image_step,
    small_cfg,
)


@pytest.fixture(scope="module")
def image_step_f64(tmp_path_factory):
    c = IMAGE_STEP
    batch = image_step_batch(tmp_path_factory.mktemp("image_step_f64"))
    hd = small_cfg()["model"]["head"]
    warp_step = make_train_step(LossConfig(num_classes=2, strides=tuple(hd["strides"])), None,
                                (c["S"], c["S"]), c["S"], warp_impl="separable", device="cpu")
    imgs = warp_step.images_of(batch_on_device(batch, "cpu")).permute(0, 2, 3, 1)
    imgs = imgs.double().numpy()
    boxes, mask = batch.gt_bboxes.astype(np.float64), batch.gt_mask.astype(np.float64)
    with jax.enable_x64(True):
        loss_kw, variables, jax_model, model = image_step_models(np.float64)
        grads_j, parts_j = jax_image_step(jax_model, loss_kw, variables, jax_train_step.Batch(
            imgs, None, batch.gt_labels, boxes, mask))
    step = make_train_step(LossConfig(**loss_kw), None, (c["S"], c["S"]), c["S"], device="cpu")
    b64 = Batch(torch.from_numpy(imgs), None, torch.from_numpy(batch.gt_labels).long(),
                torch.from_numpy(boxes), torch.from_numpy(mask))
    loss, parts = step.loss_fn(model.train(), b64.images.permute(0, 3, 1, 2), b64, c["EPOCH"])
    loss.backward()
    assert {p.grad.dtype for p in model.parameters()} == {torch.float64}
    grads = to_flax_leaves({k: p.grad for k, p in model.named_parameters()})
    return float(loss), parts_j, grads, grads_j


def test_image_step_loss_float64_like_jax(image_step_f64):
    loss, parts_j, _, _ = image_step_f64
    assert_close("image step loss float64", loss, parts_j["loss"], atol=0, rtol=1e-6)


def test_image_step_gradients_float64_like_jax(image_step_f64):
    _, _, grads, grads_j = image_step_f64
    assert set(grads) == set(grads_j)
    assert_close("image step gradients float64 / leaf scale", _leafwise(grads, grads_j), 0.0,
                 atol=1e-6)
