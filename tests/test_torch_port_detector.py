"""The port's Detector (PyTorch, NCHW) against the JAX Detector (Flax, NHWC)
on the shrunk paper config, with random weights carried across by
``utils/convert.py::flax_to_torch``.

Tolerance: both run float32 on the CPU; XLA and oneDNN sum the convolution
products in different orders, which leaves ~1e-6 relative error per layer.
Boxes reach ~1e3 px (DFL distance up to 16 x stride 64), so they are held
to 1e-3 px absolute; sigmoid scores to 1e-4; train-mode logits and features
to 1e-3.
"""
import numpy as np
import pytest
import torch

from event_representation_study_tpu_torch.models import build_model
from event_representation_study_tpu_torch.utils.convert import flax_to_torch
from torch_port_helpers import (
    assert_close,
    detector_pair,
    eval_outputs,
    small_cfg,
    train_outputs,
)


@pytest.fixture(scope="module")
def pair():
    return detector_pair()


@pytest.fixture(scope="module")
def train(pair):
    return train_outputs(*pair)


def test_state_dict_covers_every_leaf(pair):
    """strict loading already proved the key sets equal; the residual
    scales carry over too."""
    _, variables, model, _ = pair
    assert set(flax_to_torch(variables)) == set(model.state_dict())
    alpha = variables["params"]["backbone"]["stage_1"]["m"]["conv1"]["alpha"]
    np.testing.assert_array_equal(model.backbone.stage_1.m.conv1.alpha.detach().numpy(), alpha)


def test_eval_decode_parity(pair):
    got, want = eval_outputs(*pair)
    assert got.shape == want.shape == (2, 16**2 + 8**2 + 4**2 + 2**2, 7)
    assert_close("boxes px", got[..., :4], want[..., :4], atol=1e-3)
    assert_close("scores", got[..., 4:], want[..., 4:], atol=1e-4)


@pytest.mark.parametrize("part", ["stem_feats", "cls_scores", "reg_distri"])
def test_train_mode_parity(train, part):
    """Train mode: BatchNorm normalises with the batch statistics."""
    got, want = train
    idx = ["stem_feats", "cls_scores", "reg_distri"].index(part)
    if part == "stem_feats":
        for level, (g, w) in enumerate(zip(got[0], want[0])):
            assert_close(f"level {level}", g, w, atol=1e-3)
    else:
        tol = 1e-4 if part == "cls_scores" else 1e-3
        assert_close(part, got[idx], want[idx], atol=tol)


def test_seeded_init_matches_flax_defaults():
    """build_model(generator=...) reproduces Flax's init rules: unit BN,
    unit alphas, zero pred weights with the prior-probability class bias,
    lecun-normal kernels; the same seed gives the same weights."""
    cfg = small_cfg()
    a = build_model(cfg, 2, device="cpu", generator=torch.Generator().manual_seed(3))
    b = build_model(cfg, 2, device="cpu", generator=torch.Generator().manual_seed(3))
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
    head = a.head
    assert torch.all(head.cls_pred_0.weight == 0)
    np.testing.assert_allclose(head.cls_pred_0.bias.detach().numpy(), -np.log(99.0), rtol=1e-6)
    assert torch.all(head.reg_pred_0.bias == 1.0)
    assert torch.all(a.backbone.stage_1.m.conv1.alpha == 1.0)
    w = a.neck.Rep_p5.cv1.conv.weight
    std = (1.0 / w[0].numel()) ** 0.5
    assert abs(w.std().item() / std - 1.0) < 0.15 and w.abs().max() <= 2 * std / 0.8796 + 1e-6
