"""The learned event representation (``models/learned_repr.py``), port
against JAX on the CPU:

- ``QuantizationLayer`` (6 bins, 240 x 304) on the conftest streams (2500,
  800 and 64 events) and an empty window in one ragged batch, on the same
  random value-layer weights (carried by ``utils/convert.py``'s Dense
  rule): the (B, H, W, 12) output to 1e-5 of its largest entry, and the
  value layer's gradients of a weighted sum of it to 1e-4 of each leaf's
  largest entry (sums over events in another order);
- ``trilinear_kernel`` exactly; the port's ``pretrain_value_layer`` (200
  Adam steps) within a mean absolute error of 0.1 of the trilinear kernel
  on [-0.3, 0.3], the bound the JAX package's own test sets for its fit;
- ``letterbox_image`` with pad value 0 exactly as JAX's;
- the learned detector (quantization layer -> letterbox to 128 px with pad
  0 -> shrunk paper detector) in eval mode: boxes 1e-3 px, scores 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event_representation_study_tpu.events import from_structured as jax_from_structured
from event_representation_study_tpu.events import generate_fake_events as jax_fake_events
from event_representation_study_tpu.events import stack_blocks as jax_stack_blocks
from event_representation_study_tpu.models import build_model as jax_build_model
from event_representation_study_tpu.models import learned_repr as jax_lr
from event_representation_study_tpu.ops.image import letterbox_image as jax_letterbox
from event_representation_study_tpu_torch.events import from_structured, stack_blocks
from event_representation_study_tpu_torch.models import build_model, learned_repr
from event_representation_study_tpu_torch.ops.image import letterbox_image
from event_representation_study_tpu_torch.utils.config import load_config
from event_representation_study_tpu_torch.utils.convert import flax_to_torch, to_flax_leaves
from torch_port_helpers import CFG_PATH, SMALL, assert_close, close_to_scale, jax_leaves
from torch_port_helpers import random_variables

H, W, CAP, BINS = 240, 304, 2560, 6
STREAMS = [(2500, 7), (800, 11), (64, 13)]  # the conftest fake_events


def _streams():
    evs = [jax_fake_events(n, height=H, width=W, duration_us=500_000, seed=s)
           for n, s in STREAMS]
    return evs + [evs[0][:0]]  # and an empty window


@pytest.fixture(scope="module")
def quantization_pair():
    evs = _streams()
    blocks_j = jax_stack_blocks([jax_from_structured(e, CAP) for e in evs])
    blocks_p = stack_blocks([from_structured(e, CAP) for e in evs])
    layer_j = jax_lr.QuantizationLayer(num_bins=BINS, height=H, width=W)
    variables = random_variables(layer_j, blocks_j, seed=4)
    layer_p = learned_repr.QuantizationLayer(BINS, H, W)
    layer_p.load_state_dict(flax_to_torch(variables), strict=True)
    weight = np.random.default_rng(2).normal(size=(len(evs), H, W, 2 * BINS)).astype(np.float32)

    def loss_j(params):
        out = layer_j.apply({"params": params}, blocks_j)
        return jnp.sum(out * weight), out

    (_, out_j), g_j = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(variables["params"])
    out_p = layer_p(blocks_p)
    (out_p * torch.from_numpy(weight)).sum().backward()
    g_p = to_flax_leaves({n: p.grad for n, p in layer_p.named_parameters()})
    return np.asarray(out_j), out_p.detach().numpy(), jax_leaves(g_j, "params"), g_p


def test_quantization_layer_forward(quantization_pair):
    out_j, out_p, _, _ = quantization_pair
    assert out_p.shape == out_j.shape == (4, H, W, 2 * BINS)
    assert np.abs(out_j[:3]).max() > 0 and not out_p[3].any()  # the empty window
    close_to_scale("QuantizationLayer output", out_p, out_j, rel=1e-5)


def test_quantization_layer_gradients(quantization_pair):
    _, _, g_j, g_p = quantization_pair
    assert set(g_p) == set(g_j) and len(g_j) == 6
    for k in g_j:
        close_to_scale(f"value layer grad {k}", g_p[k], g_j[k], rel=1e-4)


def test_trilinear_kernel_exact():
    ts = np.linspace(-1.0, 1.0, 1001).astype(np.float32)
    for c in (6, 12):
        assert_close(f"trilinear_kernel C={c}",
                     learned_repr.trilinear_kernel(torch.from_numpy(ts), c).numpy(),
                     np.asarray(jax_lr.trilinear_kernel(jnp.asarray(ts), c)), atol=0)


def test_pretrain_value_layer_fits_trilinear():
    layer = learned_repr.pretrain_value_layer(torch.Generator().manual_seed(1), num_channels=12,
                                              steps=200)
    ts = torch.linspace(-0.3, 0.3, 64)
    with torch.no_grad():
        err = (layer(ts) - learned_repr.trilinear_kernel(ts, 12)).abs().mean().item()
    assert_close("pretrained value layer: mean |fit - trilinear| on [-0.3, 0.3]", err, 0.0,
                 atol=0.1)


def test_letterbox_pad_zero():
    x = np.random.default_rng(3).uniform(0, 5, (2, 60, 76, 12)).astype(np.float32)
    got = letterbox_image(torch.from_numpy(x), 128, pad_value=0.0).numpy()
    want = np.asarray(jax_letterbox(jnp.asarray(x), 128, pad_value=0.0))
    assert (got[:, :10] == 0).all()
    assert_close("letterbox pad 0", got, want, atol=1e-5)


def test_learned_detector_eval():
    cfg = load_config(CFG_PATH, overrides=SMALL + ["data.height=64", "data.width=64"])
    evs = [jax_fake_events(n, height=64, width=64, duration_us=200_000, seed=s)
           for n, s in ((1500, 3), (400, 4))]
    blocks_j = jax_stack_blocks([jax_from_structured(e, 2048) for e in evs])
    jm = jax_build_model(cfg, num_classes=2, representation="LearnedRepresentation", img_size=128)
    variables = random_variables(jm, blocks_j, seed=6)
    want = np.asarray(jax.jit(lambda v, b: jm.apply(v, b, False))(variables, blocks_j))
    model = build_model(cfg, 2, device="cpu", representation="LearnedRepresentation",
                        img_size=128)
    model.load_state_dict(flax_to_torch(variables), strict=True)
    with torch.no_grad():
        got = model.eval()(stack_blocks([from_structured(e, 2048) for e in evs])).numpy()
    assert got.shape == want.shape
    assert_close("learned detector eval boxes (px)", got[..., :4], want[..., :4], atol=1e-3)
    assert_close("learned detector eval scores", got[..., 4:], want[..., 4:], atol=1e-4)
