"""Whole detectors of each new family of ``configs/`` against the JAX
Detector on the CPU, eval decode, float32 and bfloat16: EfficientRep with
RepVGG blocks (``gen1_efficientrep``), Lite (``gen1_lite``) and ResNet50
(``gen1_resnet50``) at depth 0.2 (the Lite at full width: its
squeeze-excite needs >= 4 channels; the ResNet at its fixed preset), on
the same NumPy inputs with weights carried by ``flax_to_torch``. The Swin
family is ``test_torch_port_zoo_swin.py``.

Tolerances, float32: boxes 1e-2 px (boxes reach ~1e3 px: 1e-5 relative),
scores 1e-4. bfloat16 (``build_model(dtype=torch.bfloat16)``, autocast
over float32 weights, against Flax ``dtype=jnp.bfloat16``): the port's
mean absolute error against its own float32 output, boxes and scores, is
within 2x JAX's against JAX's float32 output (plus 1e-3 of the box range
and 1e-4); directly, the port's bf16 output against JAX's bf16 output
differs by at most 0.5% of the box range on average (8% at the 99th
percentile) and 0.02 in scores on average (0.5 at most). JAX's ResNet
pools its outputs by cumulative sums in bf16, ~30x the port's error, which
is why the direct bound is loose. Decoded boxes of the bf16 model are
float32 (the DFL expectation runs against a float32 projection).
"""
import pytest
import torch

from torch_port_helpers import assert_close, check_bf16, zoo_pair

# config -> (width multiple, image size)
FAMILIES = {"gen1_efficientrep": (0.125, 128), "gen1_lite": (1.0, 128),
            "gen1_resnet50": (0.125, 64)}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def outputs(request):
    return request.param, zoo_pair(request.param, *FAMILIES[request.param])


def test_eval_decode_float32(outputs):
    name, out = outputs
    got, want = out[f"port_{torch.float32}"].numpy(), out[f"jax_{torch.float32}"]
    assert got.shape == want.shape
    assert_close(f"{name} boxes px", got[..., :4], want[..., :4], atol=1e-2)
    assert_close(f"{name} scores", got[..., 4:], want[..., 4:], atol=1e-4)


def test_eval_decode_bfloat16(outputs):
    check_bf16(*outputs)
