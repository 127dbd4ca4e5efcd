"""A whole train step with the learned representation: raw events of a 64 x
64 sensor into the detector's trainable quantization layer (6 bins, 12
channels), letterboxed to 128 px with pad 0 and no /255, port against JAX
on the CPU (``torch_port_helpers.variant_step_pair``): loss terms 1e-4
relative, gradients (the value layer's among them) and parameter updates
2e-2 of each leaf's scale, BatchNorm statistics 2e-3 relative plus 1e-4.
"""
import numpy as np
import pytest

from torch_port_helpers import ZOO_STEP_PARTS, check_variant_step, variant_step_pair


@pytest.fixture(scope="module")
def step_pair():
    return variant_step_pair("learned")


@pytest.mark.parametrize("part", ZOO_STEP_PARTS)
def test_learned_step(step_pair, part):
    check_variant_step("learned", part, *step_pair)


def test_value_layer_gets_gradients(step_pair):
    grads = {k: v for k, v in step_pair[0]["grads"].items() if "/quantization/" in k}
    assert len(grads) == 6 and all(np.abs(g).sum() > 0 for g in grads.values())
