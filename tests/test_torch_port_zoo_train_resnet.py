"""One whole train step of the ResNet50 family (``configs/gen1_resnet50.py``:
the fixed 72/36/18/9 grid, 3 levels at strides 16/32/64), shrunk to depth
0.2 / width 0.125 at 128 px, batch 2, port against JAX on the CPU from the same
random weights (``torch_port_helpers.zoo_step_pair``); the backbone's
frozen BatchNorm statistics stay as they were. Tolerances as
``test_torch_port_zoo_train.py``.
"""
import numpy as np
import pytest

from torch_port_helpers import ZOO_STEP_PARTS, check_zoo_step, zoo_step_pair


@pytest.fixture(scope="module")
def step_pair():
    return zoo_step_pair("gen1_resnet50", batch=2)  # its neck runs at 72² whatever the input


@pytest.mark.parametrize("part", ZOO_STEP_PARTS)
def test_resnet50_step(step_pair, part):
    check_zoo_step("resnet50", part, *step_pair)


def test_frozen_backbone_statistics(step_pair):
    """``freeze_bn``: a train step leaves the backbone's BatchNorm
    statistics as they were, in both packages."""
    got, want, before = step_pair
    frozen = [k for k in want["batch_stats"] if k.startswith("batch_stats/backbone/")]
    assert frozen
    for k in frozen:
        assert np.array_equal(want["batch_stats"][k], before[k]), k
        assert np.array_equal(got["batch_stats"][k], before[k]), k
