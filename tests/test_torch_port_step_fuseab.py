"""A whole fuse-ab train step (``make_train_step(mode="fuseab")``), port
against JAX on the CPU: the shrunk paper detector with the fuse-ab head (3
default priors a level) at 128 px, from the same random weights and batch,
at a TAL epoch (``torch_port_helpers.variant_step_pair``). Loss terms (the
anchor-free ones and the anchor-base ``ab_cls`` / ``ab_iou``) 1e-4
relative and equal positive anchors in both branches; gradients and
parameter updates 2e-2 of each leaf's scale; BatchNorm statistics 2e-3
relative plus 1e-4 (the tolerances of ``test_torch_port_train_step.py``).
"""
import pytest

from torch_port_helpers import ZOO_STEP_PARTS, check_variant_step, variant_step_pair


@pytest.fixture(scope="module")
def step_pair():
    return variant_step_pair("fuseab")


@pytest.mark.parametrize("part", ZOO_STEP_PARTS)
def test_fuseab_step(step_pair, part):
    check_variant_step("fuseab", part, *step_pair)
