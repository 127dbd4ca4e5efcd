"""A whole distillation train step (``make_train_step(mode="distill",
distill_feat=True)``), port against JAX on the CPU: the shrunk paper
detector as student and teacher (the student's weights plus noise) at 128
px, at an ATSS epoch (``torch_port_helpers.variant_step_pair``). Loss
terms (the base ones and ``kd_cls`` / ``kd_dfl`` / ``kd_cw``) 1e-4
relative (the class KD and class loss 1e-3: ``KD_CLS_STEP_RTOL``), equal
positive anchors; gradients and parameter updates 2e-2 of each leaf's
scale; BatchNorm statistics 2e-3 relative plus 1e-4. The
teacher's train-mode forward leaves its BatchNorm statistics bit-unchanged,
as the JAX step discards them.
"""
import pytest
import torch

from torch_port_helpers import (  # noqa: F401 (a fixture)
    ZOO_STEP_PARTS,
    check_variant_step,
    default_torch_threads,
    variant_step_pair,
)

# At one intra-op thread the step's gradients read 7.27e-2 of a leaf's scale
# and its updates 7.68e-2 against their 2e-2 bound, rounding that the step
# magnifies (test_torch_port_step_distill_f64.py): the module keeps torch's
# default threads.
pytestmark = pytest.mark.usefixtures("default_torch_threads")


@pytest.fixture(scope="module")
def step_pair():
    return variant_step_pair("distill")


@pytest.mark.parametrize("part", ZOO_STEP_PARTS)
def test_distill_step(step_pair, part):
    check_variant_step("distill", part, *step_pair)


def test_teacher_statistics_unchanged(step_pair):
    before, after = step_pair[0]["teacher_state"]
    assert before.keys() == after.keys()
    assert all(torch.equal(before[k], after[k]) for k in before)
