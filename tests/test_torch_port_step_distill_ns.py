"""A whole nano/small distillation train step: a YOLOv6s student with the
distill_ns head (its ltrb branch adds a second IoU term; TAL from the
first epoch) against a plain-headed teacher, port against JAX on the CPU
at 128 px (``torch_port_helpers.variant_step_pair``), with the tolerances
of ``test_torch_port_step_distill.py``.
"""
import pytest

from torch_port_helpers import ZOO_STEP_PARTS, check_variant_step, variant_step_pair


@pytest.fixture(scope="module")
def step_pair():
    return variant_step_pair("distill_ns")


@pytest.mark.parametrize("part", ZOO_STEP_PARTS)
def test_distill_ns_step(step_pair, part):
    check_variant_step("distill_ns", part, *step_pair)
