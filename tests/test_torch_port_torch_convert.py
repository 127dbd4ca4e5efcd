"""Reference-checkpoint import in the port (``utils/torch_convert.py``)
against the JAX package's (``utils/torch_convert.py``): a reference-style
ev-YOLOv6 state dict, synthesized from a port detector's random weights
under the reference's names (``reference_state_dict``, with the head's
``detect.proj`` / ``proj_conv`` and BatchNorm ``num_batches_tracked``
counts), in half precision as the published EMA is, goes through both
importers.

Tolerances: exact. The port's state dict equals
``flax_to_torch(JAX convert_state_dict(...))`` bit for bit on every
floating tensor; every reference key is placed or is one of the two
skipped projection constants; the JAX result fits the JAX model's tree and
the port's fits the port model's state dict (``verify_against_tree``), at
the shrunk width here and at the full width of the paper config.
"""
import functools

import jax
import jax.numpy as jnp
import pytest
import torch

from event_representation_study_tpu.models import build_model as jax_build_model
from event_representation_study_tpu.utils import torch_convert as jax_convert
from event_representation_study_tpu.utils.config import load_config as jax_load_config
from event_representation_study_tpu_torch.models import build_model
from event_representation_study_tpu_torch.utils import torch_convert
from event_representation_study_tpu_torch.utils.config import load_config
from event_representation_study_tpu_torch.utils.convert import flax_to_torch
from torch_port_helpers import SMALL, assert_close


def _reference_dict(model, seed):
    """The model's state dict with random values (half-precision floats,
    counts as int64) under the reference's names."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in model.state_dict().items():
        sd[k] = (torch.randint(0, 1000, v.shape, generator=g) if not v.is_floating_point()
                 else torch.randn(v.shape, generator=g).half())
    return torch_convert.reference_state_dict(sd), sd


@pytest.mark.parametrize("config", ["gen1_optimized", "gen1_efficientrep"])
def test_convert_equals_jax(config):
    path = f"configs/{config}.py"
    model = build_model(load_config(path, overrides=SMALL), 2, device="cpu")
    ref, port_sd = _reference_dict(model, seed=1)
    assert {"detect.proj", "detect.proj_conv.weight"} <= set(ref)
    got, unmatched = torch_convert.convert_state_dict(ref)
    assert unmatched == [] and set(got) == set(model.state_dict())
    assert torch_convert.verify_against_tree(got, model.state_dict()) == []
    model.load_state_dict(got, strict=True)

    params, stats = jax_convert.convert_state_dict(ref)
    assert "__unmatched__" not in params
    jax_model = jax_build_model(jax_load_config(path, overrides=SMALL), num_classes=2)
    shapes = jax.eval_shape(functools.partial(jax_model.init, train=False),
                            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 12)))
    assert jax_convert.verify_against_tree(params, shapes["params"]) == []
    assert jax_convert.verify_against_tree(stats, shapes["batch_stats"]) == []
    want = flax_to_torch({"params": params, "batch_stats": stats})
    assert set(want) == set(got)
    floats = [k for k in got if not k.endswith("num_batches_tracked")]
    for k in got:
        if k not in floats:  # the JAX tree has no count; the port keeps the reference's
            assert got[k].dtype == torch.int64 and torch.equal(got[k], port_sd[k])
            continue
        assert got[k].dtype == torch.float32 and torch.equal(got[k], port_sd[k].float()), k
        assert got[k].shape == want[k].shape, k
    assert_close(f"{config}: {len(floats)} floating tensors",
                 torch.cat([got[k].flatten() for k in floats]),
                 torch.cat([want[k].flatten() for k in floats]), atol=0)


def test_full_width_paper_detector_round_trip():
    """Every key and shape of the full-width detector of
    ``configs/swinv2_yolov6l6_finetune.py`` (140.4M parameters) through the
    name map and back into the model."""
    model = build_model(load_config("configs/swinv2_yolov6l6_finetune.py"), 2, device="meta")
    sd = model.state_dict()
    ref = torch_convert.reference_state_dict(
        {k: torch.zeros((), dtype=v.dtype).expand(v.shape) for k, v in sd.items()})
    assert len(ref) == len(sd) + 2
    got, unmatched = torch_convert.convert_state_dict(ref)
    assert unmatched == [] and set(got) == set(sd)
    assert torch_convert.verify_against_tree(got, sd) == []
    assert sum(v.numel() for k, v in got.items() if v.is_floating_point()
               and "running" not in k) == sum(p.numel() for p in model.parameters()) > 140e6


def test_unmatched_keys_are_reported():
    got, unmatched = torch_convert.convert_state_dict({
        "module.backbone.stem.block.conv.weight": torch.zeros(8, 3, 3, 3),
        "backbone.stem.block.bn.unknown": torch.zeros(8),
        "detect.proj": torch.arange(17.0),
        "neck.x.weight": torch.zeros(2, 2, 2)})
    assert list(got) == ["backbone.stem.conv.weight"]
    assert unmatched == ["backbone.stem.block.bn.unknown", "neck.x.weight"]
    problems = torch_convert.verify_against_tree(
        got, {"backbone.stem.conv.weight": torch.zeros(8, 12, 3, 3), "a.bias": torch.zeros(1)})
    assert problems == [("backbone.stem.conv.weight", (8, 3, 3, 3), (8, 12, 3, 3)),
                        ("a.bias", None, "missing")]
