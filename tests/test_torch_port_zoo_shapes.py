"""Every config of ``configs/`` at full width and depth: the port's
``build_model`` on the ``meta`` device (shapes only) has exactly the
state-dict names and shapes of ``flax_to_torch`` of ``jax.eval_shape`` of
the JAX ``build_model`` at the config's ``img_size``, so published or
JAX-trained weights load with ``strict=True``; and the parameter counts
of the five distinct architectures.
"""
import functools
import glob
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from event_representation_study_tpu.models import build_model as jax_build_model
from event_representation_study_tpu_torch.models import build_model
from event_representation_study_tpu_torch.utils.config import load_config
from torch_port_helpers import flax_to_torch_shapes

CONFIGS = sorted(pathlib.Path(p).stem for p in glob.glob("configs/*.py"))
# millions of parameters (JAX ``jax.eval_shape`` of ``build_model``)
PARAMS_M = {"gen1_efficientrep": 151.0, "gen1_lite": 1.3, "gen1_resnet50": 44.6,
            "gen1_swinvit": 216.4, "gen1_optimized": 140.3}


def test_every_config_is_covered():
    assert len(CONFIGS) == 9 and set(PARAMS_M) <= set(CONFIGS)


@functools.lru_cache(maxsize=None)
def _jax_shapes(key: str):
    """``jax.eval_shape`` of the JAX detector, once per distinct (model dict,
    training mode, image size): the five paper-detector configs share one."""
    model, mode, img = json.loads(key)
    cfg = {"model": model, "training_mode": mode, "data": {"img_size": img}}
    return jax.eval_shape(functools.partial(jax_build_model(cfg, num_classes=2).init,
                                            train=False),
                          jax.random.PRNGKey(0), jnp.zeros((1, img, img, 12)))


@pytest.mark.parametrize("name", CONFIGS)
def test_full_width_state_dict_equals_jax(name):
    cfg = load_config(f"configs/{name}.py")
    model = {k: v for k, v in cfg["model"].items() if k != "pretrained"}
    shapes = _jax_shapes(json.dumps([model, cfg.get("training_mode", "conv_silu"),
                                     cfg["data"]["img_size"]], sort_keys=True))
    want = flax_to_torch_shapes({k: shapes[k] for k in ("params", "batch_stats")})
    model = build_model(cfg, 2, device="meta")
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))
    n_port = sum(p.numel() for p in model.parameters())
    assert n_port == n_jax
    arch = name if name in PARAMS_M else "gen1_optimized"  # the paper detector's 5 configs
    assert round(n_port / 1e6, 1) == PARAMS_M[arch]
