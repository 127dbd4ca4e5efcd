"""Detector weights across frameworks through checkpoints: a port
checkpoint's EMA, through ``utils/convert.py::to_flax_leaves``, gives the
JAX Detector the port's predictions, and a JAX checkpoint restored by the
JAX package's ``load_checkpoint`` loads into the port through
``flax_to_torch``. Bounds of ``test_torch_port_detector.py``: boxes 1e-3
px, scores 1e-4."""
import jax
import numpy as np
import pytest
import torch

from event_representation_study_tpu.models import build_model as jax_build_model
from event_representation_study_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from event_representation_study_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from event_representation_study_tpu_torch.data.gen1 import write_gen1_fixture
from event_representation_study_tpu_torch.models import build_model
from event_representation_study_tpu_torch.train import checkpoint
from event_representation_study_tpu_torch.utils.convert import flax_to_torch, to_flax_leaves
from test_torch_port_trainer import stepped_state
from torch_port_helpers import assert_close, random_jax_variables, small_cfg


@pytest.fixture(scope="module")
def gen1_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("gen1_ckpt")
    write_gen1_fixture(root / "training.h5", num_files=1, boxes_per_file=4, events_per_file=2000,
                       seed=11)
    return root


def _nest(flat):
    tree = {}
    for path, arr in flat.items():
        *keys, leaf = path.split("/")
        d = tree
        for k in keys:
            d = d.setdefault(k, {})
        d[leaf] = arr
    return tree


def test_port_checkpoint_serves_the_jax_detector(gen1_root, tmp_path):
    state = stepped_state(gen1_root, steps=2)
    checkpoint.save_checkpoint(tmp_path / "ckpt", state, epoch=0)
    ema = checkpoint.model_variables(checkpoint.load_checkpoint(tmp_path / "ckpt"))
    model = checkpoint.load_model_variables(build_model(small_cfg(), 2, device="cpu"), ema).eval()
    variables = _nest(to_flax_leaves(ema))
    jax_model = jax_build_model(small_cfg(), num_classes=2)
    x = np.random.default_rng(1).normal(size=(2, 64, 64, 12)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, a: jax_model.apply(v, a, False))(variables, x))
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert_close("port EMA in JAX: boxes px", got[..., :4], want[..., :4], atol=1e-3)
    assert_close("port EMA in JAX: scores", got[..., 4:], want[..., 4:], atol=1e-4)


def test_jax_checkpoint_loads_through_flax_to_torch(tmp_path):
    jax_model = jax_build_model(small_cfg(), num_classes=2)
    variables = random_jax_variables(jax_model, 64, seed=3)
    jax_save_checkpoint(tmp_path / "jax_ckpt", {**variables, "ema": {
        "variables": variables, "updates": np.int32(7)}}, epoch=4)
    ckpt = jax_load_checkpoint(tmp_path / "jax_ckpt")
    assert int(ckpt["epoch"]) == 4
    model = build_model(small_cfg(), 2, device="cpu")
    model.load_state_dict(flax_to_torch(ckpt["state"]["ema"]["variables"]), strict=True)
    x = np.random.default_rng(2).normal(size=(1, 64, 64, 12)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, a: jax_model.apply(v, a, False))(variables, x))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert_close("JAX checkpoint in the port: boxes px", got[..., :4], want[..., :4], atol=1e-3)
    assert_close("JAX checkpoint in the port: scores", got[..., 4:], want[..., 4:], atol=1e-4)
