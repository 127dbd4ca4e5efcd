"""The detector zoo's necks and the head without DFL against their JAX twins
on the CPU (``models/necks.py``, ``models/heads.py``): every name of the
neck registry in train mode (batch statistics, and the running statistics
left behind), with input widths that differ from ``channels_list``'s, as a
ResNet's or Swin's fixed 128/256/512/1024 do; weights drawn with numpy and
carried by ``utils/convert.py::flax_to_torch``.

Tolerance: float32 on both sides; outputs within 1e-4 of the largest JAX
value, BatchNorm statistics 1e-4 relative plus 1e-5, decoded boxes 1e-3 px.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event_representation_study_tpu.models import heads as JH
from event_representation_study_tpu.models import necks as JN
from event_representation_study_tpu.models import yolo as JY
from event_representation_study_tpu_torch.models import heads as TH
from event_representation_study_tpu_torch.models import necks as TN
from event_representation_study_tpu_torch.models import yolo as TY
from event_representation_study_tpu_torch.utils.convert import flax_to_torch
from torch_port_helpers import (
    assert_close,
    close_to_scale,
    compare_stats,
    nchw,
    nhwc,
    random_variables,
)


def _feats(widths, sizes, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(2, s, s, c)).astype(np.float32) for c, s in zip(widths, sizes)]


# registry name -> (channels_list, num_repeats, input widths, input sizes)
NECK_CASES = {
    "CSPRepBiFPANNeck_P6": ([8, 16, 16, 24, 24, 32, 24, 16, 8, 16, 24, 32], [1] * 6 + [2] * 6,
                            [16, 16, 24, 24, 32], [64, 32, 16, 8, 4]),
    "RepBiFPANNeck6": ([8, 16, 16, 24, 24, 32, 24, 16, 8, 16, 24, 32], [1] * 6 + [2] * 6,
                       [16, 16, 24, 24, 32], [64, 32, 16, 8, 4]),
    "CSPRepBiFPANNeck": ([8, 16, 16, 24, 24, 16, 8, 8, 16, 24], [1] * 5 + [2] * 5,
                         [12, 20, 28, 36], [32, 16, 8, 4]),
    "RepBiFPANNeck": ([8, 16, 16, 24, 24, 16, 8, 8, 16, 24], [1] * 5 + [2] * 5,
                      [12, 20, 28, 36], [32, 16, 8, 4]),
    "RepPANNeck": ([8, 16, 16, 24, 24, 16, 8, 8, 16, 16, 24], [1] * 5 + [2] * 6,
                   [16, 16, 24, 24], [32, 16, 8, 4]),
    "CSPRepPANNeck": ([8, 16, 16, 24, 24, 16, 8, 8, 16, 16, 24], [1] * 5 + [2] * 6,
                      [16, 16, 24, 24], [32, 16, 8, 4]),
    "RepPANNeck6": ([8, 16, 16, 24, 24, 32, 24, 16, 8, 16, 24, 32], [1] * 6 + [2] * 6,
                    [16, 24, 24, 32], [32, 16, 8, 4]),
    "CSPRepPANNeck_P6": ([8, 16, 16, 24, 24, 32, 24, 16, 8, 16, 24, 32], [1] * 6 + [2] * 6,
                         [16, 24, 24, 32], [32, 16, 8, 4]),
    "Lite_EffiNeck": ([24, 16, 16, 32, 32, 16, 16, 16, 16], [1] * 9, [16, 32, 32], [32, 16, 8]),
}


def test_registries_hold_every_jax_name():
    assert set(TY.NECKS) == set(JY.NECKS) == set(NECK_CASES)
    assert set(TY.BACKBONES) == set(JY.BACKBONES)


def _run(jmod, tmod, feats, seed, train):
    variables = random_variables(jmod, [jnp.asarray(f) for f in feats], seed=seed)
    tmod.load_state_dict(flax_to_torch(variables), strict=True)
    if train:
        want, upd = jax.jit(lambda v, a: jmod.apply(v, a, True, mutable=["batch_stats"]))(
            variables, feats)
    else:
        want, upd = jax.jit(lambda v, a: jmod.apply(v, a, False))(variables, feats), None
    with torch.no_grad():
        got = tmod.train(train)([nchw(f) for f in feats])
    return got, want, upd


@pytest.mark.parametrize("name", sorted(NECK_CASES))
def test_neck(name):
    ch, nr, widths, sizes = NECK_CASES[name]
    jmod = JY.NECKS[name](ch, nr, "conv_silu", 0.5, jnp.float32, "neck")
    tmod = TY.NECKS[name](widths, ch, nr, "conv_silu", 0.5)
    got, want, upd = _run(jmod, tmod, _feats(widths, sizes), 2, True)
    assert tuple(g.shape[1] for g in got) == tmod.out_channels
    for i, (g, w) in enumerate(zip(got, want)):
        close_to_scale(f"{name} out {i}", nhwc(g), np.asarray(w))
    compare_stats(name, tmod, upd["batch_stats"])


def test_neck_mbla_stage_eval():
    """The ``mbla`` stage kind (no registry name uses it), eval mode."""
    ch, nr, widths, sizes = NECK_CASES["CSPRepBiFPANNeck"]
    got, want, _ = _run(JN.CSPRepBiFPANNeck(ch, nr, stage_type="mbla"),
                        TN.CSPRepBiFPANNeck(widths, ch, nr, stage_type="mbla"),
                        _feats(widths, sizes), 3, False)
    for i, (g, w) in enumerate(zip(got, want)):
        close_to_scale(f"mbla out {i}", nhwc(g), np.asarray(w))


def test_head_without_dfl():
    """``use_dfl=False`` (reg_max 0): the reg pred's 4 channels are the ltrb
    distances of the eval decode."""
    widths = [16, 24, 32]
    feats = _feats(widths, [16, 8, 4], seed=9)
    jmod = JH.EffiDeHead(num_classes=3, in_channels=[8, 16, 16], strides=(8, 16, 32),
                         reg_max=0, use_dfl=False)
    tmod = TH.EffiDeHead(3, [8, 16, 16], widths, (8, 16, 32), reg_max=0, use_dfl=False)
    got, want, _ = _run(jmod, tmod, feats, 4, False)
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape == (2, 16 * 16 + 8 * 8 + 4 * 4, 8)
    assert_close("boxes px", got[..., :4], want[..., :4], atol=1e-3)
    assert_close("scores", got[..., 4:], want[..., 4:], atol=1e-5)
