"""The detector zoo's backbones against their JAX twins on the CPU
(``models/backbones.py``, ``models/swin_vit.py``), in eval and train mode,
weights drawn with numpy and carried by ``utils/convert.py::flax_to_torch``.

Tolerance: float32 on both sides. Outputs are held to 1e-4 of the largest
value of the JAX output (a 50-layer random ResNet's activations grow to
~1e2, and XLA and oneDNN sum in different orders), BatchNorm statistics to
1e-4 relative plus 1e-5. Train-mode BatchNorm needs enough values a
channel at the coarsest level (>= 16), or float32 noise flips ReLU kinks.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event_representation_study_tpu.models import backbones as JB
from event_representation_study_tpu.models import swin_vit as JS
from event_representation_study_tpu_torch.models import backbones as TB
from event_representation_study_tpu_torch.models import swin_vit as TS
from event_representation_study_tpu_torch.utils.convert import flax_to_torch
from torch_port_helpers import (  # noqa: F401 (a fixture)
    assert_close,
    close_to_scale,
    compare_stats,
    default_torch_threads,
    nchw,
    nhwc,
    random_variables,
)

# At one intra-op thread efficientrep6_cspsppf's coarsest train-mode output
# reads 7.05e-4 against its 4.26e-4 bound (4.24e-4 at 2 threads, 1.57e-4 at
# 8): the module keeps torch's default threads.
pytestmark = pytest.mark.usefixtures("default_torch_threads")


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


SWIN = dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(2, 2, 4, 4), window_size=4)

# name -> (JAX module, port module, NHWC input shape)
BACKBONES = {
    "efficientrep": (lambda: JB.EfficientRep([8, 16, 16, 32, 32], [1, 2, 2, 2, 1]),
                     lambda: TB.EfficientRep(12, [8, 16, 16, 32, 32], [1, 2, 2, 2, 1]),
                     (4, 128, 128, 12)),
    "efficientrep_no_p2": (
        lambda: JB.EfficientRep([8, 16, 16, 32, 32], [1, 2, 1, 2, 1], fuse_P2=False),
        lambda: TB.EfficientRep(12, [8, 16, 16, 32, 32], [1, 2, 1, 2, 1], fuse_P2=False),
        (4, 64, 64, 12)),
    "efficientrep6_cspsppf": (
        lambda: JB.EfficientRep6([8, 16, 16, 32, 32, 48], [1, 2, 1, 2, 1, 1], cspsppf=True),
        lambda: TB.EfficientRep6(12, [8, 16, 16, 32, 32, 48], [1, 2, 1, 2, 1, 1],
                                 cspsppf=True),
        (4, 128, 128, 12)),  # 16 values a channel in the stride-64 BatchNorms
    "lite": (lambda: JB.Lite_EffiBackbone([24, 16, 16, 32, 32], [12, 16, 16, 32, 32],
                                          (1, 2, 2, 1)),
             lambda: TB.Lite_EffiBackbone(12, [24, 16, 16, 32, 32], [12, 16, 16, 32, 32],
                                          (1, 2, 2, 1)),
             (4, 64, 64, 12)),
    "resnet50": (lambda: JB.ResNet50Backbone(), lambda: TB.ResNet50Backbone(12),
                 (2, 64, 64, 12)),
    "resnet_cbam_bn_trained": (
        lambda: JB.ResNet50Backbone(layers=(1, 1, 1, 1), cbam=True, freeze_bn=False),
        lambda: TB.ResNet50Backbone(12, layers=(1, 1, 1, 1), cbam=True, freeze_bn=False),
        (4, 64, 64, 12)),
    # 72²: the 18², 9² and 5² maps are padded to window multiples and
    # shifted, the 3² map's window shrinks to 3 with no shift, and patch
    # merging pads the odd sides; no BatchNorm, so train mode is eval mode
    "swin_small": (lambda: JS.SwinTransformerV2ViT(**SWIN),
                   lambda: TS.SwinTransformerV2ViT(12, **SWIN), (2, 72, 72, 12)),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    """The JAX backbone's eval and train outputs (and updated statistics)
    from one compile, with its input and variables."""
    jf, tf, shape = BACKBONES[name]
    jmod = jf()
    x = _x(shape, seed=sorted(BACKBONES).index(name))
    variables = random_variables(jmod, jnp.asarray(x), seed=1)

    def both(v, a):
        return (jmod.apply(v, a, False),
                jmod.apply(v, a, True, mutable=["batch_stats"]))

    return tf, x, variables, jax.jit(both)(variables, x)


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("name", sorted(BACKBONES))
def test_backbone(name, mode):
    tf, x, variables, (want_eval, (want_train, upd)) = _case(name)
    tmod = tf()
    tmod.load_state_dict(flax_to_torch(variables), strict=True)
    train = mode == "train"
    want = want_train if train else want_eval
    with torch.no_grad():
        got = tmod.train(train)(nchw(x))
    assert len(got) == len(want)
    assert tuple(f.shape[1] for f in got) == tmod.out_channels
    for i, (g, w) in enumerate(zip(got, want)):
        close_to_scale(f"{name} {mode} out {i}", nhwc(g), np.asarray(w))
    if train and "batch_stats" in variables:
        compare_stats(name, tmod, upd["batch_stats"])


def test_resnet_frozen_bn_stays_frozen_in_train_mode():
    """``freeze_bn``: model.train() leaves every BatchNorm on its running
    statistics, untouched by a forward, while the backbone is in train
    mode (DropBlock follows it)."""
    tmod = TB.ResNet50Backbone(12, drop_prob=0.1).train()
    assert tmod.training and not any(m.training for m in tmod.modules()
                                     if isinstance(m, torch.nn.BatchNorm2d))
    before = {k: v.clone() for k, v in tmod.state_dict().items()}
    with torch.no_grad():
        tmod(torch.randn(1, 12, 64, 64))
    assert all(torch.equal(before[k], v) for k, v in tmod.state_dict().items())
    with torch.no_grad():
        x = torch.randn(1, 12, 64, 64)
        assert not torch.equal(tmod(x)[0], tmod.eval()(x)[0])  # DropBlock in train mode


def test_swin_pieces():
    """The constant tables and the window round trip."""
    for ws in (3, 4, 12):
        assert_close(f"coords {ws}", TS._relative_coords_log(ws),
                     JS._relative_coords_log(ws).astype(np.float32), 0.0)
    assert_close("mask", TS._shift_mask(24, 24, 12, 6), JS._shift_mask(24, 24, 12, 6), 0.0)
    x = torch.randn(2, 8, 12, 5)
    assert torch.equal(TS.window_reverse(TS.window_partition(x, 4), 4, 8, 12), x)
    assert_close("partition", TS.window_partition(x, 4).numpy(),
                 np.asarray(JS.window_partition(jnp.asarray(x.numpy()), 4)), 0.0)
