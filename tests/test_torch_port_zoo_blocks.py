"""The detector zoo's blocks (``models/layers.py``) against their JAX twins
on the CPU: each block in eval mode (BatchNorm on running statistics) and
in train mode (batch statistics, with the updated running statistics
compared too), on the same NumPy inputs, weights drawn with numpy and
carried by ``utils/convert.py::flax_to_torch``. RepVGG deploy fusion
(``utils/reparam.py``) against the unfused block; DropBlock at
``drop_prob=0`` and its keep rate.

Tolerance: float32 on both sides; XLA and oneDNN sum convolution products
in different orders (~1e-6 relative a layer), so outputs are held to
1e-4 relative plus 1e-5 absolute, and BatchNorm statistics to 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event_representation_study_tpu.models import layers as J
from event_representation_study_tpu_torch.models import layers as T
from event_representation_study_tpu_torch.utils import reparam
from event_representation_study_tpu_torch.utils.convert import flax_to_torch, to_flax_leaves
from torch_port_helpers import assert_close, random_variables

RTOL, ATOL = 1e-4, 1e-5


def _x(c, hw=12, seed=0, b=2):
    return np.random.default_rng(seed).normal(size=(b, hw, hw, c)).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


# name -> (JAX module, port module, input channels, has train mode)
BLOCKS = {
    "conv_bn_hardswish_grouped": (J.ConvBNAct(8, 3, 1, "hardswish", groups=2),
                                  T.ConvBNAct(6, 8, 3, 1, "hardswish", groups=2), 6, True),
    "conv_bn_depthwise_s2": (J.ConvBN(6, 3, 2, groups=6), T.ConvBN(6, 6, 3, 2, groups=6), 6,
                             True),
    "conv_bn_hs": (J.ConvBNHS(10, 1, 1), T.ConvBNHS(6, 10, 1, 1), 6, True),
    "cspsppf": (J.CSPSPPF(8), T.CSPSPPF(6, 8), 6, True),
    "repvgg_identity": (J.RepVGGBlock(8), T.RepVGGBlock(8, 8), 8, True),
    "repvgg_s2": (J.RepVGGBlock(10, 3, 2), T.RepVGGBlock(6, 10, 3, 2), 6, True),
    "qarepvgg_identity": (J.QARepVGGBlock(8), T.QARepVGGBlock(8, 8), 8, True),
    "qarepvgg_s2": (J.QARepVGGBlock(10, 3, 2), T.QARepVGGBlock(6, 10, 3, 2), 6, True),
    "qarepvggv2_identity": (J.QARepVGGBlockV2(8), T.QARepVGGBlockV2(8, 8), 8, True),
    "qarepvggv2_s2": (J.QARepVGGBlockV2(10, 3, 2), T.QARepVGGBlockV2(6, 10, 3, 2), 6, True),
    "bottlerep3": (J.BottleRep3(8), T.BottleRep3(8, 8), 8, True),
    "bottlerep3_repvgg": (J.BottleRep3(8, "repvgg"), T.BottleRep3(8, 8, "repvgg"), 8, True),
    "bottlerep_qarepvggv2": (J.BottleRep(8, "qarepvggv2"), T.BottleRep(8, 8, "qarepvggv2"), 8,
                             True),
    "mbla_n1": (J.MBLABlock(8, n=1), T.MBLABlock(6, 8, n=1), 6, True),
    "mbla_n4": (J.MBLABlock(8, n=4), T.MBLABlock(6, 8, n=4), 6, True),
    "mbla_n6_relu": (J.MBLABlock(8, n=6, basic_mode="conv_relu"),
                     T.MBLABlock(6, 8, n=6, basic_mode="conv_relu"), 6, True),
    "se": (J.SEBlock(8), T.SEBlock(8), 8, False),
    "lite_s1": (J.Lite_EffiBlockS1(8, 8), T.Lite_EffiBlockS1(8, 8, 8), 8, True),
    "lite_s2": (J.Lite_EffiBlockS2(16, 16), T.Lite_EffiBlockS2(8, 16, 16), 8, True),
    "dpblock_s2": (J.DPBlock(8, 5, 2), T.DPBlock(8, 8, 5, 2), 8, True),
    "darknet": (J.DarknetBlock(8, 5, 1.0), T.DarknetBlock(6, 8, 5, 1.0), 6, True),
    "cspblock": (J.CSPBlock(8, 5), T.CSPBlock(12, 8, 5), 12, True),
    "cbam": (J.CBAM(), T.CBAM(8), 8, False),
}


def _pair(name, seed=1):
    jmod, tmod, cin, has_train = BLOCKS[name]
    x = _x(cin, seed=sorted(BLOCKS).index(name))
    variables = random_variables(jmod, jnp.asarray(x), seed=seed)
    tmod.load_state_dict(flax_to_torch(variables), strict=True)
    return jmod, tmod, variables, x, has_train


def _jax_apply(jmod, variables, x, train, has_train=True):
    if train:
        out, upd = jmod.apply(variables, x, True, mutable=["batch_stats"])
        return np.asarray(out), jax.tree.map(np.asarray, upd["batch_stats"])
    return np.asarray(jmod.apply(variables, x, False) if has_train
                      else jmod.apply(variables, x)), None


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_eval(name):
    jmod, tmod, variables, x, has_train = _pair(name)
    want, _ = _jax_apply(jmod, variables, x, False, has_train)
    with torch.no_grad():
        got = _nhwc(tmod.eval()(_nchw(x)))
    assert got.shape == want.shape
    assert_close(name, got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", sorted(n for n, b in BLOCKS.items() if b[3]))
def test_block_train(name):
    """Train mode: outputs on batch statistics, and the running statistics
    each BatchNorm leaves behind."""
    jmod, tmod, variables, x, _ = _pair(name)
    want, want_stats = _jax_apply(jmod, variables, x, True)
    with torch.no_grad():
        got = _nhwc(tmod.train()(_nchw(x)))
    assert_close(name, got, want, atol=ATOL, rtol=RTOL)
    got_stats = {k: v for k, v in to_flax_leaves(tmod.state_dict()).items()
                 if k.startswith("batch_stats/")}
    flat = {"batch_stats/" + "/".join(p.key for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(want_stats)[0]}
    assert set(got_stats) == set(flat) and flat
    for k in flat:
        assert_close(f"{name} {k}", got_stats[k], flat[k], atol=1e-5, rtol=1e-5)


def test_basic_block_modes():
    for mode, cls in (("repvgg", T.RepVGGBlock), ("qarepvgg", T.QARepVGGBlock),
                      ("qarepvggv2", T.QARepVGGBlock), ("conv_silu", T.ConvBNAct)):
        assert isinstance(T.get_basic_block(mode)(4, 8, 3, 2), cls)
    assert T.get_basic_block("qarepvggv2")(8, 8).avg_branch
    with pytest.raises(ValueError, match="unknown training_mode"):
        T.get_basic_block("nope")


def test_channel_shuffle_interleaves_as_torch():
    r = np.arange(2 * 4 * 4 * 8, dtype=np.float32).reshape(2, 4, 4, 8)
    got = _nhwc(T.channel_shuffle(_nchw(r), 2))
    assert_close("shuffle", got, np.asarray(J.channel_shuffle(jnp.asarray(r), 2)), 0.0)
    assert_close("shuffle order", got[0, 0, 0], r[0, 0, 0][[0, 4, 1, 5, 2, 6, 3, 7]], 0.0)


@pytest.mark.parametrize("shape,target", [((20, 26, 10), (5, 7, 9)),
                                          ((9, 9, 16), (12, 18, 18))],
                         ids=["down", "up"])
def test_adaptive_avg_pool_chw(shape, target):
    """Pools channels as well as height and width, and upsamples an axis
    shorter than its target."""
    h, w, c = shape
    x = np.random.default_rng(3).normal(size=(2, h, w, c)).astype(np.float32)
    got = _nhwc(T.adaptive_avg_pool_chw(_nchw(x), *target))
    want = np.asarray(J.adaptive_avg_pool_chw(jnp.asarray(x), *target))
    assert got.shape == want.shape == (2, target[1], target[2], target[0])
    assert_close("adaptive pool", got, want, atol=1e-5)


def test_drop_block_zero_is_identity():
    x = _nchw(_x(4))
    assert T.drop_block_2d(x, 0.0) is x


@pytest.mark.parametrize("p", [0.05, 0.2])
def test_drop_block_keep_rate(p):
    """The dropped share of a large map is the JAX package's (both against
    the analytic 1 - (1 - p/25)^25 away from the borders, 1e-2), and the
    rescale keeps the mean of a constant input at 1."""
    x = np.ones((4, 96, 96, 16), np.float32)
    got = T.drop_block_2d(_nchw(x), p, 5, torch.Generator().manual_seed(0))
    want = np.asarray(J.drop_block_2d(jax.random.PRNGKey(0), jnp.asarray(x), p, 5))
    expected = 1 - (1 - p / 25) ** 25
    dropped = {"port": float((got == 0).float().mean()), "jax": float((want == 0).mean())}
    assert abs(dropped["port"] - expected) < 1e-2 and abs(dropped["jax"] - expected) < 1e-2
    assert_close(f"drop share p={p}", dropped["port"], dropped["jax"], atol=1e-2)
    assert_close("rescaled mean", float(got.mean()), 1.0, atol=1e-5)


@pytest.mark.parametrize("name", ["repvgg_identity", "repvgg_s2"])
def test_repvgg_deploy_fusion(name):
    """The folded 3x3 conv + ReLU gives the train-time block's eval output,
    and its kernel is the JAX package's fusion of the same weights."""
    from event_representation_study_tpu.utils.reparam import fuse_repvgg_block as jax_fuse

    _, tmod, variables, x, _ = _pair(name)
    xt = _nchw(x)
    w, b = reparam.fuse_repvgg_block(tmod)
    with torch.no_grad():
        want = tmod.eval()(xt)
        got = torch.relu(torch.nn.functional.conv2d(xt, w, b, tmod.stride, 1))
    assert_close(f"{name} fused", got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
    kj, bj = jax_fuse(variables["params"], variables["batch_stats"])
    assert_close(f"{name} kernel", w.numpy().transpose(2, 3, 1, 0), np.asarray(kj), atol=1e-6)
    assert_close(f"{name} bias", b.numpy(), np.asarray(bj), atol=1e-6)


def test_fuse_conv_bn_tree():
    """Every conv-BN pair of a block folds into one conv with bias."""
    _, tmod, _, x, _ = _pair("cspsppf")
    fused = reparam.fuse_conv_bn_tree(tmod)
    assert set(fused) == {f"cv{i}" for i in range(1, 8)}
    xt = _nchw(x)
    with torch.no_grad():
        conv = tmod.cv1.eval()
        want = conv.bn(conv.conv(xt))
        w, b = fused["cv1"]
        got = torch.nn.functional.conv2d(xt, w, b)
    assert_close("cv1 fused", got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
