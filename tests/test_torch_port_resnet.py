"""``models/resnet.py::EventResNet`` against the JAX package's Flax
``EventResNet``: the forward in eval and train mode on weights carried by
``utils/convert.py::flax_to_torch`` (ResNet18 of BasicBlocks and ResNet50
of Bottlenecks, 64², 12 channels, stem kernel 14), train mode's BatchNorm
statistics, and the Dense rule of the conversion both ways.

Tolerances: logits rtol 1e-4 with a floor of 1e-4 of the largest (ResNet50
in train mode 5e-4, see below); BatchNorm statistics atol 1e-4 + rtol
2e-3; the conversion round trip exact."""
import jax
import numpy as np
import pytest
import torch

from event_representation_study_tpu.models.resnet import EventResNet as JaxResNet
from event_representation_study_tpu_torch.models.resnet import EventResNet
from event_representation_study_tpu_torch.utils.convert import flax_to_torch, to_flax_leaves
from torch_port_helpers import assert_close, random_jax_variables

IMG, NC = 64, 10


def _close(what, got, want, rtol=1e-4):
    want = np.asarray(want)
    assert_close(what, got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()))


def _flat(tree, prefix):
    return {f"{prefix}/{'/'.join(k.key for k in path)}": np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", ["ResNet18", "ResNet50"])
def test_forward_like_flax(arch):
    """Eval and train forward, and the BatchNorm statistics of train mode.
    ResNet50's train mode: both packages' float32 logits lie up to 2.5e-4
    of the largest from a float64 run of the same weights (JAX's the
    farther), so the port is held to 5e-4 of JAX's and to 1e-4 of the
    float64 run's."""
    x = np.random.default_rng(0).normal(size=(2, IMG, IMG, 12)).astype(np.float32)
    jm = JaxResNet(num_classes=NC, arch=arch)
    variables = random_jax_variables(jm, IMG, seed=2)
    model = EventResNet(NC, arch)
    model.load_state_dict(flax_to_torch(variables), strict=True)
    f64 = EventResNet(NC, arch).double()
    f64.load_state_dict(flax_to_torch(variables), strict=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    model.eval()
    with torch.no_grad():
        _close(f"{arch} eval logits", model(xt).numpy(),
               jax.jit(jm.apply, static_argnums=2)(variables, x, False))
        model.train()
        got, ref64 = model(xt).numpy(), f64.train()(xt.double()).numpy()
    want, upd = jax.jit(lambda v, x: jm.apply(v, x, True, mutable=["batch_stats"]))(
        variables, x)
    _close(f"{arch} train logits", got, want, rtol=1e-4 if arch == "ResNet18" else 5e-4)
    _close(f"{arch} train logits vs float64", got, ref64)
    stats = to_flax_leaves(model.state_dict())
    ref = _flat(upd["batch_stats"], "batch_stats")
    assert_close(f"{arch} BN statistics", np.concatenate([stats[k].ravel() for k in sorted(ref)]),
                 np.concatenate([ref[k].ravel() for k in sorted(ref)]), atol=1e-4, rtol=2e-3)


def test_dense_kernel_converts_both_ways():
    """The fc Dense kernel (in, out) becomes the Linear weight (out, in),
    and ``to_flax_leaves`` gives every Flax leaf back unchanged."""
    variables = random_jax_variables(JaxResNet(num_classes=NC, arch="ResNet18"), IMG, seed=4)
    state = flax_to_torch(variables)
    kernel = np.asarray(variables["params"]["fc"]["kernel"])
    assert kernel.shape == (512, NC)
    np.testing.assert_array_equal(state["fc.weight"].numpy(), kernel.T)
    back = to_flax_leaves(state)
    want = _flat(variables["params"], "params") | _flat(variables["batch_stats"], "batch_stats")
    assert set(back) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
