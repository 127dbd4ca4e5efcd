"""Deploy tools of the detector, port against JAX on the CPU:

- ``utils/quantize.py``: ``quantize_params`` of the shrunk paper detector
  with a ``skip`` list (substrings of Flax paths, as a config's
  ``ptq.sensitive_layers_skip``): the same weights quantized and skipped,
  the int8 values equal after the layout transpose and the scales to 1e-6
  relative; ``fake_quant_params`` likewise; ``calibrate_activations`` on
  nested outputs, names and ranges (max and percentile) equal;
- ``train/rep_optimizer.py``: the OIHW gradient mask equal to the JAX HWIO
  one transposed, the branch-sum re-init equal to the scaled branch sum
  (1e-4), and masked gradients through one SGD step equal to the JAX
  ``repopt_grad_mask`` chain's (1e-6);
- ``train/checkpoint.py::load_teacher_variables`` on a train checkpoint
  (its EMA variables, not the live ones) and on a stripped deploy
  checkpoint of each package, from the same weights: equal.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event_representation_study_tpu.models import build_model as jax_build_model
from event_representation_study_tpu.train import rep_optimizer as jax_repopt
from event_representation_study_tpu.utils import quantize as jax_quantize
from event_representation_study_tpu_torch.models import build_model
from event_representation_study_tpu_torch.train import rep_optimizer as repopt
from event_representation_study_tpu_torch.utils import quantize
from event_representation_study_tpu_torch.utils.convert import flax_to_torch, to_flax_leaves
from torch_port_helpers import assert_close, jax_leaves, random_jax_variables, small_cfg

SKIP = ("head/cls_pred", "backbone/stem", "neck/upsample")


def _skip(name: str) -> bool:
    return any(s in name for s in SKIP)


@pytest.fixture(scope="module")
def detector():
    cfg = small_cfg()
    jm = jax_build_model(cfg, num_classes=2)
    variables = random_jax_variables(jm, 64)
    model = build_model(cfg, 2, device="cpu")
    model.load_state_dict(flax_to_torch(variables), strict=True)
    return variables, model


def _port_quantized_leaves(qstate):
    """The q (in the Flax layout) and scale of each quantized port weight,
    by Flax path."""
    q, scale = {}, {}
    for name, v in qstate.items():
        if isinstance(v, dict):
            (path, arr), = to_flax_leaves({name: v["q"].to(torch.float32)}).items()
            q[path], scale[path] = arr, v["scale"].numpy()
    return q, scale


def test_quantize_params_matches_jax(detector):
    variables, model = detector
    q_j, meta_j = jax_quantize.quantize_params(variables["params"], skip=_skip)
    qstate, meta = quantize.quantize_params(model, skip=_skip)
    assert set(meta) == set(meta_j) and len(meta) > 50
    assert not any(_skip(k) for k in meta)
    assert all(meta[k]["scale_shape"] == tuple(meta_j[k]["scale_shape"]) for k in meta)
    q, scale = _port_quantized_leaves(qstate)
    for path in meta:
        want = jax_leaves(q_j, "params")
        assert_close(f"int8 {path}", q[f"params/{path}"], want[f"params/{path}/q"], atol=0)
        assert_close(f"scale {path}", scale[f"params/{path}"], want[f"params/{path}/scale"],
                     atol=0, rtol=1e-6)
    # every weight not quantized is stored as it was
    kept = {k: v for k, v in qstate.items() if not isinstance(v, dict)}
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in kept.items())
    assert all(qstate[k]["q"].dtype == torch.int8 for k in qstate if k not in kept)


def test_fake_quant_matches_jax(detector):
    variables, model = detector
    want = jax_leaves(jax_quantize.fake_quant_params(variables["params"], skip=_skip), "params")
    got = to_flax_leaves(quantize.fake_quant_params(model, skip=_skip))
    assert set(k for k in got if k.startswith("params/")) == set(want)
    worst = max(float(np.abs(got[k] - want[k]).max() / (np.abs(want[k]).max() + 1e-12))
                for k in want)
    assert_close("fake-quant weights / leaf scale", worst, 0.0, atol=1e-6)


def test_calibrate_activations_matches_jax():
    def apply_fn(variables, batch):
        return {"head": [batch * variables["w"], -batch], "act": batch + 1}

    batches = [np.random.default_rng(i).normal(size=(3, 5)).astype(np.float32)
               for i in range(3)]
    for pct in (None, 50.0):
        want = jax_quantize.calibrate_activations(
            apply_fn, {"w": 2.0}, [jnp.asarray(b) for b in batches], percentile=pct)
        got = quantize.calibrate_activations(
            apply_fn, {"w": 2.0}, [torch.from_numpy(b) for b in batches],
            percentile=pct)
        assert set(got) == set(want) == {"head/[0]", "head/[1]", "act"}
        for k in want:
            assert_close(f"calibrated range {k} (percentile {pct})", got[k], want[k], atol=0,
                         rtol=1e-6)


def test_repopt_mask_reinit_and_masked_gradients():
    rng = np.random.default_rng(0)
    c = 4
    k3 = rng.normal(size=(3, 3, c, c)).astype(np.float32)  # HWIO
    k1 = rng.normal(size=(1, 1, c, c)).astype(np.float32)
    s_conv, s_1x1, s_id = (rng.normal(size=c).astype(np.float32) for _ in range(3))
    oihw = functools.partial(np.transpose, axes=(3, 2, 0, 1))

    m_j = jax_repopt.grad_mask((3, 3, c, c), s_conv, s_1x1, s_id)
    m = repopt.grad_mask((c, c, 3, 3), s_conv, s_1x1, s_id)
    assert_close("RepOpt grad mask (OIHW)", m, oihw(m_j), atol=0)
    assert_close("RepOpt re-init kernel (OIHW)",
                 repopt.reinit_kernel(oihw(k3), oihw(k1), s_conv, s_1x1, s_id),
                 oihw(jax_repopt.reinit_kernel(k3, k1, s_conv, s_1x1, s_id)), atol=1e-6)

    # the re-initialised plain conv equals the scaled branch sum
    x = torch.from_numpy(rng.normal(size=(1, c, 8, 8)).astype(np.float32))
    conv = functools.partial(torch.nn.functional.conv2d, padding=1)
    want = (conv(x, torch.from_numpy(oihw(k3))) * torch.from_numpy(s_conv)[:, None, None]
            + torch.nn.functional.conv2d(x, torch.from_numpy(oihw(k1)))
            * torch.from_numpy(s_1x1)[:, None, None]
            + x * torch.from_numpy(s_id)[:, None, None])
    got = conv(x, torch.from_numpy(repopt.reinit_kernel(oihw(k3), oihw(k1), s_conv, s_1x1, s_id)))
    assert_close("RepOpt re-init conv vs branch sum", got.numpy(), want.numpy(), atol=1e-4)

    # masked gradients through one SGD step, against the optax chain
    import optax

    params = {"a": {"kernel": jnp.ones((3, 3, c, c))}, "b": {"kernel": jnp.ones((2,))}}
    tx = optax.chain(jax_repopt.repopt_grad_mask({"a/kernel": jnp.asarray(m_j)}),
                     optax.sgd(1.0))
    upd_j, _ = tx.update(jax.tree.map(jnp.ones_like, params), tx.init(params), params)
    mod = torch.nn.Module()
    mod.a = torch.nn.Conv2d(c, c, 3, bias=False)
    mod.b = torch.nn.Parameter(torch.ones(2))
    handles = repopt.repopt_grad_mask(mod, {"a.weight": torch.from_numpy(m)})
    before = {n: p.detach().clone() for n, p in mod.named_parameters()}
    (mod.a.weight.sum() + mod.b.sum()).backward()  # every gradient 1
    opt = torch.optim.SGD(mod.parameters(), lr=1.0)
    opt.step()
    assert_close("RepOpt masked update a", oihw(np.asarray(upd_j["a"]["kernel"])),
                 (mod.a.weight - before["a.weight"]).detach().numpy(), atol=1e-6)
    assert_close("RepOpt unmasked update b", np.asarray(upd_j["b"]["kernel"]),
                 (mod.b - before["b"]).detach().numpy(), atol=1e-6)
    for h in handles:
        h.remove()
    with pytest.raises(KeyError):
        repopt.repopt_grad_mask(mod, {"c.weight": torch.from_numpy(m)})


@pytest.mark.parametrize("layout", ["train", "deploy"])
def test_load_teacher_variables_matches_jax(detector, layout, tmp_path):
    from event_representation_study_tpu.parallel.train_step import TrainState as JaxTrainState
    from event_representation_study_tpu.train import checkpoint as jax_ckpt
    from event_representation_study_tpu.train.ema import EMAState as JaxEMAState
    from event_representation_study_tpu_torch.parallel.train_step import TrainState
    from event_representation_study_tpu_torch.train import checkpoint
    from event_representation_study_tpu_torch.train.ema import EMAState, ema_init
    from event_representation_study_tpu_torch.train.optim import SolverConfig, build_optimizer

    variables, model = detector
    # the EMA differs from the live weights: the teacher must be the EMA
    ema_vars = jax.tree.map(lambda a: np.asarray(a) * 0.5 + 0.25, variables)
    state_j = JaxTrainState(variables["params"], variables["batch_stats"], {"x": np.zeros(1)},
                            JaxEMAState(ema_vars, np.int32(3)), np.int32(7))
    jax_ckpt.save_checkpoint(tmp_path / "jax_train", state_j, epoch=1)
    ema = ema_init(model).variables
    with torch.no_grad():
        for k, v in flax_to_torch(ema_vars).items():
            if k in ema:
                ema[k].copy_(v)
    state = TrainState(model, build_optimizer(model, SolverConfig()), EMAState(ema, 3), 7)
    checkpoint.save_checkpoint(tmp_path / "port_train", state, epoch=1)
    if layout == "deploy":
        jax_ckpt.strip_optimizer(tmp_path / "jax_train", tmp_path / "jax_deploy")
        checkpoint.strip_optimizer(tmp_path / "port_train", tmp_path / "port_deploy")
    want = jax_ckpt.load_teacher_variables(tmp_path / f"jax_{layout}")
    want = {**jax_leaves(want["params"], "params"),
            **jax_leaves(want["batch_stats"], "batch_stats")}
    got = to_flax_leaves(checkpoint.load_teacher_variables(tmp_path / f"port_{layout}"))
    assert set(got) == set(want)
    for k in want:
        assert_close(f"teacher ({layout}) {k}", got[k], want[k], atol=0)
    assert_close(f"teacher ({layout}) is the EMA", got["params/head/stem_0/conv/kernel"],
                 np.asarray(ema_vars["params"]["head"]["stem_0"]["conv"]["kernel"]), atol=0)
