"""Mini N-ImageNet classification of the port against the JAX package
(``EventResNet``'s forward alone is in ``test_torch_port_resnet.py``):
one ``ClassifierTrainer`` step with Adam, SGD
and the ``all_except_fc`` freeze on ERGO-12-built batches (loss, logits,
updated parameters, BatchNorm statistics); ``run_epoch``'s accuracies,
loss and tail handling; ``PlateauScheduler``; a checkpoint round trip; and
``cli/classify.py`` on a tiny fixture with ``--device cpu``.

The trainers run at 64² instead of 224² (the classifier and dataset
modules' ``IMAGE_H``/``IMAGE_W`` patched in both packages), so that one JAX
step compiles in seconds. Tolerances: logits rtol 1e-4 with a floor of
1e-4 of the largest; loss rtol 1e-4; parameter updates 2e-2 over each
leaf's scale, as the detector's step tests; for Adam, whose first update
is lr * g / (|g| + eps), elements whose JAX gradient is below 1e-4 of its
leaf's largest are left out (there the update's sign is rounding);
BatchNorm statistics atol 1e-4 + rtol 2e-3; ``run_epoch``'s accuracies
equal and its mean loss, two Adam steps further on, rtol 1e-3."""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from event_representation_study_tpu.data import nimagenet as jax_nim
from event_representation_study_tpu.models.resnet import EventResNet as JaxResNet
from event_representation_study_tpu.train import classifier as jax_cls
from event_representation_study_tpu_torch.cli import classify
from event_representation_study_tpu_torch.data import nimagenet
from event_representation_study_tpu_torch.models.resnet import EventResNet
from event_representation_study_tpu_torch.train import classifier
from event_representation_study_tpu_torch.utils.convert import flax_to_torch, to_flax_leaves
from torch_port_helpers import assert_close, random_jax_variables

IMG, NC, BATCH, SLICE = 64, 10, 4, 2000
MODES = {"adam": dict(optimizer="Adam"), "sgd": dict(optimizer="SGD", lr=0.05),
         "freeze": dict(optimizer="Adam", freeze="all_except_fc")}


def _close(what, got, want, rtol=1e-4):
    want = np.asarray(want)
    assert_close(what, got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()))


def _leafwise(got, want, before, mask=None):
    """Every leaf's change, divided by the JAX change's largest entry plus
    1e-3 of the largest over all leaves (the detector tests' measure)."""
    top = max(float(np.abs(want[k] - before[k]).max()) for k in want)
    g, w = [], []
    for k in sorted(want):
        dw, dg = want[k] - before[k], got[k] - before[k]
        keep = np.ones(dw.shape, bool) if mask is None else mask[k]
        scale = float(np.abs(dw).max()) + 1e-3 * top
        g.append(dg[keep] / scale)
        w.append(dw[keep] / scale)
    return np.concatenate(g), np.concatenate(w)


def _flat(tree, prefix):
    return {f"{prefix}/{'/'.join(k.key for k in path)}": np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def small_images():
    """The classifier's and the dataset's frame at 64² in both packages."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_cls, jax_nim, classifier, nimagenet):
            mp.setattr(mod, "IMAGE_H", IMG)
            mp.setattr(mod, "IMAGE_W", IMG)
        yield


@pytest.fixture(scope="module")
def data(tmp_path_factory, small_images):
    """10 npz samples of 2,500 events; the port's and the JAX dataset."""
    files = nimagenet.write_nimagenet_fixture(tmp_path_factory.mktemp("cls"), num_classes=5,
                                              per_class=2, n_events=2500, seed=3)
    return (nimagenet.NImageNetDataset(*files, slice_length=SLICE, seed=1),
            jax_nim.NImageNetDataset(*files, slice_length=SLICE, seed=1))


@pytest.fixture(scope="module")
def steps(data, small_images):
    """One train step in each mode, from the same random weights and on
    the same ERGO-12 batch: {mode: (port trainer, port out, JAX out)} and
    the weights before."""
    variables = random_jax_variables(JaxResNet(num_classes=NC, arch="ResNet18"), IMG, seed=5)
    ds, jds = data
    blocks, labels = classifier.ClassifierTrainer._collate([ds[i] for i in range(BATCH)])
    jblocks, jlabels = jax_cls.ClassifierTrainer._collate([jds[i] for i in range(BATCH)])
    before = to_flax_leaves(EventResNet(NC, "ResNet18").state_dict()
                            | flax_to_torch(variables))
    out = {}
    for mode, kw in MODES.items():
        jt = jax_cls.ClassifierTrainer(JaxResNet(num_classes=NC, arch="ResNet18"),
                                       "OptimizedRepresentation", NC, **kw)
        params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
        jt.tx = (optax.multi_transform({"train": jt._inner_tx, "frozen": optax.set_to_zero()},
                                       jax_cls.freeze_labels(params, kw["freeze"]))
                 if "freeze" in kw else jt._inner_tx)  # what init() picks
        jt.state = jax_cls.ClassifierState(params, variables["batch_stats"],
                                           jt.tx.init(params), jnp.zeros((), jnp.int32))
        state, loss, logits = jt._train_step(jt.state, jblocks, jnp.asarray(jlabels))
        jt.state = state
        want = {"loss": float(loss), "logits": np.asarray(logits),
                "leaves": _flat(state.params, "params") | _flat(state.batch_stats, "batch_stats"),
                "trainer": jt}

        pt = classifier.ClassifierTrainer(EventResNet(NC, "ResNet18"), "OptimizedRepresentation",
                                          NC, device="cpu", **kw)
        pt.init()
        pt.model.load_state_dict(flax_to_torch(variables), strict=True)
        loss, logits = pt.train_step(blocks.to("cpu"), torch.from_numpy(labels))
        got = {"loss": float(loss), "logits": logits.numpy(),
               "leaves": to_flax_leaves(pt.model.state_dict())}
        out[mode] = (pt, got, want)
    return out, before


@pytest.mark.parametrize("mode", list(MODES))
def test_step_loss_and_logits(steps, mode):
    _, got, want = steps[0][mode]
    assert_close(f"{mode} loss", got["loss"], want["loss"], atol=0, rtol=1e-4)
    _close(f"{mode} logits", got["logits"], want["logits"])


@pytest.mark.parametrize("mode", list(MODES))
def test_step_updates_parameters(steps, mode):
    (_, got, want), before = steps[0][mode], steps[1]
    keys = [k for k in want["leaves"] if k.startswith("params/")]
    g, w, b = ({k: d[k] for k in keys} for d in (got["leaves"], want["leaves"], before))
    if mode == "freeze":
        # frozen leaves keep their values exactly, in both packages
        for k in keys:
            if not k.startswith("params/fc/"):
                np.testing.assert_array_equal(w[k], b[k], err_msg=k)
                np.testing.assert_array_equal(g[k], b[k], err_msg=k)
        g, w, b = ({k: d[k] for k in keys if k.startswith("params/fc/")} for d in (g, w, b))
    mask = None
    if mode == "adam":
        # the gradient, from the SGD step on the same weights and batch:
        # its update is -lr * (g + weight_decay * p)
        sgd = steps[0]["sgd"][2]["leaves"]
        grads = {k: -(sgd[k] - b[k]) / MODES["sgd"]["lr"] - 1e-4 * b[k] for k in keys}
        mask = {k: np.abs(grads[k]) >= 1e-4 * np.abs(grads[k]).max() for k in keys}
        assert sum(int((~m).sum()) for m in mask.values()) < 1e-2 * sum(m.size for m in mask.values())
    assert_close(f"{mode} parameter update / leaf scale", *_leafwise(g, w, b, mask), atol=2e-2)


@pytest.mark.parametrize("mode", list(MODES))
def test_step_batch_statistics(steps, mode):
    (_, got, want), before = steps[0][mode], steps[1]
    keys = sorted(k for k in want["leaves"] if k.startswith("batch_stats/"))
    assert keys and set(keys) <= set(got["leaves"])
    assert not all(np.array_equal(want["leaves"][k], before[k]) for k in keys)  # they moved
    g = np.concatenate([got["leaves"][k].ravel() for k in keys])
    w = np.concatenate([want["leaves"][k].ravel() for k in keys])
    assert_close(f"{mode} BN statistics", g, w, atol=1e-4, rtol=2e-3)


def test_run_epoch_like_jax(steps, data):
    """An epoch of 10 samples at batch 4 after the Adam step: training
    drops the 2-sample tail (2 steps), evaluation pads it and counts 10
    rows."""
    ds, jds = data
    pt, _, want = steps[0]["adam"]
    jt = want["trainer"]
    calls = []
    real_eval = pt.eval_step
    pt.eval_step = lambda batch: calls.append(1) or real_eval(batch)
    try:
        for train in (True, False):
            got = pt.run_epoch(ds, BATCH, train=train)
            ref = jt.run_epoch(jds, BATCH, train=train)
            assert set(got) == set(ref) and got["load_s"] >= 0 and got["infer_s"] > 0
            for k in ("top1", "top5"):
                assert_close(f"run_epoch train={train} {k}", got[k], ref[k], atol=0)
            if train:
                assert pt.step == 3  # the step of the fixture, then 2
                assert_close("run_epoch loss", got["loss"], ref["loss"], atol=0, rtol=1e-3)
    finally:
        pt.eval_step = real_eval
    assert len(calls) == 3 and round(got["top1"] * 10, 6) % 1 == 0


def test_plateau_scheduler_like_jax():
    metrics = [0.1, 0.2, 0.2, 0.20001, 0.19, 0.2, 0.3, 0.3, 0.3, 0.3, 0.3, 0.31, 0.31]
    for kw in (dict(), dict(mode="min", patience=1, factor=0.5, min_lr=1e-3)):
        got, want = classifier.PlateauScheduler(0.01, **kw), jax_cls.PlateauScheduler(0.01, **kw)
        assert [got.step(m) for m in metrics] == [want.step(m) for m in metrics]
    pt = classifier.ClassifierTrainer(EventResNet(3, "ResNet18", in_channels=2), None, 3,
                                      lr=0.01, plateau=True, device="cpu")
    pt.init()
    lrs = [pt.plateau_step(0.5) for _ in range(5)]
    assert lrs == [0.01] * 4 + [0.001]
    assert all(g["lr"] == 0.001 for g in pt.optimizer.param_groups)


def test_checkpoint_round_trip(steps, data, tmp_path):
    """save after the Adam step, load into a fresh trainer: the same
    weights, BatchNorm statistics, optimizer state and step; the next
    steps from both agree exactly."""
    ds, _ = data
    pt = steps[0]["adam"][0]
    pt.save(tmp_path / "ckpt", epoch=4)
    fresh = classifier.ClassifierTrainer(EventResNet(NC, "ResNet18"), "OptimizedRepresentation",
                                         NC, device="cpu", seed=9)
    fresh.init()
    assert fresh.load(tmp_path / "ckpt") == 5 and fresh.step == pt.step
    for k, v in pt.model.state_dict().items():
        torch.testing.assert_close(fresh.model.state_dict()[k], v, rtol=0, atol=0)
    blocks, labels = classifier.ClassifierTrainer._collate([ds[i] for i in range(BATCH)])
    a = pt.train_step(blocks.to("cpu"), torch.from_numpy(labels))
    b = fresh.train_step(blocks.to("cpu"), torch.from_numpy(labels))
    assert_close("loss after resume", b[0], a[0], atol=0)
    for k, v in pt.model.state_dict().items():
        torch.testing.assert_close(fresh.model.state_dict()[k], v, rtol=0, atol=0)


@pytest.mark.parametrize("loader_type", ["reshape_then_optimized", "reshape_then_acc_count_pol"])
def test_classify_cli_on_cpu(tmp_path, loader_type):
    """``cli/classify.py`` at 224² with ResNet18 on a tiny fixture: ERGO-12
    built by ``batched_representation``, and a prebuilt host-image loader."""
    lists = {}
    for split, seed in (("train", 0), ("val", 50)):
        files, _ = nimagenet.write_nimagenet_fixture(tmp_path / split, num_classes=2, per_class=2,
                                                     n_events=1500, seed=seed)
        lists[split] = tmp_path / f"{split}.txt"
        lists[split].write_text("\n".join(files))
    ini = tmp_path / "study.ini"
    ini.write_text(f"[data]\nloader_type = {loader_type}\nslice_length = 1000\n"
                   "[model]\nmodel = ResNet18\nnum_classes = 2\n[train]\nbatch_size = 2\n")
    history = classify.main(["--config", str(ini), "--train-list", str(lists["train"]),
                             "--val-list", str(lists["val"]), "--device", "cpu",
                             "--override", "epochs=1", "seed=3"])
    assert len(history) == 1
    tr, va = history[0]["train"], history[0]["val"]
    assert np.isfinite(tr["loss"]) and 0 <= va["top1"] <= va["top5"] <= 1
    assert pathlib.Path(lists["train"]).exists()
