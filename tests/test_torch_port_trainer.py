"""The port's Trainer (``train/engine.py``) and checkpoints
(``train/checkpoint.py``):

- the multi-epoch semantics of the JAX package's ``test_trainer_full.py``
  at 64 px: strong aug until the stop-aug boundary, the step count, the
  ``last_ckpt``, and a resume into a fresh Trainer that continues the
  schedule where an uninterrupted run would be;
- the Trainer built beside the JAX package's on the same config and data:
  accumulation, solver and loss configs, the accumulation ramp, the
  resolved ``aug_mode`` and ``warp_impl``, the eval cadence;
- a checkpoint round trip, bit-exact; ``strip_optimizer`` served by
  ``cli/infer.py --checkpoint``.

Weights across frameworks are in ``test_torch_port_checkpoint.py``.
"""
import types

import h5py
import numpy as np
import pytest
import torch

from event_representation_study_tpu.train import engine as jax_engine
from event_representation_study_tpu_torch.cli import infer
from event_representation_study_tpu_torch.data.gen1 import write_gen1_fixture
from event_representation_study_tpu_torch.models import build_model
from event_representation_study_tpu_torch.parallel.train_step import (
    init_train_state,
    make_train_step,
)
from event_representation_study_tpu_torch.train import checkpoint
from event_representation_study_tpu_torch.train.engine import Trainer
from event_representation_study_tpu_torch.train.losses import LossConfig
from event_representation_study_tpu_torch.train.optim import (
    SolverConfig,
    build_optimizer,
    with_accumulation,
)
from torch_port_helpers import assert_close, small_cfg

KW = dict(batch_size=2, img_size=64, num_events=512, device="cpu")


@pytest.fixture(scope="module")
def gen1_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("gen1_trainer")
    for i, split in enumerate(("training.h5", "validation.h5")):
        write_gen1_fixture(root / split, num_files=1, boxes_per_file=4, events_per_file=2000,
                           seed=11 + i)
    return root


def _counters(tr):
    tx = tr.state.opt_state
    return (tr.state.step, tx.mini_step, tx.gradient_step, tx.inner.count, tr.state.ema.updates)


def test_multi_epoch_stopaug_and_resume(gen1_root, tmp_path):
    cfg = small_cfg()
    out = tmp_path / "run"
    tr = Trainer(cfg, gen1_root, epochs=3, output_dir=out, eval_interval=1, augment=True,
                 stop_aug_last_n_epoch=1, seed=1, **KW)
    assert tr.accumulate == 32 and tr.aug_mode == "event"
    assert tr.train_loader.hyp["mosaic"] == 1.0
    steps = []
    step = tr.train_step
    tr.train_step = lambda state, batch, epoch: steps.append((epoch, batch.aug is not None)) \
        or step(state, batch, epoch)
    tr.train()
    # the stop-aug boundary (epoch 2 == 3 - 1) zeroed mosaic/mixup, kept the affine
    assert tr.train_loader.hyp["mosaic"] == 0.0 and tr.train_loader.hyp["mixup"] == 0.0
    assert tr.train_loader.hyp["degrees"] == cfg["data_aug"]["degrees"]
    assert steps == [(e, e < 2) for e in range(3) for _ in range(len(tr.train_loader))]
    assert (out / "last_ckpt").exists() and (out / "best_ckpt").exists()
    assert (out / "metrics.jsonl").read_text().count('"val/AP":') == 3
    steps_run = tr.state.step
    assert steps_run == 3 * len(tr.train_loader)

    # resume into a fresh trainer: schedule position and weights carry over
    tr2 = Trainer(cfg, gen1_root, epochs=4, output_dir=tmp_path / "run2", eval_interval=10,
                  augment=True, stop_aug_last_n_epoch=1, seed=1, **KW)
    tr2.state, tr2.start_epoch = checkpoint.restore_train_state(out / "last_ckpt", tr2.state)
    assert tr2.start_epoch == 3 and tr2.state.step == steps_run
    assert _counters(tr2) == _counters(tr)
    ema = {k: v.clone() for k, v in tr.state.ema.variables.items()}
    assert all(torch.equal(v, ema[k]) for k, v in tr2.state.ema.variables.items())
    tr2.train()  # one more epoch
    steps_now = steps_run + len(tr2.train_loader)
    assert tr2.state.step == steps_now
    # where an uninterrupted run would be: the accumulation ramp starts at one
    # micro-step an update, so every step so far was an update
    assert _counters(tr2) == (steps_now, 0, steps_now, steps_now, steps_now)
    assert tr2.state.opt_state.inner.decay_m == tr2.state.opt_state.inner.momentum_sched(
        steps_now - 1)
    stats = tr2.evaler.run(tr2.state.ema.variables)
    assert np.isfinite(stats["AP"])


def test_resume_auto_finds_the_newest_last_ckpt(tmp_path):
    import os

    from event_representation_study_tpu_torch.cli.train import find_latest_checkpoint

    for i, run in enumerate(("exp2", "exp", "exp3")):
        (tmp_path / run).mkdir()
        (tmp_path / run / "last_ckpt").write_bytes(b"")
        os.utime(tmp_path / run / "last_ckpt", (1e9 + i, 1e9 + i))
    assert find_latest_checkpoint(tmp_path) == str(tmp_path / "exp3" / "last_ckpt")
    with pytest.raises(FileNotFoundError):
        find_latest_checkpoint(tmp_path / "none")


def _jax_trainer(root, out, **kw):
    """The JAX Trainer without its initial state: the configuration under
    test is fixed before the state, whose op-by-op init takes ~25 s here."""
    fake_state = lambda *a, **k: types.SimpleNamespace(params=None, batch_stats=None)  # noqa: E731
    real = jax_engine.init_train_state
    import event_representation_study_tpu.utils.profiling as profiling

    real_info = profiling.get_model_info
    jax_engine.init_train_state, profiling.get_model_info = fake_state, lambda *a, **k: ""
    try:
        return jax_engine.Trainer(small_cfg(), root, output_dir=out, **kw)
    finally:
        jax_engine.init_train_state, profiling.get_model_info = real, real_info


@pytest.mark.parametrize("case", [dict(augment=True), dict(augment=True, aug_mode="image"),
                                  dict(augment=False, nominal_batch_size=8, epochs=7)],
                         ids=["event_auto", "image_separable", "no_aug"])
def test_trainer_configuration_like_jax(gen1_root, tmp_path, case):
    kw = {**dict(epochs=30, eval_interval=4, eval_interval_first=2), **KW, **case}
    tr = Trainer(small_cfg(), gen1_root, output_dir=tmp_path / "port", **kw)
    kw.pop("device")
    jt = _jax_trainer(gen1_root, tmp_path / "jax", **kw)
    assert tr.accumulate == jt.accumulate
    assert (tr.aug_mode, tr.warp_impl) == (jt.aug_mode, jt.warp_impl)
    assert tr.aug_mode == ("image" if case.get("aug_mode") == "image" else "event")
    assert tr.warp_impl == ("separable" if case.get("aug_mode") == "image" else "exact")
    assert tr.solver_cfg._asdict() == {k: getattr(jt.solver_cfg, k) for k in tr.solver_cfg._fields}
    assert tr.loss_cfg._asdict() == {k: getattr(jt.loss_cfg, k) for k in tr.loss_cfg._fields}
    assert [tr.should_eval(e) for e in range(tr.epochs)] == \
        [jt.should_eval(e) for e in range(jt.epochs)]
    assert len(tr.train_loader) == len(jt.train_loader)
    assert tr.train_loader.hyp == jt.train_loader.hyp
    # the accumulation ramp: micro-steps per update, update by update
    if tr.accumulate > 1:
        k = jt.tx._every_k_schedule
        updates = 1100
        assert [tr.state.opt_state.every_k(u) for u in range(updates)] == \
            [int(k(u)) for u in range(updates)]
        assert tr.accum_warmup_steps == 1000


def stepped_state(root, k_acc=3, steps=4):
    """A state after ``steps`` micro-steps with an accumulation window of
    ``k_acc`` (no ramp): momentum, accumulators, counters and EMA all
    non-trivial."""
    from event_representation_study_tpu_torch.data.gen1 import Gen1H5
    from event_representation_study_tpu_torch.data.loader import EventBatchLoader

    cfg = small_cfg()
    model = build_model(cfg, 2, device="cpu", generator=torch.Generator().manual_seed(2))
    sgd = build_optimizer(model, SolverConfig(epochs=3, steps_per_epoch=2))
    sgd.count = 1200  # past the warmup: every group moves
    state = init_train_state(model, with_accumulation(sgd, k_acc))
    step = make_train_step(LossConfig(2), "OptimizedRepresentation", img_size=64, device="cpu")
    loader = EventBatchLoader(Gen1H5(root, num_events=512), 2, img_size=64, seed=4,
                              hyp=dict(cfg["data_aug"], mosaic=0.0, mixup=0.0))
    for i, (batch, _) in zip(range(steps), (b for _ in range(steps) for b in loader)):
        state, _ = step(state, batch, i)
    return state


def _flat_state(state):
    tx = state.opt_state
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    out.update({f"momentum.{k}": v for k, v in tx.inner.momentum.items()})
    out.update({f"acc.{k}": v for k, v in tx.acc.items()})
    out.update({f"ema.{k}": v for k, v in state.ema.variables.items()})
    counters = (state.step, tx.mini_step, tx.gradient_step, tx.inner.count, tx.inner.decay_m,
                state.ema.updates)
    return out, counters


def test_checkpoint_round_trip_is_exact(gen1_root, tmp_path):
    state = stepped_state(gen1_root)
    want, want_counters = _flat_state(state)
    assert want_counters[1] == 1 and want_counters[2] == 1  # mid-window
    checkpoint.save_checkpoint(tmp_path / "ckpt", state, epoch=5)
    fresh = init_train_state(
        build_model(small_cfg(), 2, device="cpu", generator=torch.Generator().manual_seed(9)),
        with_accumulation(build_optimizer(state.model, SolverConfig(epochs=3, steps_per_epoch=2)),
                          3))
    fresh.opt_state = with_accumulation(build_optimizer(fresh.model, fresh.opt_state.inner.cfg), 3)
    fresh, start = checkpoint.restore_train_state(tmp_path / "ckpt", fresh)
    got, got_counters = _flat_state(fresh)
    assert start == 6 and got_counters == want_counters
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert any(float(v.abs().max()) > 0 for k, v in want.items() if k.startswith("acc."))
    # the restored optimizer steps on the restored model's own parameters
    assert all(fresh.opt_state.inner.params[n] is p for n, p in fresh.model.named_parameters())


def _events_file(path):
    rng = np.random.default_rng(6)
    n = 3000
    with h5py.File(path, "w") as f:
        f["events/x"] = rng.integers(0, 304, n).astype(np.uint16)
        f["events/y"] = rng.integers(0, 240, n).astype(np.uint16)
        f["events/t"] = np.sort(rng.integers(0, 10**6, n))
        f["events/p"] = rng.integers(0, 2, n).astype(np.int8)
        f["events/height"], f["events/width"] = 240, 304


def test_strip_optimizer_serves_through_infer_cli(gen1_root, tmp_path):
    state = stepped_state(gen1_root, steps=2)
    gen = torch.Generator().manual_seed(3)
    for k, v in state.ema.variables.items():  # pred convs that score and place boxes
        if "_pred" in k:
            v.add_(torch.randn(v.shape, generator=gen) * 0.5)
    checkpoint.save_checkpoint(tmp_path / "last_ckpt", state, epoch=0)
    checkpoint.strip_optimizer(tmp_path / "last_ckpt", tmp_path / "deploy")
    deploy = checkpoint.load_checkpoint(tmp_path / "deploy")
    assert list(deploy) == ["variables"]
    assert all(torch.equal(v, state.ema.variables[k]) for k, v in deploy["variables"].items())
    _events_file(tmp_path / "ev.h5")
    args = ["--events", str(tmp_path / "ev.h5"), "--device", "cpu", "--img-size", "64",
            "--num-events", "2048", "--conf-thres", "0.001",
            "--override", "model.depth_multiple=0.2", "model.width_multiple=0.125"]
    got = {c: infer.main(args + ["--checkpoint", str(tmp_path / c)])
           for c in ("deploy", "last_ckpt")}
    random_init = infer.main(args)
    assert_close("served dets, stripped vs train checkpoint", got["deploy"], got["last_ckpt"],
                 atol=0)
    assert len(got["deploy"]) > 0
    assert got["deploy"].shape != random_init.shape or not np.array_equal(got["deploy"],
                                                                         random_init)
