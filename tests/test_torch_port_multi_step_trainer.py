"""The port's Trainer with K steps a call (``steps_per_dispatch=2``) on a
Gen1 fixture of 5 batches an epoch, so that an epoch makes 2 K-step calls
and 1 remainder step through the per-batch step:

- the calls, the step count and the EMA updates under both cadences;
- under ``ema_cadence="step"`` the run is bit-equal to the per-batch
  Trainer (K = 1) from the same seed; under ``"dispatch"`` the parameters
  are bit-equal to it and the EMA within 2e-3 (the JAX package's own bound
  for the once-a-call blend, ``tests/test_train.py``);
- a resume from the K = 2 run's ``last_ckpt`` continues the counters;
- ``cli/train.py --steps-per-dispatch 2 --ema-cadence dispatch`` with the
  TensorBoard writer (``--override use_tensorboard=True``).
"""
import numpy as np
import pytest
import torch

from event_representation_study_tpu_torch.cli import train as train_cli
from event_representation_study_tpu_torch.data.gen1 import write_gen1_fixture
from event_representation_study_tpu_torch.train import checkpoint
from event_representation_study_tpu_torch.train.engine import Trainer
from torch_port_helpers import SMALL, assert_close, small_cfg

KW = dict(batch_size=2, img_size=64, num_events=512, device="cpu", augment=True, seed=3)
WINDOWS = 10  # 5 batches of 2: two K = 2 calls and one remainder step


@pytest.fixture(scope="module")
def gen1_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("gen1_k_steps")
    write_gen1_fixture(root / "training.h5", num_files=1, boxes_per_file=WINDOWS,
                       events_per_file=5000, seed=21)
    write_gen1_fixture(root / "validation.h5", num_files=1, boxes_per_file=2,
                       events_per_file=2000, seed=22)
    return root


def _run(root, out, **kw):
    """A 1-epoch Trainer run; returns it with the calls it made, in order:
    "k" for a K-step call, "1" for a per-batch step."""
    tr = Trainer(small_cfg(), root, epochs=1, output_dir=out, **KW, **kw)
    calls = []
    step = tr.train_step
    tr.train_step = lambda *a: calls.append("1") or step(*a)
    if tr.steps_per_dispatch > 1:
        multi = tr.multi_step
        tr.multi_step = lambda *a: calls.append("k") or multi(*a)
    tr.train()
    return tr, calls


@pytest.fixture(scope="module")
def runs(gen1_root, tmp_path_factory):
    out = tmp_path_factory.mktemp("k_runs")
    return {name: _run(gen1_root, out / name, **kw) for name, kw in (
        ("k1", {}), ("step", dict(steps_per_dispatch=2)),
        ("dispatch", dict(steps_per_dispatch=2, ema_cadence="dispatch")))}


def _state(tr):
    return tr.state.model.state_dict(), tr.state.ema.variables


@pytest.mark.parametrize("cadence", ["step", "dispatch"])
def test_k_step_epoch(runs, cadence):
    tr, calls = runs[cadence]
    assert len(tr.train_loader) == WINDOWS // 2
    assert calls == ["k", "k", "1"]
    tx = tr.state.opt_state
    assert (tr.state.step, tr.state.ema.updates, tx.gradient_step) == (5, 5, 5)
    assert runs["k1"][1] == ["1"] * 5
    (model, ema), (model1, ema1) = _state(tr), _state(runs["k1"][0])
    assert all(torch.equal(model[k], model1[k]) for k in model1)
    if cadence == "step":
        assert all(torch.equal(ema[k], ema1[k]) for k in ema1)
    else:
        err = max(float((ema[k] - ema1[k]).abs().max()) for k in ema1)
        assert_close("EMA dispatch vs per-step cadence", err, 0.0, atol=2e-3)
        assert any(not torch.equal(ema[k], ema1[k]) for k in ema1)
    assert (tr.output_dir / "last_ckpt").exists()


def test_k_step_resume(runs, gen1_root, tmp_path):
    tr, _ = runs["dispatch"]
    tr2 = Trainer(small_cfg(), gen1_root, epochs=2, output_dir=tmp_path, steps_per_dispatch=2,
                  ema_cadence="dispatch", **KW)
    tr2.state, tr2.start_epoch = checkpoint.restore_train_state(
        tr.output_dir / "last_ckpt", tr2.state)
    assert (tr2.start_epoch, tr2.state.step, tr2.state.ema.updates) == (1, 5, 5)
    tr2.train()
    assert (tr2.state.step, tr2.state.ema.updates, tr2.state.opt_state.gradient_step) == \
        (10, 10, 10)


def test_cli_k_steps_with_tensorboard(gen1_root, tmp_path):
    out = tmp_path / "cli"
    tr = train_cli.main([
        "--data-path", str(gen1_root), "--device", "cpu", "--img-size", "64",
        "--num-events", "512", "--batch-size", "2", "--epochs", "1", "--augment",
        "--steps-per-dispatch", "2", "--ema-cadence", "dispatch", "--output-dir", str(out),
        "--override", *SMALL, "use_tensorboard=True"])
    assert tr.steps_per_dispatch == 2 and (tr.state.step, tr.state.ema.updates) == (5, 5)
    events = list((out / "tb").glob("events.out.tfevents.*"))
    assert len(events) == 1 and events[0].stat().st_size > 0
    assert np.isfinite(tr.best_ap)
