"""The training variants through the port's Trainer and CLIs on the CPU
(64 px, the shrunk paper config, a two-split Gen1 fixture), as the JAX
package's ``test_distill_fuseab_e2e.py`` and ``test_learned_e2e.py`` drive
its own:

- ``cli/train.py --fuse-ab``: an epoch through the anchor-base branch;
- ``cli/train.py --distill --distill-feat --teacher-ckpt``: the teacher is
  the checkpoint's EMA, its BatchNorm statistics unchanged by an epoch;
  without ``--teacher-ckpt`` it is the init of ``seed + 1``; distill with
  fuse-ab refuses;
- ``cli/train.py --fuse-ab --quant --calib``: no training, ``ptq_ckpt``
  with int8 weights, positive activation ranges and the metrics;
- the learned representation: an epoch, then ``cli/eval.py`` on its
  checkpoint; with ``--augment`` it refuses.
"""
import numpy as np
import pytest
import torch

from event_representation_study_tpu_torch.cli import eval as eval_cli
from event_representation_study_tpu_torch.cli import train as train_cli
from event_representation_study_tpu_torch.data.gen1 import write_gen1_fixture
from event_representation_study_tpu_torch.models import build_model, init_weights_
from event_representation_study_tpu_torch.train import checkpoint
from event_representation_study_tpu_torch.train.engine import Trainer
from torch_port_helpers import SMALL, small_cfg

ARGS = ["--conf", "configs/gen1_optimized.py", "--batch-size", "2", "--epochs", "1",
        "--img-size", "64", "--num-events", "512", "--device", "cpu", "--override", *SMALL]


@pytest.fixture(scope="module")
def gen1_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("gen1_variants")
    for i, split in enumerate(("training.h5", "validation.h5")):
        write_gen1_fixture(root / split, num_files=1, boxes_per_file=3, events_per_file=1500,
                           seed=21 + i)
    return root


@pytest.fixture(scope="module")
def plain_run(gen1_root, tmp_path_factory):
    out = tmp_path_factory.mktemp("plain")
    trainer = train_cli.main(["--data-path", str(gen1_root), "--output-dir", str(out), *ARGS])
    return trainer, out / "last_ckpt"


def _bn_state(model):
    return {k: v.clone() for k, v in model.state_dict().items()
            if "running" in k or "num_batches" in k}


def test_cli_fuse_ab(gen1_root, tmp_path):
    tr = train_cli.main(["--data-path", str(gen1_root), "--output-dir", str(tmp_path), "--fuse-ab",
                         *ARGS])
    assert tr.train_mode == "fuseab" and tr.state.step == len(tr.train_loader) > 0
    head = tr.model.head
    # the anchor-base loss reaches its pred convs (an epoch of 2-window
    # batches accumulates toward the nominal 64 and makes no update yet)
    assert head.na == 3 and head.cls_pred_ab_0.weight.grad.abs().sum() > 0
    assert (tmp_path / "last_ckpt").exists()


def test_cli_distill_with_teacher_checkpoint(gen1_root, plain_run, tmp_path, monkeypatch):
    _, ckpt = plain_run
    seen = {}
    real = Trainer.__init__

    def spy(self, *a, **kw):
        real(self, *a, **kw)
        seen["bn"] = _bn_state(self.teacher)

    monkeypatch.setattr(Trainer, "__init__", spy)
    tr = train_cli.main(["--data-path", str(gen1_root), "--output-dir", str(tmp_path),
                         "--distill", "--distill-feat", "--temperature", "5",
                         "--teacher-ckpt", str(ckpt), *ARGS])
    assert tr.train_mode == "distill" and not tr.distill_ns
    assert tr.state.step == len(tr.train_loader) > 0
    ema = checkpoint.load_checkpoint(ckpt)["ema"]["variables"]
    t_state = tr.teacher.state_dict()
    assert all(torch.equal(t_state[k], v) for k, v in ema.items())
    after = _bn_state(tr.teacher)
    assert all(torch.equal(after[k], v) for k, v in seen["bn"].items())


def test_distill_teacher_without_checkpoint(gen1_root, tmp_path):
    cfg = small_cfg()
    tr = Trainer(cfg, gen1_root, output_dir=tmp_path, distill=True, seed=3, batch_size=2,
                 epochs=1, img_size=64, num_events=512, device="cpu")
    fresh = init_weights_(build_model(cfg, 2, device="cpu"), torch.Generator().manual_seed(4))
    assert all(torch.equal(a, b) for a, b in zip(tr.teacher.state_dict().values(),
                                                 fresh.state_dict().values()))
    with pytest.raises(ValueError, match="mutually exclusive"):
        Trainer(cfg, gen1_root, output_dir=tmp_path, distill=True, fuse_ab=True, batch_size=2,
                epochs=1, img_size=64, num_events=512, device="cpu")


def test_cli_quant_calib(gen1_root, tmp_path):
    tr = train_cli.main(["--data-path", str(gen1_root), "--output-dir", str(tmp_path),
                         "--fuse-ab", "--quant", "--calib", *ARGS])
    assert tr.state.step == 0  # calibrated, not trained
    ptq = checkpoint.load_checkpoint(tmp_path / "ptq_ckpt")
    q = {k: v for k, v in ptq["quantized"].items() if isinstance(v, dict)}
    assert len(q) > 50 and all(v["q"].dtype == torch.int8 for v in q.values())
    assert "head.cls_pred_ab_0.weight" in q
    ranges = ptq["extra"]["activation_ranges"]
    assert set(ranges) == {"head_out"} and ranges["head_out"] > 0
    assert "AP" in ptq["extra"]["metrics"]


def test_learned_trainer_then_eval(gen1_root, tmp_path):
    learned = ["data.representation=LearnedRepresentation"]
    tr = train_cli.main(["--data-path", str(gen1_root), "--output-dir", str(tmp_path),
                         *ARGS, *learned])
    assert tr.learned and tr.aug_mode == "image" and tr.state.step == len(tr.train_loader)
    assert tr.model.quantization.value_layer.mlp_0.weight.grad is not None
    stats = eval_cli.main(["--data-path", str(gen1_root), "--checkpoint",
                           str(tmp_path / "last_ckpt"), "--batch-size", "2", "--img-size", "64",
                           "--num-events", "512", "--device", "cpu", "--override", *SMALL,
                           *learned])
    assert np.isfinite(stats["AP"])
    with pytest.raises(ValueError, match="raw events"):
        train_cli.main(["--data-path", str(gen1_root), "--output-dir", str(tmp_path),
                        "--augment", *ARGS, *learned])
