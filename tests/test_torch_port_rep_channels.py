"""The detector's input width follows the representation
(``reps/dispatch.py::REPRESENTATION_CHANNELS``, as the JAX package's Trainer
and CLIs take it): a Trainer takes a step and evaluates with the 2-channel
histogram (event mosaic) and the 12-channel voxel grid (``auto`` -> image
augmentation); ``cli/infer.py`` and ``cli/eval.py`` serve the histogram."""
import numpy as np
import pytest
import torch

from event_representation_study_tpu_torch.cli import eval as eval_cli
from event_representation_study_tpu_torch.cli import infer
from event_representation_study_tpu_torch.data.gen1 import write_gen1_fixture
from event_representation_study_tpu_torch.events import generate_fake_events
from event_representation_study_tpu_torch.train.engine import Trainer
from torch_port_helpers import SMALL, small_cfg

KW = dict(batch_size=2, img_size=64, num_events=512, device="cpu")


@pytest.fixture(scope="module")
def gen1_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("gen1_channels")
    for i, split in enumerate(("training.h5", "validation.h5")):
        write_gen1_fixture(root / split, num_files=1, boxes_per_file=2, events_per_file=1500,
                           seed=21 + i)
    return root


def _stem_channels(model) -> int:
    return next(m for m in model.modules() if isinstance(m, torch.nn.Conv2d)).in_channels


@pytest.mark.parametrize("rep,aug_mode,channels", [("EventHistogram", "event", 2),
                                                   ("VoxelGrid", "image", 12)])
def test_trainer_step_and_eval(gen1_root, tmp_path, rep, aug_mode, channels):
    cfg = small_cfg()
    cfg["data"]["representation"] = rep
    tr = Trainer(cfg, gen1_root, epochs=1, output_dir=tmp_path / "run", augment=True,
                 eval_interval=10, **KW)
    assert tr.aug_mode == aug_mode and _stem_channels(tr.model) == channels
    batch, _ = next(iter(tr.train_loader))
    state, parts = tr.train_step(tr.state, batch, 0)
    assert state.step == 1 and all(np.isfinite(float(v)) for v in parts.values())
    stats = tr.evaler.run(state.ema.variables)
    assert np.isfinite(stats["AP"])


def test_cli_serve_and_eval_histogram(gen1_root, tmp_path, capsys):
    ev = generate_fake_events(900, height=48, width=64, duration_us=100_000, seed=5)
    path = tmp_path / "ev.npz"
    np.savez(path, event_data=np.stack([ev["x"], ev["y"], ev["t"], ev["p"]], 1))
    out = infer.main(["--events", str(path), "--device", "cpu", "--img-size", "64",
                      "--num-events", "1024", "--representation", "EventHistogram",
                      "--override", *SMALL])
    assert f"{len(out)} detections" in capsys.readouterr().out
    stats = eval_cli.main(["--data-path", str(gen1_root), "--device", "cpu", "--img-size", "64",
                           "--num-events", "512", "--batch-size", "2",
                           "--representation", "EventHistogram", "--override", *SMALL])
    assert np.isfinite(stats["AP"])
