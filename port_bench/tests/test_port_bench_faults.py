"""A whole run of each cell on the CPU at a shrunk size (``shrunk.py``),
past the harness's look for a card: sound, it is correct; with the timed
path broken underneath in each way the cell can break, ``correct`` comes
out false. The faults are planted in the port for the run only."""
import torch
import pytest

from port_bench import run as harness
from port_bench.tests.shrunk import shrunk_root

SEED = 2 ** 31 + 4242


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(4)
    return shrunk_root(tmp_path_factory.mktemp("bench"))


def _run(root, cell):
    run, result = harness.execute(cell, SEED, 1.0, False, device=torch.device("cpu"),
                                  root=root)
    assert list(result)[-1] == "checks" and result["attempted"] > 0
    return result


def _state_unchanged(mp):
    from event_representation_study_tpu_torch.train import optim

    mp.setattr(optim.FusedSGD, "update", lambda self, grads: None)
    mp.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _half_batch_detector(mp):
    from event_representation_study_tpu_torch.parallel import train_step as ts

    real = ts.detection_loss

    def half(outputs, gt_labels, gt_bboxes, gt_mask, *args, **kwargs):
        h = gt_labels.shape[0] // 2
        feats, cls, reg = outputs
        return real(([f[:h] for f in feats], cls[:h], reg[:h]), gt_labels[:h],
                    gt_bboxes[:h], gt_mask[:h], *args, **kwargs)

    mp.setattr(ts, "detection_loss", half)


def _half_batch_classifier(mp):
    import types

    import torch.nn.functional as F

    from event_representation_study_tpu_torch.train import classifier

    def half(logits, labels):
        h = labels.shape[0] // 2
        return F.cross_entropy(logits[:h], labels[:h])

    mp.setattr(classifier, "F", types.SimpleNamespace(cross_entropy=half))


def _ema_blend_skipped(mp):
    """The third checked step's EMA blend left out."""
    from event_representation_study_tpu_torch.parallel import train_step as ts

    real, calls = ts.ema_update, []

    def skip_third(state, model, *args, **kwargs):
        calls.append(None)
        return state if len(calls) == 3 else real(state, model, *args, **kwargs)

    mp.setattr(ts, "ema_update", skip_third)


def _batch_stats_frozen(mp):
    """The detector's BatchNorm normalises by the batch but keeps its
    running statistics."""
    import torch.nn.functional as F

    from event_representation_study_tpu_torch.models import layers

    real = layers.BatchNorm2d.forward

    def frozen(self, x):
        if not self.training:
            return real(self, x)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)

    mp.setattr(layers.BatchNorm2d, "forward", frozen)


def _altered_answer(mp):
    from event_representation_study_tpu_torch.cli import infer

    real = infer.non_max_suppression

    def rescored(*args, **kwargs):
        dets, n = real(*args, **kwargs)
        return dets - torch.tensor([0.0, 0.0, 0.0, 0.0, 0.1, 0.0]), n

    mp.setattr(infer, "non_max_suppression", rescored)


@pytest.mark.parametrize("cell", ["gen1_optimized.train", "nimagenet_resnet34.train",
                                  "gen1_optimized.serve"])
def test_sound_run_is_correct(root, cell):
    result = _run(root, cell)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and "setup_s" in result["metrics"]


@pytest.mark.parametrize("cell,fault", [
    ("gen1_optimized.train", _state_unchanged),
    ("gen1_optimized.train", _half_batch_detector),
    ("gen1_optimized.train", _ema_blend_skipped),
    ("gen1_optimized.train", _batch_stats_frozen),
    ("nimagenet_resnet34.train", _state_unchanged),
    ("nimagenet_resnet34.train", _half_batch_classifier),
    ("gen1_optimized.serve", _altered_answer),
])
def test_fault_is_caught(root, cell, fault, monkeypatch):
    fault(monkeypatch)
    result = _run(root, cell)
    assert not result["correct"], result["checks"]
