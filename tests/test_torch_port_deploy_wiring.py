"""The port's deploy path on the CPU:

- ``models/backend.py::DetectBackend`` on a train checkpoint (its EMA
  weights) and on a stripped deploy checkpoint: ``__call__`` equal to the
  detector's eval forward on those weights, ``detect`` equal to NMS of it,
  ``max_det`` keeping the first picks;
- ``utils/export.py``: the serving graph (ERGO-12 -> letterbox -> shrunk
  detector -> NMS) exported with ``torch.export``, saved, loaded and run
  equals the eager ``make_server`` on the same weights; the graph holds
  K1 as the one ``ers::segment_reduce_sorted`` node. NMS is cut to 20
  greedy steps here (``ops.nms.MAX_DET``, in both) to keep the unrolled
  graph's trace short; the card runs it at 300 (``chip_smoke.py``);
- the operator's fake version: the (B, S, Ks) and (B, S, Km) shapes, and
  (B, S, 0) without max columns.
"""
import numpy as np
import pytest
import torch

from event_representation_study_tpu_torch.cli import infer
from event_representation_study_tpu_torch.events import (
    from_structured,
    generate_fake_events,
    stack_blocks,
)
from event_representation_study_tpu_torch.models import build_model
from event_representation_study_tpu_torch.models.backend import DetectBackend
from event_representation_study_tpu_torch.ops import fused_scatter, nms
from event_representation_study_tpu_torch.parallel.train_step import TrainState
from event_representation_study_tpu_torch.train import checkpoint
from event_representation_study_tpu_torch.train.ema import ema_init
from event_representation_study_tpu_torch.train.optim import SolverConfig, build_optimizer
from event_representation_study_tpu_torch.utils import export
from torch_port_helpers import CFG_PATH, SMALL, SERVE, small_cfg


def _randomized(model, seed):
    """Random pred convs, so that scores vary and NMS has work."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.head.named_parameters():
            if "_pred_" in name:
                p.normal_(0.0, 0.3, generator=g)
    return model


@pytest.mark.parametrize("layout", ["train", "deploy"])
def test_detect_backend(layout, tmp_path):
    cfg = small_cfg()
    model = _randomized(
        build_model(cfg, 2, device="cpu", generator=torch.Generator().manual_seed(1)), 2)
    ema_model = _randomized(build_model(cfg, 2, device="cpu",
                                        generator=torch.Generator().manual_seed(3)), 4)
    ema = ema_init(model)
    with torch.no_grad():
        for k, v in ema_model.state_dict().items():
            if k in ema.variables:
                ema.variables[k].copy_(v)
    checkpoint.save_checkpoint(tmp_path / "train", TrainState(
        model, build_optimizer(model, SolverConfig()), ema, 0), epoch=0)
    path = tmp_path / "train"
    if layout == "deploy":
        checkpoint.strip_optimizer(path, tmp_path / "deploy")
        path = tmp_path / "deploy"
    backend = DetectBackend(path, CFG_PATH, overrides=SMALL, device="cpu")
    x = np.random.default_rng(0).uniform(0, 1, (2, 128, 128, 12)).astype(np.float32)
    with torch.no_grad():
        want = ema_model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    got = backend(x)
    assert torch.equal(got, want)  # the EMA weights, not the live ones
    dets, counts = backend.detect(x, conf_thres=0.05)
    want_dets, want_counts = nms.non_max_suppression(want, conf_thres=0.05)
    assert counts.min() > 0 and dets.shape == (2, nms.MAX_DET, 6)
    np.testing.assert_array_equal(dets, want_dets.numpy())
    np.testing.assert_array_equal(counts, want_counts.numpy())
    dets5, counts5 = backend.detect(x, conf_thres=0.05, max_det=5)
    np.testing.assert_array_equal(dets5, dets[:, :5])
    np.testing.assert_array_equal(counts5, np.minimum(counts, 5))


def test_export_round_trip(tmp_path, monkeypatch):
    monkeypatch.setattr(nms, "MAX_DET", 20)
    c = SERVE
    server = infer.make_server(small_cfg(), c["REP"], c["H"], c["W"], c["IMG"], 0.05,
                               device="cpu")
    _randomized(server.model, 5)
    evs = [generate_fake_events(n, height=c["H"], width=c["W"], duration_us=200_000, seed=s)
           for n, s in [(1800, 21), (3000, 22)]]
    blocks = stack_blocks([from_structured(e, c["CAP"]) for e in evs])
    program = export.export_serving_graph(export.build_serving_fn(server), blocks,
                                          tmp_path / "serve.pt2")
    ops = [n.target for n in program.graph.nodes if n.op == "call_function"]
    assert ops.count(torch.ops.ers.segment_reduce_sorted.default) == 1
    loaded = export.load_serving_graph(tmp_path / "serve.pt2")
    b = blocks.as_int32()
    with torch.no_grad():
        dets, counts = loaded(b.x, b.y, b.t, b.p, b.num)
        want_dets, want_counts = server(blocks)
    assert int(want_counts.min()) > 0 and dets.shape == (2, 20, 6)
    assert torch.equal(counts, want_counts)
    np.testing.assert_allclose(dets.numpy(), want_dets.numpy(), atol=1e-5)


def test_segment_reduce_fake_shapes():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        seg = torch.empty((3, 100), dtype=torch.int32)
        vs, vm = torch.empty((3, 18, 100)), torch.empty((3, 3, 100))
        sums, maxes = torch.ops.ers.segment_reduce_sorted(seg, vs, vm, 77)
        assert sums.shape == (3, 77, 18) and maxes.shape == (3, 77, 3)
        sums, maxes = torch.ops.ers.segment_reduce_sorted(seg, vs, None, 77)
        assert sums.shape == (3, 77, 18) and maxes.shape == (3, 77, 0)
    assert fused_scatter.LAUNCHES[fused_scatter.K1] == 0
