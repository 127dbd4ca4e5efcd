"""The metric arithmetic on synthetic inputs: interval unions and idle
gaps of a made-up trace, the least bytes of a segment reduction, FLOP
counts against hand counts, the readers, and the judges."""
import math

import pytest
import torch
from torch import nn

from port_bench import core, judge, readers, tracing, yardstick


def test_union_and_gaps():
    iv = [(0, 10), (5, 20), (30, 40), (35, 36), (50, 60)]
    assert tracing.union_us(iv, 0, 100) == 40
    assert tracing.union_us(iv, 8, 55) == 12 + 10 + 5
    assert tracing.idle_gaps(iv, 0, 70) == [(20, 30), (40, 50), (60, 70)]
    assert tracing.idle_gaps([], 0, 5) == [(0, 5)]


def test_reduce_events_labels_gaps_by_span():
    host = [("bench/window", 0.0, 1000.0, 0.0),
            ("bench/loader", 100.0, 300.0, 0.0),
            ("bench/k1", 400.0, 450.0, 30.0), ("bench/k1", 600.0, 650.0, 20.0)]
    device = [("gemm", 0.0, 100.0), ("k1_kernel", 420.0, 460.0), ("gemm", 300.0, 400.0),
              ("gemm", 700.0, 1000.0), ("outside", 1200.0, 1300.0)]
    s = tracing.reduce_events(host, device)
    assert s.window_s == pytest.approx(1e-3) and s.busy_s == pytest.approx(540e-6)
    assert s.device_s("k1") == pytest.approx(50e-6) and len(s.spans["k1"]) == 2
    assert s.host_s("loader") == pytest.approx(200e-6)
    assert s.device_ops[0] == ("gemm", pytest.approx(500e-6))
    gaps = dict(s.idle_gaps)
    # (100, 300) under loader; (400, 420) under k1; (460, 700) outside any span
    assert gaps["loader"] == pytest.approx(200e-6) and gaps["k1"] == pytest.approx(20e-6)
    assert gaps["host"] == pytest.approx(240e-6)


def test_segment_reduce_bytes_hand_count():
    seg = torch.tensor([[0, 1, 1, 5, 5], [2, 3, 5, 5, 5]], dtype=torch.int32)  # S 5: 5 pads
    vs, vm = torch.zeros(2, 18, 5), torch.zeros(2, 3, 5)
    n, rows, ks, km, s = yardstick.segment_reduce_args(seg, vs, vm, 5)
    assert (int(n), rows, ks, km, s) == (5, 2, 18, 3, 5)
    # 5 valid events x (id + 21 values) read, 2 x 5 x 21 outputs written, 4 bytes each
    assert yardstick.bytes_of_calls([(n, rows, ks, km, s)]) == 4 * (5 * 22 + 2 * 5 * 21)
    assert yardstick.segment_reduce_bytes(5, 2, 18, 0, 5) == 4 * (5 * 19 + 2 * 5 * 18)


def test_forward_flops_hand_count():
    with torch.device("meta"):
        conv = nn.Conv2d(12, 64, 3, padding=1)
        lin = nn.Linear(512, 100)
    # conv: 2 x (out positions) x Cout x Cin x k x k; linear: 2 x B x in x out
    assert yardstick.forward_flops(conv, (2, 12, 32, 32), train=False) == 2 * 2 * 32 * 32 * 64 * 12 * 9
    assert yardstick.forward_flops(lin, (8, 512), train=True) == 2 * 8 * 512 * 100


def test_precision_and_peaks(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    assert yardstick.precision_in_use() == "float32"
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert yardstick.precision_in_use() == "tf32"
    assert yardstick.PEAK_FLOPS == {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}


def _run(**extra):
    summary = tracing.reduce_events(
        [("bench/window", 0.0, 2e6, 0.0), ("bench/k1", 0.0, 1.0, 1e5)],
        [("kern", 0.0, 1.5e6)])
    return core.Run(window_s=2.0, trace=summary, extra=dict(extra))


def test_readers():
    r = _run(samples=80, steps=10, loader_wait_s=0.05, k1_bytes=3.35e12 * 0.05,
             flops_per_step=6.7e12, peak_flops=67e12)
    assert readers.per_second(r, "samples") == 40
    assert readers.per_call_ms(r, "loader_wait_s", "steps") == pytest.approx(5.0)
    assert readers.device_idle_pct(r) == pytest.approx(25.0)
    assert readers.roofline_pct(r, "k1", "k1_bytes") == pytest.approx(50.0)
    assert readers.mfu_pct(r, "flops_per_step", "steps") == pytest.approx(50.0)
    # nothing to read: no trace, no span, no device time
    assert readers.roofline_pct(core.Run(window_s=2.0), "k1", "k1_bytes") is None
    assert readers.roofline_pct(r, "nms", "k1_bytes") is None
    assert readers.device_idle_pct(core.Run(window_s=2.0)) is None


def test_leaf_gaps():
    want = {"a": 1.0, "b": 2.0, "c": 1e-9}
    got = {"a": 1.0, "b": 2.2, "c": 2e-9}
    gap, leaf = judge.worst_leaf_gap(got, want)
    assert leaf == "b" and gap == pytest.approx(0.1)
    # a tiny leaf is measured against the median leaf's norm
    assert judge.worst_leaf_gap({"a": 1.0, "b": 2.0, "c": 0.5}, want)[0] == pytest.approx(0.5)
    assert judge.moving_leaves({"a": 1.0, "b": 2.0, "c": 1e-9}) == ["a", "b"]
    assert judge.worst_leaf_gap({"a": 1.0}, want)[0] == math.inf
    assert judge.loss_gap([1.0, 2.0], [1.0, 2.002]) == pytest.approx(0.002 / 2.002)
    assert judge.loss_gap([float("nan")], [1.0]) == math.inf


def _det(x, score, cls=0.0, w=20.0):
    return [x, 10.0, x + w, 30.0, score, cls]


def test_detection_gaps():
    conf, iou, max_det = 0.03, 0.65, 300
    pairs = torch.tensor([_det(0, 0.9), _det(2, 0.8999999), _det(100, 0.5), _det(200, 0.4, 1),
                          _det(300, 0.0300001), _det(400, 0.01), _det(104, 0.45),
                          _det(500, 0.6), _det(507, 0.3)])
    # (500, 0.6) and (507, 0.3) overlap by 13/27 = 0.48: both are kept
    kept = torch.tensor([_det(0, 0.9), _det(500, 0.6), _det(100, 0.5), _det(200, 0.4, 1),
                         _det(507, 0.3), _det(300, 0.0300001)])
    assert judge.detection_gaps(kept, pairs, conf, iou, max_det) == (0.0, 0.0, 0.0)
    # a near-tie kept the other way round reads the score difference, its
    # cascade nothing more
    swap = kept.clone()
    swap[0] = torch.tensor(_det(2, 0.8999999))
    b, s, g = judge.detection_gaps(swap, pairs, conf, iou, max_det)
    assert b == 0.0 and s == 0.0 and 0 < g < 2e-7  # float32 rounds 0.9 - 0.8999999
    # a score that rounding moved below the threshold reads its distance from it
    assert max(judge.detection_gaps(kept[:5], pairs, conf, iou, max_det)) < 2e-7
    # a missing detection: the later ones read how far they lie below it, and
    # at the end it reads the lesser of its height above the threshold and
    # its largest overlap's distance below the IoU threshold
    assert judge.detection_gaps(kept[1:], pairs, conf, iou, max_det)[2] == pytest.approx(0.65)
    no_last = kept[:5]
    no_last_507 = torch.cat([kept[:4], kept[5:]])[:4]
    assert judge.detection_gaps(no_last, pairs, conf, iou, max_det)[2] < 2e-7
    assert judge.detection_gaps(no_last_507, pairs, conf, iou, max_det)[2] == pytest.approx(
        iou - 13 / 27, abs=1e-6)  # min(0.3 - 0.03, 0.65 - 13 / 27)
    # a duplicate, or a suppressed candidate kept, reads its overlap's excess
    dup = torch.cat([kept, kept[2:3]])
    assert judge.detection_gaps(dup, pairs, conf, iou, max_det)[2] == pytest.approx(1 - iou)
    suppressed = torch.cat([kept, torch.tensor([_det(104, 0.45)])])
    assert judge.detection_gaps(suppressed, pairs, conf, iou, max_det)[2] == pytest.approx(
        16 / 24 - iou, abs=1e-6)
    # an overlap that rounding moved across the IoU threshold: the port
    # suppressed a candidate that the reference keeps; it reads the overlap's
    # distance from the threshold, and nothing cascades into the later choices
    edge = torch.tensor([_det(600, 0.8), _det(607.2, 0.7), _det(700, 0.2)])
    # (600) and (607.2) overlap by 12.8 / 27.2 = 0.4706
    gap = judge.detection_gaps(edge[[0, 2]], edge, conf, 0.4707, max_det)[2]
    assert gap == pytest.approx(0.4707 - 12.8 / 27.2, abs=1e-6)
    # a moved box reads its move; an altered score its change
    moved = kept.clone()
    moved[2, 0] += 1.0
    assert judge.detection_gaps(moved, pairs, conf, iou, max_det) == (pytest.approx(1.0), 0.0, 0.0)
    rescored = kept.clone()
    rescored[3, 4] = 0.45
    assert judge.detection_gaps(rescored, pairs, conf, iou, max_det)[1] == pytest.approx(0.05)
