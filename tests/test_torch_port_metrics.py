"""The port's host metrics (``metrics/coco.py::CocoEvaluator``,
``metrics/det_metrics.py::PRMetric``) against the JAX package's on the same
random detections and ground truth: images without detections, without
ground truth and without either, and boxes in every COCO area range. Both
are NumPy on the host, so the summaries must be equal."""
import numpy as np
import pytest

from event_representation_study_tpu.metrics import coco as jax_coco
from event_representation_study_tpu.metrics import det_metrics as jax_det
from event_representation_study_tpu_torch.metrics import coco, det_metrics
from torch_port_helpers import assert_close


def _images(seed, n=12, nc=2):
    """Per image (dets (D, 6), gts (G, 5)): GT boxes of side 10-150 px (small,
    medium and large), detections jittered around them plus false ones."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        g = int(rng.integers(0, 7)) if i % 4 else 0  # every 4th image: no GT
        xy = rng.uniform(0, 200, (g, 2))
        wh = rng.choice([12.0, 50.0, 140.0], (g, 1)) * rng.uniform(0.8, 1.2, (g, 2))
        gts = np.concatenate([rng.integers(0, nc, (g, 1)), xy, xy + wh], 1)
        if i % 5 == 3:
            out.append((np.zeros((0, 6)), gts))  # no detections
            continue
        hit = gts[rng.random(g) < 0.7]
        jitter = rng.normal(0, 4, (len(hit), 4))
        fp_xy = rng.uniform(0, 250, (int(rng.integers(0, 5)), 2))
        fp = np.concatenate([fp_xy, fp_xy + rng.uniform(8, 120, (len(fp_xy), 2))], 1)
        boxes = np.concatenate([hit[:, 1:] + jitter, fp])
        cls = np.concatenate([np.where(rng.random(len(hit)) < 0.9, hit[:, 0], 1 - hit[:, 0]),
                              rng.integers(0, nc, len(fp))])
        scores = rng.permutation(len(boxes)) / max(len(boxes), 1) * 0.9 + 0.05
        out.append((np.concatenate([boxes, scores[:, None], cls[:, None]], 1), gts))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coco_evaluator_like_jax(seed):
    got, want = coco.CocoEvaluator(2), jax_coco.CocoEvaluator(2)
    for dets, gts in _images(seed):
        got.add_image(dets, gts)
        want.add_image(dets, gts)
    g, w = got.summarize(), want.summarize()
    assert list(g) == list(w)
    assert_close("COCO summary", [g[k] for k in w], [w[k] for k in w], atol=0)
    assert w["AP"] > 0 and w["AP_small"] >= 0 and w["AP_medium"] >= 0 and w["AP_large"] >= 0


def test_coco_evaluator_without_ground_truth():
    got, want = coco.CocoEvaluator(2), jax_coco.CocoEvaluator(2)
    dets = np.array([[0, 0, 10, 10, 0.9, 1.0]])
    for ev in (got, want):
        ev.add_image(dets, np.zeros((0, 5)))
    assert got.summarize() == want.summarize()
    assert got.summarize()["AP"] == -1.0


@pytest.mark.parametrize("seed", [0, 3])
def test_pr_metric_like_jax(seed):
    got, want = det_metrics.PRMetric(2), jax_det.PRMetric(2)
    for dets, gts in _images(seed):
        got.add_image(dets, gts)
        want.add_image(dets, gts)
    g, w = got.summarize(), want.summarize()
    assert sorted(g) == sorted(w)
    assert g["per_class_ap50"] == w["per_class_ap50"]
    assert_close("PR confusion matrix", g["confusion_matrix"], w["confusion_matrix"], atol=0)
    keys = [k for k in w if k not in ("per_class_ap50", "confusion_matrix")]
    assert_close("PR summary", [g[k] for k in keys], [w[k] for k in keys], atol=0)
    assert w["mAP50_pr"] > 0


def test_ap_per_class_like_jax():
    rng = np.random.default_rng(5)
    tp = rng.random((200, 10)) < 0.5
    conf, pcls, tcls = rng.random(200), rng.integers(0, 3, 200), rng.integers(0, 3, 150)
    for g, w in zip(det_metrics.ap_per_class(tp, conf, pcls, tcls),
                    jax_det.ap_per_class(tp, conf, pcls, tcls)):
        assert_close("ap_per_class", g, w, atol=0)
