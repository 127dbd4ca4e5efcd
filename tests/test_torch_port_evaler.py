"""The port's ``train/evaler.py::Evaler`` against the JAX package's on the
same Gen1 fixture and converted random weights (the shrunk paper config,
depth 0.2 and width 0.125, at 128 px): the same number of detections per
image after NMS, and COCO AP and AP50 within 1e-4.

The sensor is square (64x64) so that the letterbox adds no padding band,
and every weight is random (pred convs included), so that no two anchors
tie exactly: a uniform input region gives its anchors equal scores, and no
two frameworks promise the same order of ties."""
import numpy as np
import pytest

from event_representation_study_tpu.data import gen1 as jax_gen1
from event_representation_study_tpu.data.loader import EventBatchLoader as JaxLoader
from event_representation_study_tpu.models import build_model as jax_build_model
from event_representation_study_tpu.train.evaler import Evaler as JaxEvaler
from event_representation_study_tpu_torch.data import gen1
from event_representation_study_tpu_torch.data.loader import EventBatchLoader
from event_representation_study_tpu_torch.models import build_model
from event_representation_study_tpu_torch.train import evaler
from event_representation_study_tpu_torch.utils.convert import flax_to_torch
from torch_port_helpers import assert_close, random_jax_variables, small_cfg

IMG, NE, CONF = 128, 4096, 0.3


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("gen1_eval")
    gen1.write_gen1_fixture(root / "validation.h5", num_files=2, boxes_per_file=6,
                            events_per_file=24_000, height=64, width=64, seed=8,
                            box_w=(36.0, 60.0), box_h=(36.0, 60.0))
    cfg = small_cfg()
    jax_model = jax_build_model(cfg, num_classes=2)
    variables = random_jax_variables(jax_model, IMG, seed=4)
    model = build_model(cfg, 2, device="cpu")
    model.load_state_dict(flax_to_torch(variables), strict=True)

    jax_ev = JaxEvaler(jax_model, JaxLoader(jax_gen1.Gen1H5(root, "val", num_events=NE), 4,
                                            img_size=IMG, shuffle=False, drop_last=False),
                       2, "OptimizedRepresentation", IMG, conf_thres=CONF)
    jax_counts = []
    jax_nms = jax_ev._nms

    def jax_spy(preds):
        dets, n = jax_nms(preds)
        jax_counts.extend(np.asarray(n).tolist())
        return dets, n

    jax_ev._nms = jax_spy
    want = jax_ev.run(variables, do_pr_metric=True)

    port_ev = evaler.Evaler(model, EventBatchLoader(gen1.Gen1H5(root, "val", num_events=NE), 4,
                                                    img_size=IMG, shuffle=False, drop_last=False),
                            2, "OptimizedRepresentation", IMG, conf_thres=CONF, device="cpu")
    counts = []
    real = evaler.non_max_suppression

    def spy(preds, **kw):
        dets, n = real(preds, **kw)
        counts.extend(n.tolist())
        return dets, n

    evaler.non_max_suppression = spy
    try:
        got = port_ev.run(None, do_pr_metric=True, predictions_json=root / "preds.json",
                          plot_dir=root)
    finally:
        evaler.non_max_suppression = real
    return got, want, counts, jax_counts, root


def test_detections_per_image(runs):
    got, want, counts, jax_counts, _ = runs
    assert len(counts) == len(jax_counts) == 12
    assert_close("detections per image", counts, jax_counts, atol=0)
    assert sum(counts) > 12


@pytest.mark.parametrize("key", ["AP", "AP50", "mAP50_pr"])
def test_ap_like_jax(runs, key):
    got, want, *_ = runs
    assert_close(f"Evaler {key}", got[key], want[key], atol=1e-4)
    assert want[key] > 0


def test_speed_slots_and_predictions(runs):
    got, _, counts, _, root = runs
    for k in ("speed_pre_ms", "speed_infer_nms_ms", "speed_post_ms"):
        assert np.isfinite(got[k]) and got[k] >= 0
    import json

    records = json.loads((root / "preds.json").read_text())
    assert len(records) == sum(counts)
    assert {r["image_id"] for r in records} <= set(range(12))


def test_plots_are_not_ported(runs):
    """(Named when the plots were refused.) ``plot_dir`` writes the first
    batch's validation mosaic and leaves the metrics as they are."""
    root = runs[-1]
    assert (root / "val_pred.png").stat().st_size > 1000
