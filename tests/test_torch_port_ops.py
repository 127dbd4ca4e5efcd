"""The port's image, box, anchor and NMS ops against the JAX package's.

Letterbox: both resample bilinear with half-pixel centres; float32 sums in
another order give ~1e-5 relative error on values up to 255, so atol 1e-3.
Boxes, anchors and coordinate maps are exact up to float32 rounding (1e-5).
NMS must match box for box; its scores are tie-free, since ``lax.top_k``
breaks ties towards the lower index and ``torch.topk`` promises no order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event_representation_study_tpu.ops import boxes as jboxes
from event_representation_study_tpu.ops import image as jimage
from event_representation_study_tpu.ops.nms import non_max_suppression as jax_nms
from event_representation_study_tpu.train.anchors import generate_anchors_eval as jax_anchors
from event_representation_study_tpu_torch.ops import boxes, image
from event_representation_study_tpu_torch.ops.nms import non_max_suppression
from event_representation_study_tpu_torch.train.anchors import generate_anchors_eval
from torch_port_helpers import assert_close


@pytest.mark.parametrize("shape,new", [((240, 304), 640), ((16, 64), 128), ((50, 30), 64), ((37, 53), 96)])
def test_letterbox(shape, new):
    h, w = shape
    assert image.letterbox_geometry(h, w, new) == jimage.letterbox_geometry(h, w, new)
    img = np.random.default_rng(h * w).uniform(0, 255, size=(2, h, w, 3)).astype(np.float32)
    want = np.asarray(jimage.letterbox_image(jnp.asarray(img), new))
    got = image.letterbox_image(torch.from_numpy(img), new)
    assert got.shape == want.shape == (2, new, new, 3)
    assert_close("letterbox", got, want, atol=1e-3)
    # unbatched input, and the pad value lands where the reference puts it
    np.testing.assert_array_equal(image.letterbox_image(torch.from_numpy(img[0]), new).numpy(),
                                  got[0].numpy())
    assert (want == 114.0).sum() == (got.numpy() == 114.0).sum()


def test_scale_coords_back():
    c = np.random.default_rng(0).uniform(-20, 660, size=(50, 4)).astype(np.float32)
    want = jimage.scale_coords_back(c, 640, 240, 304)
    got = image.scale_coords_back(torch.from_numpy(c), 640, 240, 304).numpy()
    assert_close("scale_coords_back", got, want, rtol=1e-6, atol=1e-4)


def test_boxes():
    rng = np.random.default_rng(1)
    xywh = np.concatenate([rng.uniform(0, 100, (30, 2)), rng.uniform(1, 40, (30, 2))], 1).astype(np.float32)
    assert_close("xywh2xyxy", boxes.xywh2xyxy(torch.from_numpy(xywh)),
                 jboxes.xywh2xyxy(xywh), rtol=1e-7, atol=1e-5)
    dist = rng.uniform(0, 16, (2, 30, 4)).astype(np.float32)
    pts = rng.uniform(0, 80, (30, 2)).astype(np.float32)
    for fmt in ("xyxy", "xywh"):
        assert_close(f"dist2bbox {fmt}",
                     boxes.dist2bbox(torch.from_numpy(dist), torch.from_numpy(pts)[None], fmt),
                     jboxes.dist2bbox(dist, pts[None], fmt), rtol=1e-7, atol=1e-5)
    a = np.array(jboxes.xywh2xyxy(xywh))
    assert_close("box_iou_pairwise",
                 boxes.box_iou_pairwise(torch.from_numpy(a), torch.from_numpy(a[:7])),
                 jboxes.box_iou_pairwise(a, a[:7]), rtol=1e-7, atol=1e-6)


def test_anchors_eval():
    shapes, strides = [(10, 12), (5, 6), (3, 3), (2, 2)], (8, 16, 32, 64)
    pts, st = generate_anchors_eval(shapes, strides)
    jp, js = jax_anchors(shapes, strides, 0.5)
    assert_close("anchor points", pts, jp, atol=0)
    assert_close("strides", st, js, atol=0)


def _predictions(B, A, nc, seed):
    """Clustered boxes (so suppression happens) and tie-free scores."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(20, 600, size=(B, 12, 2))
    pick = rng.integers(0, 12, size=(B, A))
    cxy = np.take_along_axis(centres, pick[..., None], 1) + rng.normal(0, 6, (B, A, 2))
    wh = rng.uniform(20, 80, size=(B, A, 2))
    obj = np.ones((B, A, 1))
    cls = rng.permutation(B * A * nc).reshape(B, A, nc) / (B * A * nc)
    return np.concatenate([cxy, wh, obj, cls], -1).astype(np.float32)


NMS_CASES = [(0.03, 1500), (0.5, 1500), (0.9, 600), (0.99, 600)]


@pytest.mark.parametrize("conf,anchors", NMS_CASES)
def test_nms_box_for_box(conf, anchors):
    """1500 anchors x 2 classes overfill the top-2048 candidate set; at
    conf 0.99 fewer than 300 survive."""
    pred = _predictions(2, anchors, 2, seed=int(conf * 100) + anchors)
    want_d, want_n = jax_nms(jnp.asarray(pred), conf_thres=conf)
    got_d, got_n = non_max_suppression(torch.from_numpy(pred), conf_thres=conf)
    assert got_d.shape == (2, 300, 6)
    assert_close("counts", got_n, want_n, atol=0)
    assert got_n.min() > 0
    assert_close("detections", got_d, want_d, atol=1e-5)
