"""The serving slice end to end: fake event windows through the JAX serve
path (``batched_representation`` + ``letterbox_image`` + ``model.apply`` +
``non_max_suppression``, as ``cli/infer.py`` composes them) and through the
port's ``make_server(device="cpu")`` with the same converted weights
(``torch_port_helpers.serve_pair``).

Tolerances: the representation is x255, so its 2e-4 float32 budget becomes
0.06 absolute; predictions as in test_torch_port_detector.py (boxes 1e-3 px,
scores 1e-4); detections box for box at the same bounds, classes and counts
exactly.
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
from event_representation_study_tpu_torch.ops.image import scale_coords_back
from event_representation_study_tpu_torch.ops.nms import non_max_suppression
from torch_port_helpers import SERVE, assert_close, serve_pair


@pytest.fixture(scope="module")
def served():
    return serve_pair()


def test_representation(served):
    got, want, _ = served
    assert got[0].shape == (2, SERVE["H"], SERVE["W"], 12)
    assert_close("representation", got[0], want[0], atol=0.06)


def test_predictions(served):
    got, want, _ = served
    assert got[1].shape == want[1].shape == (2, 16**2 + 8**2 + 4**2 + 2**2, 7)
    assert_close("boxes px", got[1][..., :4], want[1][..., :4], atol=1e-3)
    assert_close("scores", got[1][..., 4:], want[1][..., 4:], atol=1e-4)


@pytest.mark.parametrize("preds", ["own", "jax"])
def test_detections(served, preds):
    """Box for box: the port's NMS on its own predictions, and on the JAX
    predictions (which isolates NMS from the model's float32 noise)."""
    got, want, _ = served
    if preds == "own":
        dets, n = got[2], got[3]
    else:
        dets, n = (a.numpy() for a in non_max_suppression(torch.tensor(want[1]),
                                                          conf_thres=SERVE["CONF"]))
    assert_close("counts", n, want[3], atol=0)
    assert n.min() > 0
    assert_close("boxes px", dets[..., :4], want[2][..., :4], atol=1e-3)
    assert_close("scores", dets[..., 4], want[2][..., 4], atol=1e-4)
    assert_close("classes", dets[..., 5], want[2][..., 5], atol=0)


def test_serve_call_and_cli(served, tmp_path, capsys):
    """``serve(blocks)`` returns (dets, n) on the CPU; the CLI serves an
    event file, with seeded weights or a checkpoint's."""
    _, _, server = served
    H, W = SERVE["H"], SERVE["W"]
    ev = generate_fake_events(1800, height=H, width=W, duration_us=200_000, seed=21)
    dets, n = server(stack_blocks([from_structured(ev, SERVE["CAP"])]))
    assert dets.shape == (1, 300, 6) and n.shape == (1,)
    path = tmp_path / "ev.npz"
    np.savez(path, event_data=np.stack([ev["x"], ev["y"], ev["t"], ev["p"]], 1))
    small = ["--override", "model.depth_multiple=0.2", "model.width_multiple=0.125"]
    out = infer.main(["--events", str(path), "--device", "cpu", "--img-size",
                      str(SERVE["IMG"]), "--conf-thres", str(SERVE["CONF"]), *small])
    assert f"{len(out)} detections" in capsys.readouterr().out
    # a stripped checkpoint of the served weights: the CLI serves what the
    # server does, un-letterboxed to the sensor frame
    assert (int(ev["y"].max()) + 1, int(ev["x"].max()) + 1) == (H, W)
    ckpt = tmp_path / "deploy"
    torch.save({"variables": {k: v for k, v in server.model.state_dict().items()
                              if v.is_floating_point()}}, ckpt)
    got = infer.main(["--events", str(path), "--device", "cpu", "--img-size", str(SERVE["IMG"]),
                      "--conf-thres", str(SERVE["CONF"]), "--num-events", str(SERVE["CAP"]),
                      "--checkpoint", str(ckpt), *small])
    want = dets[0, : int(n[0])].clone()
    want[:, :4] = scale_coords_back(want[:, :4], SERVE["IMG"], H, W)
    assert_close("CLI with the served checkpoint", got, want.numpy(), atol=0)
    assert len(got) > 0
