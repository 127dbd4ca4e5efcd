"""The pixel path of the port's ``cli/infer.py`` (``--source`` an image, a
video or a directory; ``--save-dir``, ``--max-frames``), its
``data/demo_data.py`` and ``--save-img`` on the event path, against the
JAX package's CLI on the same files and the same converted weights (a
JAX-side checkpoint loader patched to hand the JAX CLI the variables that
the port reads from a stripped checkpoint).

The frames are square noise, so the letterbox adds no padding band and no
two anchors tie (uniform regions tie scores exactly, and no two frameworks
promise the same order of ties).

Tolerances: ``LoadData`` frames exactly; detections per frame equal in
count and class, boxes within 1e-3 px of the original frame, scores 1e-4.
"""
import numpy as np
import pytest
import torch

import cv2
from event_representation_study_tpu.cli import infer as jax_infer
from event_representation_study_tpu.data import demo_data as jax_demo
from event_representation_study_tpu.models import build_model as jax_build_model
from event_representation_study_tpu.train import checkpoint as jax_checkpoint
from event_representation_study_tpu.utils import viz as jax_viz
from event_representation_study_tpu_torch.cli import infer
from event_representation_study_tpu_torch.data import demo_data
from event_representation_study_tpu_torch.events import generate_fake_events
from event_representation_study_tpu_torch.utils.convert import flax_to_torch
from torch_port_helpers import (
    SMALL,
    assert_close,
    random_jax_variables,
    small_cfg,
)

IMG, CONF = 128, 0.3
ARGS = ["--img-size", str(IMG), "--conf-thres", str(CONF), "--override", *SMALL]


def _write_image(path, side, seed):
    assert cv2.imwrite(str(path), np.random.default_rng(seed).integers(0, 255, (side, side, 3),
                                                                       np.uint8))
    return path


def _write_video(path, frames=3, side=64):
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 5.0, (side, side))
    assert vw.isOpened(), "no MJPG writer in this OpenCV build"
    rng = np.random.default_rng(1)
    for _ in range(frames):
        vw.write(rng.integers(0, 255, (side, side, 3), np.uint8))
    vw.release()
    return path


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    root = tmp_path_factory.mktemp("demo")
    return {"image": _write_image(root / "a.png", 96, 3), "video": _write_video(root / "v.avi"),
            "dir": root}


def test_source_type_like_jax(sources, tmp_path):
    for path in (sources["image"], sources["video"], sources["dir"], "x.h5", "x.dat", "x.bag"):
        assert demo_data.source_type(path) == jax_demo.source_type(path)
    with pytest.raises(ValueError):
        demo_data.source_type("x.xyz")
    with pytest.raises(FileNotFoundError):
        demo_data.LoadData(tmp_path)


@pytest.mark.parametrize("kind", ["image", "video", "dir"])
def test_load_data_frames_equal_jax(sources, kind):
    got, want = (list(mod.LoadData(sources[kind])) for mod in (demo_data, jax_demo))
    assert len(got) == len(want) == {"image": 1, "video": 3, "dir": 4}[kind]
    for (f, p, i), (fw, pw, iw) in zip(got, want):
        assert (p, i) == (pw, iw) and f.dtype == np.uint8 and f.shape[-1] == 3
        assert_close(f"{kind} frame {i}", f, fw, atol=0)


@pytest.fixture(scope="module")
def served(sources, tmp_path_factory, monkeypatch_module):
    """Both CLIs on the image and on 2 frames of the video, from the same
    random 3-channel weights."""
    tmp = tmp_path_factory.mktemp("served")
    variables = random_jax_variables(jax_build_model(small_cfg(), num_classes=2), IMG,
                                     channels=3, seed=2)
    ckpt = tmp / "rgb_ckpt"
    torch.save({"variables": flax_to_torch(variables)}, ckpt)
    monkeypatch_module.setattr(jax_checkpoint, "load_checkpoint",
                               lambda path: {"state": {"ema": {"variables": variables}}})
    out = {}
    for kind, extra in (("image", []), ("video", ["--max-frames", "2"])):
        src = ["--source", str(sources[kind]), *extra]
        out[kind] = (
            infer.main([*src, "--checkpoint", str(ckpt), "--device", "cpu", "--save-dir",
                        str(tmp / "port"), *ARGS]),
            jax_infer.main([*src, "--checkpoint", str(ckpt), "--save-dir", str(tmp / "jax"),
                            *ARGS]))
    return out, tmp


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.mark.parametrize("kind", ["image", "video"])
def test_pixel_detections_like_jax(served, kind):
    got, want = served[0][kind]
    assert len(got) == len(want) == (1 if kind == "image" else 2)
    for (p, i, d), (pw, iw, dw) in zip(got, want):
        assert (p, i) == (pw, iw)
        assert len(d) == len(dw) > 0
        assert_close(f"{kind}[{i}] boxes px", d[:, :4], dw[:, :4], atol=1e-3)
        assert_close(f"{kind}[{i}] scores", d[:, 4], dw[:, 4], atol=1e-4)
        assert_close(f"{kind}[{i}] classes", d[:, 5], dw[:, 5], atol=0)
        side = 96 if kind == "image" else 64
        assert d[:, :4].min() >= 0 and d[:, :4].max() <= side  # the original frame


def test_save_dir_frames(served):
    tmp = served[1]
    names = sorted(p.name for p in (tmp / "port").iterdir())
    assert names == sorted(p.name for p in (tmp / "jax").iterdir())
    assert names == ["a_00000.png", "v_00000.png", "v_00001.png"]
    for name in names:
        assert cv2.imread(str(tmp / "port" / name)).shape[:2] in ((96, 96), (64, 64))


def test_event_checkpoint_refused_on_frames(sources, tmp_path):
    """A checkpoint with a 12-channel stem stops before the first frame,
    with the JAX CLI's message."""
    from event_representation_study_tpu_torch.models import build_model

    ckpt = tmp_path / "ev_ckpt"
    model = build_model(small_cfg(), 2, device="cpu")
    torch.save({"variables": model.state_dict()}, ckpt)
    with pytest.raises(SystemExit, match="12-channel event representations"):
        infer.main(["--source", str(sources["image"]), "--checkpoint", str(ckpt),
                    "--device", "cpu", *ARGS])


def test_save_img_on_events(tmp_path, capsys):
    """``--save-img`` on an event file: the events' binary histogram with
    the detections' boxes (the seeded weights' scores sit near the class
    prior, hence the low threshold), as the JAX functions draw them."""
    from PIL import Image

    ev = generate_fake_events(3000, 64, 64, 200_000, seed=21)
    path = tmp_path / "ev.npz"
    np.savez(path, event_data=np.stack([ev["x"], ev["y"], ev["t"], ev["p"]], 1))
    dets = infer.main(["--events", str(path), "--device", "cpu", "--save-img",
                       str(tmp_path / "ev.png"), *ARGS, "--conf-thres", "0.001"])
    assert "saved" in capsys.readouterr().out and len(dets) > 0
    want = jax_viz.draw_boxes(jax_viz.make_binary_histo(ev, 64, 64), dets[:, :4])
    assert_close("--save-img", np.asarray(Image.open(tmp_path / "ev.png")), want, atol=0)
