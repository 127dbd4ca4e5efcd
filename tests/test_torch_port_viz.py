"""The port's ``utils/viz.py`` against the JAX package's: the NumPy drawing
functions exactly on the same inputs, and every plot written as a
non-trivial PNG here, where matplotlib is installed; without matplotlib a
plot raises ``ImportError`` naming it (a subprocess with
``sys.modules["matplotlib"] = None``), and the module still imports."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from event_representation_study_tpu.events import generate_fake_events as jax_fake_events
from event_representation_study_tpu.utils import viz as jax_viz
from event_representation_study_tpu_torch.events import generate_fake_events
from event_representation_study_tpu_torch.utils import viz
from torch_port_helpers import assert_close

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_make_binary_histo_equals_jax():
    ev = generate_fake_events(3000, 48, 64, 200_000, seed=3)
    ev_j = jax_fake_events(3000, 48, 64, 200_000, seed=3)
    got, want = viz.make_binary_histo(ev, 48, 64), jax_viz.make_binary_histo(ev_j, 48, 64)
    assert got.dtype == np.uint8 and got.shape == (48, 64, 3)
    assert_close("make_binary_histo", got, want, atol=0)
    assert {0, 127, 255} <= set(np.unique(got).tolist())
    assert_close("make_binary_histo empty", viz.make_binary_histo(ev[:0], 4, 5),
                 jax_viz.make_binary_histo(ev_j[:0], 4, 5), atol=0)


@pytest.mark.parametrize("color", [(0, 255, 0), (255, 0, 0)])
def test_draw_boxes_equals_jax(color):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, (40, 50, 3), np.uint8)
    boxes = np.array([[3.2, 4.9, 20.1, 30.0], [-5, -5, 70, 60], [10, 10, 10.5, 39.9],
                      [45, 2, 49.9, 38]], np.float32)
    before = img.copy()
    got = viz.draw_boxes(img, boxes, color=color)
    assert_close("draw_boxes", got, jax_viz.draw_boxes(img, boxes, color=color), atol=0)
    assert (got != img).any() and (img == before).all()  # a copy is drawn on
    assert_close("draw_boxes none", viz.draw_boxes(img, np.zeros((0, 4))), img, atol=0)


def _plots(tmp, mod, fake_events):
    """Every plot of ``mod`` on the same inputs; returns the paths written."""
    rng = np.random.default_rng(0)
    results = [{"C_p": 0.8 - 0.03 * i, "window": i % 7, "function": "count",
                "aggregation": "sum"} for i in range(12)]
    imgs = rng.random((4, 64, 64, 12)) * 255
    gtb = np.zeros((4, 3, 4))
    gtb[:, 0] = [5, 5, 30, 30]
    gtm = np.zeros((4, 3))
    gtm[:, 0] = 1
    dets = np.zeros((4, 5, 6))
    dets[:, 0] = [8, 8, 28, 28, 0.9, 0]
    calls = {
        "gwd_map": lambda p: mod.gwd_map_correlation_figure(
            {"VoxelGrid": 0.4, "TORE": 0.37, "MDES": 0.33},
            {"VoxelGrid": 0.41, "TORE": 0.44, "MDES": 0.46}, path=p),
        "cp_over_time": lambda p: mod.plot_cp_over_time(
            results, {"VoxelGrid": 0.4, "TORE": 0.37}, path=p),
        "gwd_curves": lambda p: mod.plot_gwd_curves(
            [1, 2, 3, 9], {"VoxelGrid": [0.75, 0.68, 0.57, 0.42]}, "channels", path=p),
        "events_3d": lambda p: mod.plot_events_3d(fake_events(3000, 240, 304, 10**6, seed=0),
                                                  path=p),
        "rep_channels": lambda p: mod.plot_rep_channels(rng.random((32, 40, 12)), path=p),
        "train_batch": lambda p: mod.plot_train_batch(imgs, gtb, gtm, path=p),
        "val_pred": lambda p: mod.plot_val_predictions(imgs, dets, np.ones(4, int), gtb, gtm,
                                                       path=p),
    }
    out = {}
    for name, call in calls.items():
        out[name] = tmp / f"{name}.png"
        result = call(out[name])
        if name == "gwd_map":  # (fig, pearson r)
            out["pearson_r"] = result[1]
    return out


@pytest.fixture(scope="module")
def plots(tmp_path_factory):
    import matplotlib.pyplot as plt

    tmp = tmp_path_factory.mktemp("plots")
    (tmp / "port").mkdir()
    (tmp / "jax").mkdir()
    got = _plots(tmp / "port", viz, generate_fake_events)
    want = _plots(tmp / "jax", jax_viz, jax_fake_events)
    plt.close("all")
    return got, want


@pytest.mark.parametrize("name", ["gwd_map", "cp_over_time", "gwd_curves", "events_3d",
                                  "rep_channels", "train_batch", "val_pred"])
def test_plot_written(plots, name):
    got, want = plots
    assert got[name].stat().st_size > 1000 and want[name].stat().st_size > 1000
    if name == "gwd_map":
        assert_close("pearson r", got["pearson_r"], want["pearson_r"], atol=0)


def test_to_uint8_equals_jax():
    rng = np.random.default_rng(2)
    for x in (rng.random((8, 9, 12)) * 255, rng.random((8, 9, 2)), rng.random((8, 9, 3)) - 5):
        assert_close("_to_uint8", viz._to_uint8(x), jax_viz._to_uint8(x), atol=0)


def test_plot_without_matplotlib_names_it():
    code = ("import sys; sys.modules['matplotlib'] = None\n"
            "import numpy as np\n"
            "from event_representation_study_tpu_torch.utils import viz\n"
            "viz.draw_boxes(np.zeros((4, 4, 3), np.uint8), np.zeros((0, 4)))\n"
            "try:\n"
            "    viz.plot_train_batch(np.zeros((1, 8, 8, 3)), np.zeros((1, 1, 4)),"
            " np.zeros((1, 1)))\n"
            "except ImportError as e:\n"
            "    print('ImportError', e)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(REPO)}, timeout=120, check=True)
    assert "ImportError" in out.stdout and "matplotlib" in out.stdout, out.stdout + out.stderr
