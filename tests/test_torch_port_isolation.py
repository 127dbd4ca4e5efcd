"""The PyTorch port stands alone: it imports no JAX and nothing of the JAX
package, its entry points refuse to fall back from CUDA to the CPU, and the
kernel wrapper never computes a CUDA tensor on the CPU."""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from event_representation_study_tpu_torch.events import h5_io
from event_representation_study_tpu_torch.ops import fused_scatter, roll
from event_representation_study_tpu_torch.reps import batched_representation

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "event_representation_study_tpu")

_PROBE = """
import importlib, json, pkgutil, sys
import event_representation_study_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
print(json.dumps({"modules": names, "loaded": sorted(sys.modules)}))
"""


def test_port_imports_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True, text=True,
        check=True, env={**os.environ, "PYTHONPATH": str(REPO)}, timeout=120,
    )
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(report["modules"]) >= 20
    bad = [m for m in report["loaded"] if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-CUDA behaviour cannot be shown")


def test_make_server_defaults_to_cuda(no_cuda):
    from event_representation_study_tpu_torch.cli.infer import make_server
    from event_representation_study_tpu_torch.utils.config import load_config

    cfg = load_config(REPO / "configs/gen1_optimized.py")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_server(cfg, "OptimizedRepresentation", 240, 304, 640)


def test_train_step_defaults_to_cuda(no_cuda):
    from event_representation_study_tpu_torch.parallel.train_step import make_train_step
    from event_representation_study_tpu_torch.train.losses import LossConfig

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_train_step(LossConfig(2), "ERGO12")


def test_trainer_defaults_to_cuda(no_cuda, tmp_path):
    from event_representation_study_tpu_torch.train.engine import Trainer
    from event_representation_study_tpu_torch.utils.config import load_config

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(load_config(REPO / "configs/gen1_optimized.py"), tmp_path)


def test_evaler_defaults_to_cuda(no_cuda, tmp_path):
    from event_representation_study_tpu_torch.train.evaler import Evaler

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Evaler(torch.nn.Identity(), None, 2, "OptimizedRepresentation")


@pytest.mark.parametrize("cli", ["train", "eval"])
def test_cli_defaults_to_cuda(no_cuda, cli, tmp_path):
    import importlib

    main = importlib.import_module(f"event_representation_study_tpu_torch.cli.{cli}").main
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--data-path", str(tmp_path)])


class _CudaLike(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor."""

    @property
    def is_cuda(self):
        return True


def test_kernel_wrapper_never_falls_back(no_cuda, monkeypatch):
    def plain(*a, **k):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(fused_scatter, "segment_reduce_sorted_plain", plain)
    B, N, S = 1, 8, 4
    seg_s = torch.zeros((B, N), dtype=torch.int32)
    vs = torch.zeros((B, 2, N)).as_subclass(_CudaLike)
    with pytest.raises(RuntimeError):
        fused_scatter.segment_reduce_sorted(seg_s, vs, None, S)
    assert fused_scatter.LAUNCHES[fused_scatter.K2] == 0


def test_roll_wrapper_never_falls_back(no_cuda, monkeypatch):
    def plain(*a, **k):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(roll, "roll_rows_plain", plain)
    x = torch.zeros((1, 2, 8, 4)).as_subclass(_CudaLike)
    with pytest.raises(RuntimeError):
        roll.roll_rows(x, torch.zeros((1, 2), dtype=torch.int32), 5)
    assert roll.LAUNCHES[roll.K3] == 0


def _train_step(**kw):
    from event_representation_study_tpu_torch.parallel.train_step import make_train_step
    from event_representation_study_tpu_torch.train.losses import LossConfig

    return make_train_step(LossConfig(2), **{"representation": "ERGO12", "device": "cpu", **kw})


@pytest.mark.parametrize(
    "call,item",
    [
        (lambda tmp: batched_representation("VoxelGrid", 4, 4), "M12"),
        (lambda tmp: batched_representation("TORE", 4, 4), "M12"),
        (lambda tmp: _trainer(tmp, fuse_ab=True), "M14"),
        (lambda tmp: _build("EfficientRep"), "M14"),
        (lambda tmp: _train_step(mode="fuseab"), "M14"),
        (lambda tmp: _train_step(mode="distill"), "M14"),
        (lambda tmp: _trainer(tmp, steps_per_dispatch=2), "M7"),
        (lambda tmp: _train_step(representation="LearnedRepresentation"), "M14"),
    ],
    # the ids "hdf5" and "train_event_aug" (both ported) keep their names for
    # a Trainer with fuse_ab (M14) and one with multi-step dispatch (M7)
    ids=["voxel_grid", "tore", "hdf5", "backbone", "train_fuseab", "train_distill",
         "train_event_aug", "train_learned_rep"],
)
def test_unported_paths_name_their_roadmap_item(call, item, tmp_path):
    with pytest.raises(NotImplementedError, match=item):
        call(tmp_path)


def _trainer(tmp, **kw):
    from event_representation_study_tpu_torch.train.engine import Trainer
    from event_representation_study_tpu_torch.utils.config import load_config

    return Trainer(load_config(REPO / "configs/gen1_optimized.py"), tmp, device="cpu", **kw)


def _build(backbone):
    from event_representation_study_tpu_torch.models import build_model
    from event_representation_study_tpu_torch.utils.config import load_config

    cfg = load_config(REPO / "configs/gen1_optimized.py")
    cfg["model"]["backbone"]["type"] = backbone
    return build_model(cfg, 2)


@pytest.mark.parametrize("suffix", [".npz", ".npy", ".npz-structured"])
def test_event_file_loading(suffix, tmp_path):
    rng = np.random.default_rng(0)
    cols = np.stack([rng.integers(0, 30, 50), rng.integers(0, 20, 50),
                     np.sort(rng.integers(0, 10**6, 50)), rng.integers(0, 2, 50)], 1)
    if suffix == ".npy":
        path = tmp_path / "e.npy"
        np.save(path, cols)
    elif suffix == ".npz":
        path = tmp_path / "e.npz"
        np.savez(path, event_data=cols)
    else:
        path = tmp_path / "e.npz"
        st = np.zeros(50, dtype=[("x", "<i2"), ("y", "<i2"), ("ts", "<i8"), ("p", "<i1")])
        st["x"], st["y"], st["ts"], st["p"] = cols.T
        np.savez(path, events=st)
    ev = h5_io.load_events_from_path(path)
    np.testing.assert_array_equal(ev["x"], cols[:, 0])
    np.testing.assert_array_equal(ev["t"], cols[:, 2])
    np.testing.assert_array_equal(ev["p"], 2 * cols[:, 3] - 1)
