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

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "event_representation_study_tpu")
# the representation library, the GWD ranking, the channel search, the
# event windows, the N-ImageNet classification, the detector zoo, the
# training variants and deploy tools, the 1 Mpx data with the event-file
# tools, the metrics writers' and utilities' own copies, and the image data,
# demo inputs, plots and reference-checkpoint import, and the parallel layer,
# imported in the probe too
NEW_MODULES = ("ops.scatter", "reps.histogram", "reps.voxel_grid", "reps.event_stack",
               "reps.time_surface", "reps.tore", "reps.mdes", "reps.fused_reps",
               "metrics.chosen_indexes", "metrics.gw", "metrics.gw_exact", "metrics.otmi",
               "cli.gwd", "search.benchmarks", "search.chimera", "search.db", "search.native",
               "search.kernels", "search.bnn", "search.acquisition", "search.gryffin",
               "search.optimize", "search.mixed", "cli.bo", "events.windows", "data.nimagenet",
               "data.nimagenet_loaders", "models.resnet", "train.classifier", "cli.classify",
               "models.swin_vit", "models.backbones", "models.necks", "models.layers",
               "utils.reparam", "models.learned_repr", "models.backend",
               "train.losses_variants", "train.rep_optimizer", "utils.quantize",
               "utils.export", "events.prophesee", "events.filters", "events.rosbag",
               "data.gen4", "data.gen4_legacy", "cli.consolidate", "cli.convert",
               "cli.precompute_reps", "utils.tb_native", "utils.profiling", "utils.tasks",
               "data.image_dataset", "data.demo_data", "utils.viz", "utils.torch_convert",
               "parallel.dist", "parallel.mesh", "parallel.batch_norm", "parallel.event_shard",
               "parallel.tensor_parallel")

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
    prefix = "event_representation_study_tpu_torch."
    assert {prefix + m for m in NEW_MODULES} <= set(report["modules"])
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


def test_classifier_trainer_defaults_to_cuda(no_cuda):
    from event_representation_study_tpu_torch.models.resnet import EventResNet
    from event_representation_study_tpu_torch.train.classifier import ClassifierTrainer

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ClassifierTrainer(EventResNet(3, "ResNet18"), "OptimizedRepresentation", 3)


def test_evaler_defaults_to_cuda(no_cuda, tmp_path):
    from event_representation_study_tpu_torch.train.evaler import Evaler

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Evaler(torch.nn.Identity(), None, 2, "OptimizedRepresentation")


@pytest.mark.parametrize("cli", ["train", "eval", "gwd", "classify", "precompute_reps"])
def test_cli_defaults_to_cuda(no_cuda, cli, tmp_path):
    import importlib

    main = importlib.import_module(f"event_representation_study_tpu_torch.cli.{cli}").main
    if cli == "classify":
        (tmp_path / "list.txt").write_text("")
        args = ["--train-list", str(tmp_path / "list.txt"), "--val-list", str(tmp_path / "list.txt")]
    else:
        args = ["--data-path", str(tmp_path)]
    if cli == "precompute_reps":
        args += ["--output-dir", str(tmp_path / "out")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(args)


def test_eval_half_defaults_to_cuda(no_cuda, tmp_path):
    """``cli/eval.py --half`` (bf16 compute) raises without CUDA rather than
    running on the CPU."""
    from event_representation_study_tpu_torch.cli import eval as eval_cli

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_cli.main(["--data-path", str(tmp_path), "--half"])


def test_bf16_train_step_is_refused():
    """A bf16 model's train step, refused until K3 ran in bf16 on a train
    step (ROADMAP M20), now runs: float32 weights and gradients, finite
    loss parts."""
    state, parts = _bf16_step_runs()
    assert all(bool(torch.isfinite(v)) for v in parts.values())
    assert state.step == 1
    assert all(p.dtype == p.grad.dtype == torch.float32 for p in state.model.parameters())


@pytest.mark.parametrize("metric", ["otmi", "gw_distance"])
def test_gwd_metrics_default_to_cuda(no_cuda, metric):
    """The host-side metrics take NumPy arrays, so no tensor fixes their
    device: they run on ``cuda`` unless the caller passes ``device="cpu"``."""
    from event_representation_study_tpu_torch.metrics.gw import gw_distance
    from event_representation_study_tpu_torch.metrics.otmi import otmi

    cloud = np.random.default_rng(0).random((16, 4)).astype(np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if metric == "otmi":
            otmi(cloud * 8, np.ones((8, 8, 2), np.float32), 8, 8, rep_size=8)
        else:
            gw_distance(cloud, cloud)


def _search_entry(name, tmp_path):
    from event_representation_study_tpu_torch.search import gryffin, mixed, optimize

    if name == "gryffin":
        return gryffin.Gryffin(optimize.search_space())
    if name == "mixed_gryffin":
        return mixed.MixedGryffin([mixed.ContinuousParam("x", 0.0, 1.0)])
    if name == "sequential_optimization":
        return optimize.sequential_optimization(lambda triples: 0.0, channels=1, budget=1)
    if name == "refine_descriptors":
        return mixed.refine_descriptors(np.eye(3), np.arange(3.0))
    from event_representation_study_tpu_torch.cli import bo

    (tmp_path / "space.json").write_text(json.dumps(
        {"parameters": [{"name": "x", "type": "continuous", "low": 0, "high": 1}]}))
    return bo.main(["--config", str(tmp_path / "space.json"), "--observations",
                    str(tmp_path / "obs.json"), "--out", str(tmp_path / "recs.json")])


@pytest.mark.parametrize("name", ["gryffin", "mixed_gryffin", "sequential_optimization",
                                  "refine_descriptors", "cli_bo"])
def test_search_defaults_to_cuda(no_cuda, name, tmp_path):
    """The channel search's entry points run the surrogate on ``cuda``
    unless the caller passes ``device="cpu"`` (``--device cpu``)."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _search_entry(name, tmp_path)
    assert not (tmp_path / "recs.json").exists()


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


def _images_trainer(tmp):
    """A shrunk Trainer on a synthetic image folder (``data.type=images``),
    one epoch with --augment: 3-channel input, the image-space warp."""
    from event_representation_study_tpu_torch.data.image_dataset import write_image_folder
    from event_representation_study_tpu_torch.train.engine import Trainer
    from event_representation_study_tpu_torch.utils.config import load_config

    write_image_folder(tmp, n=4, seed=1)
    cfg = load_config(REPO / "configs/gen1_optimized.py", overrides=SMALL + ["data.type=images"])
    tr = Trainer(cfg, tmp, batch_size=2, epochs=1, img_size=64, output_dir=tmp / "out",
                 augment=True, device="cpu")
    tr.train()
    assert tr.representation is None and tr.aug_mode == "image" and tr.state.step == 2
    assert tr.model.backbone.stem.conv.weight.shape[1] == 3
    return tr


def _plots_trainer(tmp):
    """A shrunk Trainer on Gen1 splits with ``plot_images``: the train-batch
    and validation mosaics are written."""
    from event_representation_study_tpu_torch.data.gen1 import write_gen1_fixture
    from event_representation_study_tpu_torch.train.engine import Trainer
    from event_representation_study_tpu_torch.utils.config import load_config

    for split in ("training.h5", "validation.h5"):
        write_gen1_fixture(tmp / split, num_files=1, boxes_per_file=3, events_per_file=2000,
                           seed=7)
    tr = Trainer(load_config(REPO / "configs/gen1_optimized.py", overrides=SMALL), tmp,
                 batch_size=2, epochs=1, img_size=64, num_events=512, output_dir=tmp / "out",
                 plot_images=True, device="cpu")
    tr.train()
    for name in ("train_batch.png", "val_pred.png"):
        assert (tmp / "out" / name).stat().st_size > 1000, name
    return tr


SMALL = ["model.depth_multiple=0.2", "model.width_multiple=0.125"]


def _bf16_step_runs(tmp=None):
    """One bf16 step of the shrunk detector on 64 px images with a
    strong-augmentation plan (the exact warp gathers its source in bf16)."""
    from event_representation_study_tpu_torch.data.augment import plan_augment_batch
    from event_representation_study_tpu_torch.models import build_model
    from event_representation_study_tpu_torch.ops.warp import AugPlan
    from event_representation_study_tpu_torch.parallel.train_step import (
        Batch, init_train_state)
    from event_representation_study_tpu_torch.train.optim import SolverConfig, build_optimizer
    from event_representation_study_tpu_torch.utils.config import load_config

    cfg = load_config(REPO / "configs/gen1_optimized.py", overrides=SMALL)
    model = build_model(cfg, 2, device="cpu", dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(0))
    state = init_train_state(model, build_optimizer(model, SolverConfig()))
    rng = np.random.default_rng(2)
    labels = [np.array([[i % 2, 8.0, 10.0, 40.0, 44.0]], np.float32) for i in range(4)]
    plan, lab, nl = plan_augment_batch(labels, 64, dict(cfg["data_aug"], mixup=1.0), rng, 8)
    batch = Batch(rng.uniform(0, 255, (4, 64, 64, 12)).astype(np.float32), None, lab[..., 0],
                  lab[..., 1:5], (np.arange(8)[None] < nl[:, None]).astype(np.float32),
                  AugPlan(**plan))
    return _train_step(representation=None, img_size=64, warp_impl="exact")(state, batch, 0)


def _k_step_trainer_runs(tmp):
    """A shrunk Trainer at K = 2 with the once-a-call EMA, one epoch of 3
    batches (a K-step call and a remainder step)."""
    from event_representation_study_tpu_torch.data.gen1 import write_gen1_fixture
    from event_representation_study_tpu_torch.train.engine import Trainer
    from event_representation_study_tpu_torch.utils.config import load_config

    for split, boxes in (("training.h5", 6), ("validation.h5", 2)):
        write_gen1_fixture(tmp / split, num_files=1, boxes_per_file=boxes,
                           events_per_file=3000, seed=boxes)
    tr = Trainer(load_config(REPO / "configs/gen1_optimized.py", overrides=SMALL), tmp,
                 batch_size=2, epochs=1, img_size=64, num_events=512, output_dir=tmp / "out",
                 steps_per_dispatch=2, ema_cadence="dispatch", device="cpu")
    tr.train()
    assert (tr.state.step, tr.state.ema.updates) == (3, 3)
    return tr


@pytest.mark.parametrize(
    "call",
    [_plots_trainer, _bf16_step_runs, _images_trainer, _k_step_trainer_runs],
    # the ids name the paths as they were named while unported: "train_plots"
    # for the train/val plots (M19), "train_ptq" for a bf16 train step (M20),
    # "backbone" for an image-folder dataset (M19), "train_event_aug" for
    # multi-step dispatch (M7)
    ids=["train_plots", "train_ptq", "backbone", "train_event_aug"],
)
def test_ported_paths_run(call, tmp_path):
    """Each path that once raised naming its ROADMAP item builds and runs."""
    assert call(tmp_path) is not None


@pytest.mark.parametrize(
    "call",
    [
        lambda: _train_step(mode="fuseab"),
        lambda: _train_step(mode="distill", teacher=_build()),
        lambda: _train_step(representation="LearnedRepresentation"),
        lambda: _build(fuse_ab=True).head.cls_pred_ab_0,
        lambda: _build(distill_ns=True).head.reg_pred_dist_0,
        lambda: _build(representation="LearnedRepresentation").quantization,
    ],
    ids=["train_fuseab", "train_distill", "train_learned_rep", "backbone_fuse_ab",
         "head_distill_ns", "model_learned_rep"],
)
def test_variant_paths_build(call):
    """The paths that named M14 before it was ported now build."""
    assert call() is not None


def test_calib_needs_quant(tmp_path):
    from event_representation_study_tpu_torch.cli import train as train_cli

    with pytest.raises(SystemExit):
        train_cli.main(["--data-path", str(tmp_path), "--calib", "--device", "cpu"])


def _build(**kw):
    from event_representation_study_tpu_torch.models import build_model
    from event_representation_study_tpu_torch.utils.config import load_config

    return build_model(load_config(REPO / "configs/gen1_optimized.py"), 2, device="meta", **kw)


@pytest.mark.parametrize("suffix", [".npz", ".npy", ".npz-structured", ".dat", ".bin", ".bag"])
def test_event_file_loading(suffix, tmp_path):
    rng = np.random.default_rng(0)
    cols = np.stack([rng.integers(0, 30, 50), rng.integers(0, 20, 50),
                     np.sort(rng.integers(0, 10**6, 50)), rng.integers(0, 2, 50)], 1)
    if suffix in (".dat", ".bin", ".bag"):  # Prophesee EVT2.0, N-MNIST, ROS1 bag
        from event_representation_study_tpu_torch.events import prophesee, rosbag

        path = tmp_path / f"e{suffix}"
        ev = np.zeros(50, dtype=prophesee.EVENT_DTYPE)
        ev["x"], ev["y"], ev["t"], ev["p"] = cols[:, 0], cols[:, 1], cols[:, 2], 2 * cols[:, 3] - 1
        if suffix == ".dat":
            prophesee.write_dat(path, ev, 20, 30)
        elif suffix == ".bin":
            ev["t"] //= 1000  # N-MNIST timestamps fit 23 bits
            cols[:, 2] //= 1000
            prophesee.write_nmnist_bin(path, ev)
        else:
            rosbag.write_events_to_rosbag(path, ev, height=20, width=30)
    elif suffix == ".npy":
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
