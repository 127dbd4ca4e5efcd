"""The port's spans and counters (``utils/profiling.py``) on the CPU.

- Without a recording profiler, ``span`` hands back one shared no-op and
  ``count`` adds nothing.
- Under ``torch.profiler.profile``, every span is a FUNCTION-scope range
  ``ers/<name>`` (a ``record_function`` range would be mirrored onto the
  card's timeline as a user annotation), the ranges of a train step, the
  host feed and a classification epoch nest as the module docstrings say,
  and the span totals and counters count.
- ``data/loader.py::prefetched`` counts nearly every take as empty when
  the worker is slow, and nearly none when the consumer is.
- Spans and counts from many threads lose no update.
- A shrunk detector train step and a classification step give bit-equal
  outputs with the profiler on and off.
- A Swin-V2 forward opens ``swin/attn`` and ``swin/mlp`` once a block and
  ``swin/merge`` once a merge, and counts the windows and tokens its maps
  give (padding included); without a profiler it records nothing.
"""
import contextlib
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from event_representation_study_tpu_torch.data import nimagenet
from event_representation_study_tpu_torch.data.loader import prefetched
from event_representation_study_tpu_torch.events import (
    from_structured,
    generate_fake_events,
    stack_blocks,
)
from event_representation_study_tpu_torch.models import build_model
from event_representation_study_tpu_torch.models.resnet import EventResNet
from event_representation_study_tpu_torch.models.swin_vit import SwinTransformerV2ViT
from event_representation_study_tpu_torch.ops.image import letterbox_labels
from event_representation_study_tpu_torch.parallel.mesh import device_prefetch, make_mesh
from event_representation_study_tpu_torch.parallel.train_step import (
    Batch,
    TrainState,
    make_train_step,
)
from event_representation_study_tpu_torch.train import classifier
from event_representation_study_tpu_torch.train.ema import ema_init
from event_representation_study_tpu_torch.train.losses import LossConfig
from event_representation_study_tpu_torch.train.optim import SolverConfig, build_optimizer
from event_representation_study_tpu_torch.utils import profiling
from event_representation_study_tpu_torch.utils.config import load_config

H = W = 64
IMG, B, CAP, M = 64, 2, 1024, 4
CLS_IMG, NC, CLS_BATCH, SLICE = 64, 3, 4, 1500


@pytest.fixture(autouse=True)
def fresh_tables(monkeypatch):
    """Each test starts from empty span and counter tables."""
    monkeypatch.setattr(profiling, "_COUNTS", {})
    monkeypatch.setattr(profiling, "_SPANS", {})


def _recorded():
    return profile(activities=[ProfilerActivity.CPU])


def _ranges(prof):
    """{name: [parent's name or None]} of every ``ers/`` range."""
    out = {}
    for e in prof.events():
        if e.name.startswith(profiling.PREFIX):
            parent = e.cpu_parent
            while parent is not None and not parent.name.startswith(profiling.PREFIX):
                parent = parent.cpu_parent
            out.setdefault(e.name[len(profiling.PREFIX):], []).append(
                None if parent is None else parent.name[len(profiling.PREFIX):])
    return out


# -- a shrunk detector train step -------------------------------------------


def _train_state():
    cfg = load_config("configs/gen1_optimized.py",
                      overrides=["model.depth_multiple=0.2", "model.width_multiple=0.125"])
    model = build_model(cfg, 2, device="cpu", generator=torch.Generator().manual_seed(3))
    opt = build_optimizer(model, SolverConfig(epochs=300, steps_per_epoch=1000))
    opt.count = 1500  # past the warm-up: the update moves every leaf
    return TrainState(model, opt, ema_init(model), 0)


def _event_batch(seed=0):
    rng = np.random.default_rng(seed)
    evs = [generate_fake_events(1000, H, W, 50_000, seed=seed + i) for i in range(B)]
    xy = rng.uniform(0.3, 0.7, (B, M, 2))
    wh = rng.uniform(0.15, 0.3, (B, M, 2))
    norm = np.concatenate([rng.integers(0, 2, (B, M, 1)), xy, wh], -1).astype(np.float32)
    lab = np.stack([letterbox_labels(n, H, W, IMG) for n in norm])
    return Batch(None, stack_blocks([from_structured(e, CAP) for e in evs]),
                 lab[..., 0].astype(np.int32), lab[..., 1:5].astype(np.float32),
                 np.ones((B, M), np.float32))


def _step():
    return make_train_step(LossConfig(2), representation="OptimizedRepresentation",
                           rep_hw=(H, W), img_size=IMG, device="cpu")


def _train_outputs(state, parts):
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            {k: v.clone() for k, v in state.ema.variables.items()},
            {k: v.clone() for k, v in parts.items()})


# -- a classification epoch at 64² --------------------------------------------


@pytest.fixture(scope="module")
def small_frame():
    """The classifier's and the dataset's frame at 64²."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (classifier, nimagenet):
            mp.setattr(mod, "IMAGE_H", CLS_IMG)
            mp.setattr(mod, "IMAGE_W", CLS_IMG)
        yield


@pytest.fixture(scope="module")
def npz_files(tmp_path_factory, small_frame):
    return nimagenet.write_nimagenet_fixture(tmp_path_factory.mktemp("cls"), num_classes=NC,
                                             per_class=3, n_events=2000, seed=4)


def _classifier(files):
    ds = nimagenet.NImageNetDataset(*files, slice_length=SLICE, augment=True, seed=1)
    trainer = classifier.ClassifierTrainer(EventResNet(NC, "ResNet18"),
                                           "OptimizedRepresentation", NC, device="cpu")
    trainer.init()
    return trainer, ds


# -- tests ----------------------------------------------------------------------


def test_span_and_count_do_nothing_without_a_profiler():
    assert not torch.autograd.profiler._is_profiler_enabled
    assert profiling.span("step") is profiling.span("loader/wait")
    with profiling.span("step"):
        profiling.count("loader/takes")
    assert profiling.counters() == {} and profiling.span_totals() == {}


def test_spans_are_function_scope_ranges():
    """A span's range is of the FUNCTION scope, which the profiler does not
    mirror onto the card's timeline; its totals and the counters count
    while the profiler records, and the tables hand out copies."""
    with _recorded() as prof:
        assert torch.autograd.profiler._is_profiler_enabled
        with profiling.span("outer"):
            with profiling.span("outer/inner"):
                time.sleep(0.002)
        profiling.count("things", 3)
        profiling.count("things")
    assert not torch.autograd.profiler._is_profiler_enabled
    ranges = [e for e in prof.events() if e.name.startswith(profiling.PREFIX)]
    function = int(torch._C._profiler.RecordScope.FUNCTION)
    assert {e.name for e in ranges} == {"ers/outer", "ers/outer/inner"}
    assert all(e.scope == function and e.device_type == torch.autograd.DeviceType.CPU
               for e in ranges)
    assert _ranges(prof) == {"outer": [None], "outer/inner": ["outer"]}
    totals = profiling.span_totals()
    assert totals["outer"][0] == totals["outer/inner"][0] == 1
    assert totals["outer"][1] >= totals["outer/inner"][1] >= 0.002
    counts = profiling.counters()
    assert counts == {"things": 4}
    counts["things"] = 0
    assert profiling.counters() == {"things": 4}


def test_train_step_and_feed_ranges_nest():
    """The host feed (``prefetched`` under ``device_prefetch``) and a train
    step under the profiler: the step's stages nest in ``step``, the EMA's
    state-dict walk in ``ema``, ``ema`` in ``step`` outside ``step/update``."""
    state, step = _train_state(), _step()
    batch = _event_batch()
    mesh = make_mesh(device="cpu")
    with _recorded() as prof:
        feed = device_prefetch(prefetched(lambda sel: (batch, sel), [0, 1, 2]), mesh)
        for got, _ in feed:
            state, _ = step(state, got, 5)
            break
        feed.close()
    ranges = _ranges(prof)
    assert ranges["step"] == [None]
    for stage in ("step/input", "step/loss", "step/backward", "step/update", "ema"):
        assert ranges[stage] == ["step"], stage
    assert ranges["ema/state_dict"] == ["ema"]
    assert ranges["h2d/stage"] == [None, None]  # two batches staged ahead
    assert set(ranges.get("loader/wait", [])) <= {None}
    counts = profiling.counters()
    assert counts["loader/takes"] == 2
    assert counts.get("loader/empty_takes", 0) == len(ranges.get("loader/wait", []))
    assert profiling.span_totals()["ema"][0] == 1


def test_classification_ranges_nest(npz_files):
    """A training epoch of the classifier under the profiler: a batch range
    a batch, and inside it a decode and a prep range (the step thread's wait
    on each of the pool's phases), then a step and a readback a batch."""
    trainer, ds = _classifier(npz_files)
    with _recorded() as prof:
        trainer.run_epoch(ds, CLS_BATCH, train=True, rng=np.random.default_rng(0))
    ranges = _ranges(prof)
    batches = len(ds) // CLS_BATCH
    assert ranges["nimagenet/batch"] == [None] * batches
    assert ranges["nimagenet/decode"] == ["nimagenet/batch"] * batches
    assert ranges["nimagenet/prep"] == ["nimagenet/batch"] * batches
    assert ranges["classify/step"] == [None] * batches
    assert ranges["classify/readback"] == [None] * batches
    totals = profiling.span_totals()
    assert totals["nimagenet/decode"][0] == batches and totals["nimagenet/decode"][1] > 0
    assert totals["nimagenet/batch"][1] >= totals["nimagenet/decode"][1] + totals["nimagenet/prep"][1]


@pytest.mark.parametrize("slow", ["worker", "consumer"])
def test_prefetched_counts_empty_takes(slow):
    """A slow worker leaves the queue empty at nearly every take (each
    waited on in ``loader/wait``); a slow consumer finds a batch waiting at
    nearly every take."""
    n = 12

    def make_batch(sel):
        if slow == "worker":
            time.sleep(0.02)
        return sel

    with _recorded():
        got = []
        for item in prefetched(make_batch, list(range(n))):
            if slow == "consumer":
                time.sleep(0.02)
            got.append(item)
    assert got == list(range(n))
    counts = profiling.counters()
    assert counts["loader/takes"] == n + 1  # the batches and the end of the stream
    empty = counts.get("loader/empty_takes", 0)
    calls, seconds = profiling.span_totals().get("loader/wait", (0, 0.0))
    assert calls == empty
    if slow == "worker":
        assert empty >= n - 1 and seconds >= 0.01 * (n - 1)
    else:
        assert empty <= 2


def test_tables_lose_no_update_across_threads():
    """Spans and counts from more threads than cores, switching often,
    add up exactly in the process-wide tables."""
    threads, each = 16, 5000
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _recorded():
            def work():
                for _ in range(each):
                    with profiling.span("worker"):
                        profiling.count("worker/items")
                        profiling.count("worker/weight", 2)

            pool = [threading.Thread(target=work) for _ in range(threads)]
            for th in pool:
                th.start()
            for th in pool:
                th.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(th.is_alive() for th in pool)
    assert profiling.span_totals()["worker"][0] == threads * each
    assert profiling.counters() == {"worker/items": threads * each,
                                    "worker/weight": 2 * threads * each}


@pytest.mark.parametrize("path", ["train_step", "classifier_step"])
def test_spans_change_no_output(path, npz_files):
    """The same step from the same state and batch, untraced and under the
    profiler: bit-equal losses, parameters, statistics and EMA."""
    outs = []
    for traced in (False, True):
        ctx = _recorded() if traced else contextlib.nullcontext()
        if path == "train_step":
            state, step = _train_state(), _step()
            with ctx:
                state, parts = step(state, _event_batch(), 5)
            outs.append(_train_outputs(state, parts))
        else:
            torch.manual_seed(0)
            trainer, ds = _classifier(npz_files)
            with ctx:
                out = trainer.run_epoch(ds, CLS_BATCH, train=True, rng=np.random.default_rng(0))
            outs.append(({k: v.clone() for k, v in trainer.model.state_dict().items()},
                         {k: out[k] for k in ("loss", "top1", "top5")}))
    for a, b in zip(*outs):
        assert a.keys() == b.keys()
        for k in a:
            if torch.is_tensor(a[k]):
                assert torch.equal(a[k], b[k]), k
            else:
                assert a[k] == b[k], k


def test_swin_ranges_and_counts():
    """A small Swin-V2 (embed 32, depths 2/2/4/2, window 12) on 64² input:
    maps 16/8/4/2. Stage 0 pads 16² to 24², 4 windows of 144 tokens an
    image (its shifted block attends the same windows under the mask);
    stages 1-3 shrink the window to the map, 1 window of 64, 16 and 4."""
    depths = (2, 2, 4, 2)
    net = SwinTransformerV2ViT(12, embed_dim=32, depths=depths, num_heads=(1, 2, 4, 8)).eval()
    x = torch.randn(B, 12, 64, 64)
    with torch.no_grad():
        net(x)  # no profiler: nothing recorded
        assert profiling.counters() == {} and profiling.span_totals() == {}
        with _recorded() as prof:
            net(x)
    ranges = _ranges(prof)
    blocks = sum(depths)
    assert ranges["swin/attn"] == [None] * blocks and ranges["swin/mlp"] == [None] * blocks
    assert ranges["swin/merge"] == [None] * (len(depths) - 1)
    windows = [4, 1, 1, 1]  # an image, by stage
    tokens = [144, 64, 16, 4]  # a window, by stage
    assert profiling.counters() == {
        "swin/windows": B * sum(d * w for d, w in zip(depths, windows)),
        "swin/tokens": B * sum(d * w * n for d, w, n in zip(depths, windows, tokens))}
