"""Mini N-ImageNet data of the port against the JAX package on the same npz
files and seeds: the dataset's samples (reshape ``no_sample`` / ``sample`` /
``unique``, the random slice, ``base_augment``'s drops, the ``(4,
slice_length)`` int32 block) and the prebuilt host images of every original
loader type. Host NumPy on both sides: every comparison is exact. The
port's batches, inline and on its pool of worker processes, against its
samples one by one and the JAX package's; the pool's errors, engagement,
ownership of what it returns, and shutdown."""
import os
import pathlib
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch

from event_representation_study_tpu.data import nimagenet as jax_nim
from event_representation_study_tpu.data import nimagenet_loaders as jax_loaders
from event_representation_study_tpu_torch.data import nimagenet, nimagenet_loaders
from event_representation_study_tpu_torch.models.resnet import EventResNet
from event_representation_study_tpu_torch.train.classifier import ClassifierTrainer
from event_representation_study_tpu_torch.utils import profiling
from torch_port_helpers import assert_close

SLICE = 3000


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """9 samples of 4,000 events at the 480x640 sensor, 3 classes."""
    return nimagenet.write_nimagenet_fixture(tmp_path_factory.mktemp("nim"), num_classes=3,
                                             per_class=3, n_events=4000, seed=2)


def _pair(files, **kw):
    return (nimagenet.NImageNetDataset(*files, **kw), jax_nim.NImageNetDataset(*files, **kw))


def test_fixture_writer_like_jax(files, tmp_path):
    want = jax_nim.write_nimagenet_fixture(tmp_path, num_classes=3, per_class=3,
                                           n_events=4000, seed=2)
    assert files[1] == want[1]
    for a, b in zip(files[0], want[0]):
        assert_close("fixture event_data", np.load(a)["event_data"], np.load(b)["event_data"],
                     atol=0)


@pytest.mark.parametrize("reshape", ["no_sample", "sample", "unique"])
@pytest.mark.parametrize("augment", [False, True], ids=["plain", "augment"])
def test_samples_like_jax(files, reshape, augment):
    """Two passes over the dataset (the generator moves on between them):
    event blocks, counts and labels equal."""
    got, want = _pair(files, slice_length=SLICE, reshape_method=reshape, augment=augment, seed=4)
    for i in list(range(len(want))) * 2:
        g, w = got[i], want[i]
        assert g.events.dtype == w.events.dtype == np.int32
        assert (g.num_events, g.label) == (w.num_events, w.label)
        assert_close(f"{reshape} augment={augment} sample {i}", g.events, w.events, atol=0)


@pytest.mark.parametrize("loader_type", sorted(nimagenet.LOADER_TO_REP)
                         + sorted(nimagenet_loaders.HOST_LOADERS))
def test_loader_types_like_jax(files, loader_type, monkeypatch):
    """Every loader type: the representation it names (device types) or
    its host images (original aggregation functions) one by one and as a
    batch on two worker processes, and its channels."""
    monkeypatch.setattr(nimagenet, "pool_width", lambda: 2)
    got, want = _pair(files, loader_type=loader_type, slice_length=SLICE, augment=True, seed=9)
    assert got.representation == want.representation
    if loader_type in ("reshape_then_voxel_grid", "reshape_then_to_image",
                       "reshape_then_time_surface"):
        # the JAX package looks ToVoxelGrid / ToImage / ToTimesurface up in
        # REPRESENTATION_CHANNELS, which lacks them; the port resolves them
        # by the dispatcher's name rules, as batched_representation does
        with pytest.raises(KeyError):
            want.channels
        assert got.channels == (2 if loader_type == "reshape_then_to_image" else 12)
    else:
        assert got.channels == want.channels
    if got.representation is not None:
        return
    for i in (0, 4, 8):
        g, w = got.host_image(i), want.host_image(i)
        assert g.shape == w.shape == (224, 224, want.channels) and g.dtype == w.dtype
        assert_close(f"{loader_type} host image {i}", g, w, atol=0)
    pooled = got.host_images([5, 1, 5, 7])
    assert_close(f"{loader_type} host images", pooled,
                 np.stack([want.host_image(i) for i in (5, 1, 5, 7)]), atol=0)


@pytest.mark.parametrize("kw", [dict(strict=True), dict(neglect_polarity=True, use_image=True),
                                dict(quantize_sort=[4, 16], global_time=False)],
                         ids=["strict", "neglect_image", "quantize_local"])
def test_acc_sort_options_like_jax(files, kw):
    ev = nimagenet.NImageNetDataset(*files, slice_length=SLICE)._event_tensor(1)
    assert_close(f"acc_sort {kw}", nimagenet_loaders.reshape_then_acc_sort(ev, **kw),
                 jax_loaders.reshape_then_acc_sort(ev, **kw), atol=0)


def test_unknown_loader_type_raises(files):
    with pytest.raises(ValueError, match="unknown loader_type"):
        nimagenet.NImageNetDataset(*files, loader_type="reshape_then_nothing").representation


def _like_samples(what, got, ds, indices):
    """``got`` (a batch) against ``ds``'s samples one by one."""
    events, num, labels = got
    assert (events.dtype, num.dtype, labels.dtype) == (np.int32, np.int32, np.int64)
    want = [ds[i] for i in indices]
    assert_close(what, events, np.stack([s.events for s in want]), atol=0)
    assert num.tolist() == [s.num_events for s in want]
    assert labels.tolist() == [s.label for s in want]


BATCHES = {"even": ([3, 0, 8, 3, 5, 5, 1, 7, 2, 6, 4, 0], [8, 8, 2, 7]),
           # 3 + 2 and 6 + 5 samples on two workers, then one batch inline
           "uneven": ([7, 7, 0, 4, 1], [2, 8, 8, 5, 3, 6, 0, 1, 4, 4, 7], [6, 1, 6])}


@pytest.mark.parametrize("width,batches", [(1, "even"), (2, "even"), (None, "even"),
                                           (2, "uneven")],
                         ids=["inline", "two", "default", "processes"])
@pytest.mark.parametrize("reshape", ["no_sample", "sample", "unique"])
@pytest.mark.parametrize("augment", [False, True], ids=["plain", "augment"])
def test_pooled_batch_like_samples(files, reshape, augment, width, batches, monkeypatch):
    """Batches with repeated indices, inline (width 1), on two worker
    processes and at this machine's width (inline below two samples a
    worker): bit-equal to the samples one by one (the port's and the JAX
    package's), each leaving the generator where they leave it."""
    if width is not None:
        monkeypatch.setattr(nimagenet, "pool_width", lambda: width)
    kw = dict(slice_length=SLICE, reshape_method=reshape, augment=augment, seed=4)
    pooled, serial = nimagenet.NImageNetDataset(*files, **kw), nimagenet.NImageNetDataset(*files, **kw)
    want = jax_nim.NImageNetDataset(*files, **kw)
    for indices in BATCHES[batches]:
        got = pooled.batch(np.array(indices))
        for ref in (serial, want):
            _like_samples(f"{reshape} augment={augment} width={width} batch", got, ref, indices)
        assert pooled.rng.bit_generator.state == serial.rng.bit_generator.state \
            == want.rng.bit_generator.state
    if width == 2:
        assert len(nimagenet._POOL.procs) == 2


def test_batches_are_the_callers_own(files, monkeypatch):
    """A batch from the worker processes owns its arrays: the next batch
    leaves them as they were."""
    monkeypatch.setattr(nimagenet, "pool_width", lambda: 2)
    ds = nimagenet.NImageNetDataset(*files, slice_length=SLICE, augment=True, seed=4)
    first = ds.batch([0, 1, 2, 3, 4])
    kept = [a.copy() for a in first]
    second = ds.batch([5, 6, 7, 8, 0])
    for a, b in zip(first, kept):
        np.testing.assert_array_equal(a, b)
    assert first[0].flags.owndata and not np.shares_memory(first[0], second[0])
    assert not np.array_equal(first[0], second[0])


def test_worker_error_reaches_the_caller(files, tmp_path, monkeypatch):
    """A missing file fails its batch on the caller (``_batch_of``) with the
    worker's exception, before any draw; the pool then assembles the next
    batch as a fresh dataset would."""
    monkeypatch.setattr(nimagenet, "pool_width", lambda: 2)
    paths, labels = list(files[0]), files[1]
    paths[4] = str(tmp_path / "missing.npz")
    kw = dict(slice_length=SLICE, augment=True, seed=4)
    ds = nimagenet.NImageNetDataset(paths, labels, **kw)
    fresh = nimagenet.NImageNetDataset(paths, labels, **kw)
    trainer = ClassifierTrainer(EventResNet(3, "ResNet18"), ds.representation, 3, device="cpu")
    with pytest.raises(FileNotFoundError, match="missing.npz"):
        trainer._batch_of(ds, np.array([0, 4, 8, 2]))
    assert ds.rng.bit_generator.state == fresh.rng.bit_generator.state
    assert len(nimagenet._POOL.procs) == 2 and all(p.is_alive() for p in nimagenet._POOL.procs)
    blocks, got_labels = trainer._batch_of(ds, np.array([0, 8, 1, 5]))
    want = [fresh[i] for i in (0, 8, 1, 5)]
    assert_close("after a failed batch", blocks.x.numpy(),
                 np.stack([s.events[0] for s in want]), atol=0)
    assert blocks.num.tolist() == [s.num_events for s in want]
    assert got_labels.tolist() == [s.label for s in want]


def test_small_batches_run_inline_and_uncounted(files, monkeypatch):
    """Under a profiler, at two workers: a batch of three runs inline, of
    four and five on the workers; ``nimagenet/worker_samples`` counts the
    nine samples of the latter, and every batch opens its three spans."""
    monkeypatch.setattr(nimagenet, "pool_width", lambda: 2)
    monkeypatch.setattr(profiling, "_COUNTS", {})
    monkeypatch.setattr(profiling, "_SPANS", {})
    ds = nimagenet.NImageNetDataset(*files, slice_length=SLICE, augment=True, seed=4)
    serial = nimagenet.NImageNetDataset(*files, slice_length=SLICE, augment=True, seed=4)
    order = ([2, 5, 2], [0, 1, 2, 3], [8, 7, 6, 5, 4])
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got = [ds.batch(indices) for indices in order]
    assert profiling.counters() == {"nimagenet/worker_samples": 9}
    totals = profiling.span_totals()
    assert [totals[f"nimagenet/{s}"][0] for s in ("batch", "decode", "prep")] == [3, 3, 3]
    for batch, indices in zip(got, order):
        _like_samples("counted batch", batch, serial, indices)


def test_pool_takes_the_frame_of_the_batch(files, monkeypatch):
    """The frame read when a batch begins reaches the workers (the
    classifier's tests shrink it to 64² by patching the module)."""
    monkeypatch.setattr(nimagenet, "pool_width", lambda: 2)
    for mod in (nimagenet, jax_nim):
        monkeypatch.setattr(mod, "IMAGE_H", 64)
        monkeypatch.setattr(mod, "IMAGE_W", 48)
    kw = dict(slice_length=SLICE, reshape_method="sample", augment=True, seed=6)
    got = nimagenet.NImageNetDataset(*files, **kw).batch([4, 2, 0, 6, 8])
    _like_samples("64x48 frame", got, jax_nim.NImageNetDataset(*files, **kw), [4, 2, 0, 6, 8])
    assert got[0][:, 0].max() <= 47 and got[0][:, 1].max() <= 63


def test_threads_share_the_pool(files, monkeypatch):
    """Two threads building batches of two datasets at once take the one
    pool in turns: every batch is still its dataset's samples."""
    monkeypatch.setattr(nimagenet, "pool_width", lambda: 2)
    kw = dict(slice_length=SLICE, augment=True)
    order = [[0, 3, 6, 1, 4], [8, 5, 2, 7], [1, 1, 2, 3, 5, 8]] * 3
    results, errors = {}, []

    def build(seed):
        try:
            ds = nimagenet.NImageNetDataset(*files, seed=seed, **kw)
            results[seed] = [ds.batch(ix) for ix in order]
        except Exception as exc:  # reported below
            errors.append(exc)

    threads = [threading.Thread(target=build, args=(seed,)) for seed in (11, 12)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads) and not errors
    for seed in (11, 12):
        serial = nimagenet.NImageNetDataset(*files, seed=seed, **kw)
        for ix, got in zip(order, results[seed]):
            _like_samples(f"thread of seed {seed}", got, serial, ix)


def _memfds():
    """This process's descriptors of the pool's shared buffer."""
    out = []
    for fd in os.listdir("/proc/self/fd"):
        try:
            if "nimagenet-batch" in os.readlink(f"/proc/self/fd/{fd}"):
                out.append(fd)
        except OSError:
            pass
    return out


def test_workers_start_without_torch():
    """What a worker imports (the package and this module) loads numpy but
    not torch, so starting the pool costs no torch import."""
    code = ("import sys; from event_representation_study_tpu_torch.data import nimagenet; "
            "print(sorted(m for m in ('numpy', 'torch') if m in sys.modules))")
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=str(pathlib.Path(__file__).parents[1]))
    assert done.returncode == 0, done.stderr
    assert done.stdout.split() == ["['numpy']"]


def test_pool_exits_clean_with_its_process(files):
    """A process that took the pool and exits without stopping it leaves
    no worker process behind and no resource warning."""
    code = textwrap.dedent(f"""
        import sys
        from event_representation_study_tpu_torch.data import nimagenet
        def main():
            nimagenet.pool_width = lambda: 2
            ds = nimagenet.NImageNetDataset({files[0]!r}, {files[1]!r}, slice_length={SLICE})
            ds.batch([0, 1, 2, 3])
            print(" ".join(str(p.pid) for p in nimagenet._POOL.procs))
        if __name__ == "__main__":
            main()
    """)
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=str(pathlib.Path(__file__).parents[1]))
    assert done.returncode == 0, done.stderr
    pids = [int(p) for p in done.stdout.split()]
    assert len(pids) == 2 and done.stderr == ""
    for pid in pids:
        assert not pathlib.Path(f"/proc/{pid}").exists()


def test_shutdown_leaves_no_process_or_segment(files, monkeypatch):
    """After ``shutdown_pool`` no worker lives and the shared buffer is
    closed; the next engaged batch starts a new pool. (Last in the file:
    it stops the pool the tests above share.)"""
    monkeypatch.setattr(nimagenet, "pool_width", lambda: 2)
    ds = nimagenet.NImageNetDataset(*files, slice_length=SLICE, seed=4)
    ds.batch([0, 1, 2, 3])
    procs = list(nimagenet._POOL.procs)
    assert _memfds()
    nimagenet.shutdown_pool()
    assert nimagenet._POOL is None and not _memfds()
    assert all(not p.is_alive() and p.exitcode == 0 for p in procs)
