"""Mini N-ImageNet data of the port against the JAX package on the same npz
files and seeds: the dataset's samples (reshape ``no_sample`` / ``sample`` /
``unique``, the random slice, ``base_augment``'s drops, the ``(4,
slice_length)`` int32 block) and the prebuilt host images of every original
loader type. Host NumPy on both sides: every comparison is exact. The
port's batches, assembled on a thread pool, against its samples one by one
and the JAX package's."""
import numpy as np
import pytest

from event_representation_study_tpu.data import nimagenet as jax_nim
from event_representation_study_tpu.data import nimagenet_loaders as jax_loaders
from event_representation_study_tpu_torch.data import nimagenet, nimagenet_loaders
from event_representation_study_tpu_torch.models.resnet import EventResNet
from event_representation_study_tpu_torch.train.classifier import ClassifierTrainer
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
def test_loader_types_like_jax(files, loader_type):
    """Every loader type: the representation it names (device types) or
    its host image (original aggregation functions), and its channels."""
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


@pytest.mark.parametrize("width", [1, 2, None], ids=["inline", "two", "default"])
@pytest.mark.parametrize("reshape", ["no_sample", "sample", "unique"])
@pytest.mark.parametrize("augment", [False, True], ids=["plain", "augment"])
def test_pooled_batch_like_samples(files, reshape, augment, width, monkeypatch):
    """Two batches with repeated indices, at pool widths 1 (inline), 2 and
    this machine's: bit-equal to the samples one by one (the port's and the
    JAX package's), each leaving the generator where they leave it."""
    if width is not None:
        monkeypatch.setattr(nimagenet, "pool_width", lambda: width)
    kw = dict(slice_length=SLICE, reshape_method=reshape, augment=augment, seed=4)
    pooled, serial = nimagenet.NImageNetDataset(*files, **kw), nimagenet.NImageNetDataset(*files, **kw)
    want = jax_nim.NImageNetDataset(*files, **kw)
    for indices in ([3, 0, 8, 3, 5, 5, 1, 7, 2, 6, 4, 0], [8, 8, 2, 7]):
        events, num, labels = pooled.batch(np.array(indices))
        assert (events.dtype, num.dtype, labels.dtype) == (np.int32, np.int32, np.int64)
        for ref in ([serial[i] for i in indices], [want[i] for i in indices]):
            assert_close(f"{reshape} augment={augment} width={width} batch", events,
                         np.stack([s.events for s in ref]), atol=0)
            assert num.tolist() == [s.num_events for s in ref]
            assert labels.tolist() == [s.label for s in ref]
        assert pooled.rng.bit_generator.state == serial.rng.bit_generator.state \
            == want.rng.bit_generator.state
    assert (pooled._pool is None) == (nimagenet.pool_width() == 1)


def test_worker_error_reaches_the_caller(files, tmp_path, monkeypatch):
    """A missing file fails its batch on the caller (``_batch_of``) with the
    worker's exception, before any draw; the pool then assembles the next
    batch as a fresh dataset would."""
    monkeypatch.setattr(nimagenet, "pool_width", lambda: 2)
    paths, labels = list(files[0]), files[1]
    paths[4] = str(tmp_path / "missing.npz")
    kw = dict(slice_length=SLICE, augment=True, seed=4)
    ds = nimagenet.NImageNetDataset(paths, labels, **kw)
    trainer = ClassifierTrainer(EventResNet(3, "ResNet18"), ds.representation, 3, device="cpu")
    with pytest.raises(FileNotFoundError, match="missing.npz"):
        trainer._batch_of(ds, np.array([0, 4, 8]))
    assert ds._pool is not None
    blocks, got_labels = trainer._batch_of(ds, np.array([0, 8, 1]))
    fresh = nimagenet.NImageNetDataset(paths, labels, **kw)
    want = [fresh[i] for i in (0, 8, 1)]
    assert_close("after a failed batch", blocks.x.numpy(),
                 np.stack([s.events[0] for s in want]), atol=0)
    assert blocks.num.tolist() == [s.num_events for s in want]
    assert got_labels.tolist() == [s.label for s in want]
