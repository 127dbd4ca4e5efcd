"""1 Mpx (Gen4) data in both packages, host NumPy on both sides (every
comparison exact unless stated): the box rules (frame crop with the
reference's ``y <= height``, the 60-px diagonal and 20-px sides),
``Gen4RawDataset`` (windows from per-recording npz, ``t`` from 0) and its
recording boundaries, ``random_continuous_indices`` and a loader that takes
it as its ``index_sampler``, ``consolidate_npz`` read back as
``Gen4Dataset`` where the port wrote without h5py (``events/h5lite.py``),
the RED-style ``gen4_legacy`` reader on its fixture, and
``cli/precompute_reps.py`` on the CPU against the JAX package's (the
representation within 2e-4 relative plus 2e-4 of the 0..255 scale, as the
ERGO-12 parity tests hold it; labels exact)."""
import numpy as np
import pytest

from event_representation_study_tpu.cli import precompute_reps as jax_precompute
from event_representation_study_tpu.data import gen4 as jax_gen4
from event_representation_study_tpu.data import gen4_legacy as jax_legacy
from event_representation_study_tpu.data.loader import EventBatchLoader as JaxLoader
from event_representation_study_tpu_torch.cli import precompute_reps
from event_representation_study_tpu_torch.data import gen4, gen4_legacy
from event_representation_study_tpu_torch.data.loader import EventBatchLoader
from event_representation_study_tpu_torch.events import blosc_codec, h5lite
from torch_port_helpers import assert_close

NE = 3000


@pytest.fixture(scope="module")
def recordings(tmp_path_factory):
    root = tmp_path_factory.mktemp("gen4_npz")
    return gen4.write_gen4_npz_fixture(root, num_recordings=3, n_events=12_000, seed=21)


def _sample_equal(what, a, b):
    assert (a.num_events, a.num_labels, a.index, a.height, a.width) == (
        b.num_events, b.num_labels, b.index, b.height, b.width), what
    assert_close(f"{what} events", a.events, b.events, atol=0)
    assert_close(f"{what} labels", a.labels, b.labels, atol=0)


def test_box_rules_like_jax():
    rng = np.random.default_rng(0)
    boxes = np.stack([rng.integers(0, 10**6, 400), rng.uniform(-300, 1400, 400),
                      rng.uniform(-300, 800, 400), rng.uniform(1, 1400, 400),
                      rng.uniform(1, 400, 400), rng.integers(0, 4, 400)], 1)
    boxes[:5, 2], boxes[:5, 4] = 720.0, 10.0  # on the bottom edge: kept by y <= height
    got = gen4.crop_to_frame(boxes, 720, 1280)
    assert_close("crop_to_frame", got, jax_gen4.crop_to_frame(boxes, 720, 1280), atol=0)
    assert_close("filter_boxes", gen4.filter_boxes(got), jax_gen4.filter_boxes(got), atol=0)
    assert 0 < len(gen4.filter_boxes(got)) < len(got) < len(boxes)


def test_raw_dataset_like_jax(recordings):
    ds = gen4.Gen4RawDataset(recordings, num_events=NE)
    jds = jax_gen4.Gen4RawDataset(recordings, num_events=NE)
    assert len(ds) == len(jds) > 6 and ds.classes == jds.classes
    assert ds.recording_boundaries() == jds.recording_boundaries() != []
    for i in range(len(ds)):
        a = ds[i]
        _sample_equal(f"raw window {i}", a, jds[i])
        assert a.events[2, 0] == 0 and a.height == 720 and a.width == 1280


@pytest.mark.parametrize("data_len,num,exclude", [(40, 2, [7, 20]), (41, 4, [0, 13, 14, 40]),
                                                  (9, 3, [])])
def test_random_continuous_indices_like_jax(data_len, num, exclude):
    got = gen4.random_continuous_indices(data_len, num, exclude, np.random.default_rng(5))
    want = jax_gen4.random_continuous_indices(data_len, num, exclude, np.random.default_rng(5))
    assert_close("indices", got, want, atol=0)
    assert got.dtype == want.dtype and not set(exclude) & set(got.tolist())


def test_loader_index_sampler_like_jax(recordings):
    """A loader over ``Gen4RawDataset`` drawing temporally continuous pairs:
    the same batches, two epochs, as the JAX package's loader."""
    ds = gen4.Gen4RawDataset(recordings, num_events=NE)
    jds = jax_gen4.Gen4RawDataset(recordings, num_events=NE)

    def sampler(dataset):
        return lambda epoch: gen4.random_continuous_indices(
            len(dataset), 2, dataset.recording_boundaries(), np.random.default_rng(epoch))

    loaders = [cls(d, 4, img_size=128, index_sampler=sampler(d))
               for cls, d in ((EventBatchLoader, ds), (JaxLoader, jds))]
    for epoch in range(2):
        batches = [list(ld) for ld in loaders]  # one loader at a time
        assert len(batches[0]) == len(batches[1]) > 0
        for (b, idx), (jb, jidx) in zip(*batches):
            assert_close(f"epoch {epoch} indices", idx, jidx, atol=0)
            assert_close(f"epoch {epoch} events", np.asarray(b.events.x), np.asarray(jb.events.x),
                         atol=0)
            assert_close(f"epoch {epoch} boxes", b.gt_bboxes, np.asarray(jb.gt_bboxes), atol=0)
            assert all(idx[k + 1] == idx[k] + 1 for k in range(0, len(idx), 2))


def test_consolidated_without_h5py_reads_like_jax(recordings, tmp_path, monkeypatch):
    """The port's consolidation through h5lite (h5py swapped out of the
    port's modules) against the JAX package's through h5py, both read as
    ``Gen4Dataset`` by both packages."""
    monkeypatch.setattr(gen4, "h5py", h5lite)
    monkeypatch.setattr(blosc_codec, "h5py", h5lite)
    gen4.consolidate_npz(recordings, tmp_path / "port.h5")
    jax_gen4.consolidate_npz(recordings, tmp_path / "jax.h5")
    f = h5lite.File(tmp_path / "port.h5")
    assert f["rec00000/events/t"].filter_ids == (h5lite.BLOSC_FILTER_ID,)
    f.close()
    ds = gen4.Gen4Dataset(tmp_path / "port.h5", num_events=NE)
    assert isinstance(ds.h5, h5lite.File) and ds.classes == list(gen4.GEN4_CLASSES)
    for jds in (jax_gen4.Gen4Dataset(tmp_path / "jax.h5", num_events=NE),
                jax_gen4.Gen4Dataset(tmp_path / "port.h5", num_events=NE)):
        assert len(ds) == len(jds) > 0
        for i in range(len(ds)):
            _sample_equal(f"Gen4Dataset window {i}", ds[i], jds[i])


def test_legacy_reader_like_jax(tmp_path):
    root = gen4_legacy.write_legacy_fixture(tmp_path / "port", num_files=2, windows_per_file=3,
                                            n_events=2000, seed=3)
    jroot = jax_legacy.write_legacy_fixture(tmp_path / "jax", num_files=2, windows_per_file=3,
                                            n_events=2000, seed=3)
    for a, b in zip(sorted(root.rglob("*.npz")), sorted(jroot.rglob("*.npz"))):
        za, zb = np.load(a), np.load(b)
        assert sorted(za) == sorted(zb) and all(np.array_equal(za[k], zb[k]) for k in za)
    classes = ["pedestrian", "two wheeler", "car"]
    ds = gen4_legacy.LegacyProphesee(root, classes, capacity=4096)
    jds = jax_legacy.LegacyProphesee(root, classes, capacity=4096)
    assert len(ds) == len(jds) == 2 and ds.file_index() == jds.file_index()
    items = [ds[i] for i in range(len(ds))]
    for i, item in enumerate(items):
        for k, (x, y) in enumerate(zip(item, jds[i])):
            assert_close(f"item {i} part {k}", x, y, atol=0)
    for x, y in zip(gen4_legacy.collate_legacy(items),
                    jax_legacy.collate_legacy([jds[i] for i in range(len(jds))])):
        assert_close("collate", x, y, atol=0)


def test_precompute_reps_like_jax(tmp_path, monkeypatch):
    """Both CLIs on a consolidated 1280x720 validation split, 3 samples in
    batches of 2; the port's on the CPU, writing through h5lite."""
    files = gen4.write_gen4_npz_fixture(tmp_path / "npz", num_recordings=2, n_events=6000,
                                        seed=2)
    gen4.consolidate_npz(files, tmp_path / "validation.h5")
    args = ["--data-path", str(tmp_path), "--batch-size", "2", "--num-events", "2048",
            "--limit", "3"]
    jax_precompute.main(args + ["--output-dir", str(tmp_path / "jax")])
    monkeypatch.setattr(blosc_codec, "h5py", h5lite)
    assert precompute_reps.main(args + ["--output-dir", str(tmp_path / "port"),
                                        "--device", "cpu"]) == 3
    import h5py

    for i in range(3):
        with h5py.File(tmp_path / "port" / "reps" / f"{i}.h5") as f, \
                h5py.File(tmp_path / "jax" / "reps" / f"{i}.h5") as g:
            assert f["rep"].shape == g["rep"].shape == (720, 1280, 12)
            assert f["rep"].compression == "gzip" and f["rep"].dtype == np.float32
            assert_close(f"sample {i} representation", f["rep"][()], g["rep"][()],
                         rtol=2e-4, atol=2e-4 * 255)
        assert_close(f"sample {i} labels", np.load(tmp_path / "port" / "labels" / f"{i}.npy"),
                     np.load(tmp_path / "jax" / "labels" / f"{i}.npy"), atol=0)
    assert sorted(p.name for p in (tmp_path / "port" / "reps").iterdir()) == [
        "0.h5", "1.h5", "2.h5"]
