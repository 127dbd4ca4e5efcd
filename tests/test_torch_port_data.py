"""Gen1 data of the port against the JAX package on the same files: the
HDF5 reader (plain and Blosc-ZSTD chunks, count and time windows), the
fixture writer, ``.h5`` event-file loading, and ``EventBatchLoader``'s
batches over two epochs (events in the wire dtypes, labels, masks and
strong-augmentation plans). Everything here is host NumPy on both sides,
so every comparison is exact."""
import h5py
import numpy as np
import pytest

from event_representation_study_tpu.data import gen1 as jax_gen1
from event_representation_study_tpu.data.loader import EventBatchLoader as JaxLoader
from event_representation_study_tpu.events import blosc_codec as jax_blosc
from event_representation_study_tpu.events import h5_io as jax_h5_io
from event_representation_study_tpu_torch.data import gen1
from event_representation_study_tpu_torch.data.loader import EventBatchLoader
from event_representation_study_tpu_torch.events import h5_io
from torch_port_helpers import assert_close, small_cfg


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """{blosc: root} with training/validation splits written by the JAX
    package's write_gen1_fixture."""
    out = {}
    for blosc in (False, True):
        root = tmp_path_factory.mktemp(f"gen1_blosc{int(blosc)}")
        for i, split in enumerate(("training.h5", "validation.h5")):
            jax_gen1.write_gen1_fixture(root / split, num_files=2, boxes_per_file=6,
                                        events_per_file=6000, seed=5 + i, blosc=blosc)
        out[blosc] = root
    return out


@pytest.mark.parametrize("blosc", [False, True], ids=["plain", "blosc"])
@pytest.mark.parametrize("window", ["count", "time"])
def test_gen1h5_reads_like_jax(fixtures, blosc, window):
    kw = dict(task="train", num_events=1500, window_mode=window, time_window=150_000)
    got, want = gen1.Gen1H5(fixtures[blosc], **kw), jax_gen1.Gen1H5(fixtures[blosc], **kw)
    assert len(got) == len(want) == 12
    assert (got.height, got.width) == (want.height, want.width) == (240, 304)
    for i in range(len(want)):
        g, w = got[i], want[i]
        assert (g.num_events, g.num_labels, g.index) == (w.num_events, w.num_labels, w.index)
        assert g.events.dtype == w.events.dtype and g.labels.dtype == w.labels.dtype
        assert_close(f"events[{i}]", g.events, w.events, atol=0)
        assert_close(f"labels[{i}]", g.labels, w.labels, atol=0)
    np.testing.assert_array_equal(got.structured_events(3), want.structured_events(3))


def _datasets(path):
    """{name: (dtype, shape, chunks, filters, values)} of every dataset."""
    out = {}
    with h5py.File(path, "r") as raw:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = [obj.dtype.str, obj.shape, obj.chunks, sorted(obj._filters)]
        raw.visititems(visit)
    f = jax_blosc.open_h5(path, "r")
    for name in out:
        out[name].append(np.asarray(f[name][()]))
    f.close()
    return out


@pytest.mark.parametrize("kw", [dict(blosc=False, learnable=True), dict(blosc=True)],
                         ids=["plain_learnable", "blosc"])
def test_write_gen1_fixture_like_jax(tmp_path, kw):
    args = dict(num_files=2, boxes_per_file=5, events_per_file=5000, seed=3, **kw)
    gen1.write_gen1_fixture(tmp_path / "port.h5", **args)
    jax_gen1.write_gen1_fixture(tmp_path / "jax.h5", **args)
    got, want = _datasets(tmp_path / "port.h5"), _datasets(tmp_path / "jax.h5")
    assert sorted(got) == sorted(want) and len(want) == 2 * 14
    for name in want:
        assert got[name][:4] == want[name][:4], name
        assert_close(name, got[name][4], want[name][4], atol=0)


@pytest.mark.parametrize("writer", ["h5py_01_polarity", "blosc_writer"])
def test_load_events_h5_like_jax(tmp_path, writer):
    rng = np.random.default_rng(4)
    n = 3000
    x, y = rng.integers(0, 304, n), rng.integers(0, 240, n)
    t, p = np.sort(rng.integers(0, 10**6, n)), rng.integers(0, 2, n)
    path = tmp_path / "ev.h5"
    if writer == "blosc_writer":
        with jax_h5_io.H5Writer(path, 240, 304) as w:
            w.add(x[:1000], y[:1000], t[:1000], 2 * p[:1000] - 1)
            w.add(x[1000:], y[1000:], t[1000:], 2 * p[1000:] - 1)
    else:
        with h5py.File(path, "w") as f:
            for k, v in dict(x=x.astype(np.uint16), y=y.astype(np.uint16), t=t,
                             p=p.astype(np.int8)).items():
                f[f"events/{k}"] = v
    got, want = h5_io.load_events_from_path(path), jax_h5_io.load_events_from_path(path)
    assert got.dtype == want.dtype and len(got) == n
    for k in "xytp":
        assert_close(k, got[k], want[k], atol=0)
    h, hj = h5_io.H5EventHandle(path), jax_h5_io.H5EventHandle(path)
    assert (h.height, h.width, len(h)) == (hj.height, hj.width, len(hj))
    np.testing.assert_array_equal(h.get_between_idx(100, 200), hj.get_between_idx(100, 200))
    h.close()
    hj.close()


LOADER_CASES = {
    "flips": dict(flipud=0.5, fliplr=0.5),
    "mosaic_mixup": dict(hyp=dict(mosaic=1.0, mixup=0.5)),
    "affine_only": dict(hyp=dict(mosaic=0.0, mixup=0.0)),
    "partner_pool": dict(hyp=dict(mosaic=1.0, mixup=0.5), partner_pool=2),
}


def _batch_leaves(batch, indices):
    ev = batch.events
    out = {"x": ev.x, "y": ev.y, "t": ev.t, "p": ev.p, "num": ev.num,
           "gt_labels": batch.gt_labels, "gt_bboxes": batch.gt_bboxes,
           "gt_mask": batch.gt_mask, "indices": indices}
    if batch.aug is not None:
        out.update({f"aug.{k}": v for k, v in batch.aug._asdict().items()})
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("case", list(LOADER_CASES))
def test_loader_batches_like_jax(fixtures, case):
    kw = dict(LOADER_CASES[case])
    if "hyp" in kw:
        kw["hyp"] = dict(small_cfg()["data_aug"], **kw["hyp"])
    common = dict(img_size=64, shuffle=True, seed=3, **kw)
    got_l = EventBatchLoader(gen1.Gen1H5(fixtures[True], num_events=1024), 4, **common)
    want_l = JaxLoader(jax_gen1.Gen1H5(fixtures[True], num_events=1024), 4, **common)
    assert len(got_l) == len(want_l) == 3
    # one loader after the other: the JAX package's Blosc reader is not safe
    # to run in two threads at once
    got_b = [b for _ in range(2) for b in got_l]
    want_b = [b for _ in range(2) for b in want_l]
    assert len(got_b) == len(want_b) == 6 and got_l.epoch == want_l.epoch == 2
    for n, ((gb, gi), (wb, wi)) in enumerate(zip(got_b, want_b)):
        got, want = _batch_leaves(gb, gi), _batch_leaves(wb, wi)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert_close(f"epoch {n // 3} {k}", got[k], want[k], atol=0)
    if case in ("mosaic_mixup", "partner_pool"):
        assert gb.aug is not None and gb.events.x.shape[0] == 4 + kw.get("partner_pool", 0)
    assert gb.events.x.dtype == np.int16 and gb.events.p.dtype == np.int8


def test_loader_worker_error_reaches_the_consumer(fixtures):
    loader = EventBatchLoader(gen1.Gen1H5(fixtures[False], num_events=256), 4)

    def broken(indices):
        raise OSError("unreadable chunk")

    loader._make_batch = broken
    with pytest.raises(OSError, match="unreadable chunk"):
        next(iter(loader))


def test_two_loaders_read_blosc_at_once(fixtures):
    """Loader threads decode Blosc chunks of one file at the same time (a
    train and an eval loader may): every batch arrives intact."""
    import sys

    loaders = [EventBatchLoader(gen1.Gen1H5(fixtures[True], num_events=1024), 2, seed=s)
               for s in (0, 0, 1)]

    def one_epoch_of_each():
        its = [iter(lo) for lo in loaders]  # all worker threads run at once
        rows = [[next(it) for it in its] for _ in range(len(loaders[0]))]
        assert all(next(it, None) is None for it in its)
        return rows

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        got = [one_epoch_of_each() for _ in range(2)]
    finally:
        sys.setswitchinterval(switch)
    want = EventBatchLoader(gen1.Gen1H5(fixtures[True], num_events=1024), 2, seed=1)
    for epoch in got:
        assert len(epoch) == 6
        for (a, ia), (b, ib), _ in epoch:
            np.testing.assert_array_equal(ia, ib)
            np.testing.assert_array_equal(a.events.t, b.events.t)
        assert [list(i) for _, i in want] == [list(row[2][1]) for row in epoch]


def test_h5lite_reads_and_writes_hdf5(tmp_path):
    """``events/h5lite.py`` (the HDF5 subset used where h5py is absent):
    h5py reads what it writes, and it reads what h5py writes in the
    latest format (version-2 object headers, compact and contiguous data)."""
    from event_representation_study_tpu_torch.events import h5lite

    rng = np.random.default_rng(1)
    data = {"g/x": rng.integers(0, 300, 5000).astype(np.uint16),
            "g/t": np.sort(rng.integers(0, 10**9, 5000)), "g/p": rng.integers(-1, 2, 5000).astype(np.int8),
            "g/h": 240, "k/f": rng.random(9).astype(np.float32), "k/m": rng.random((3, 4)),
            "k/e": np.zeros(0, np.int64)}
    with h5lite.File(tmp_path / "lite.h5", "w") as f:
        groups = {"g": f.create_group("g"), "k": f.create_group("k")}
        for k, v in data.items():
            groups[k[0]][k[2:]] = v
    with h5py.File(tmp_path / "lite.h5", "r") as f:
        for k, v in data.items():
            assert f[k].dtype == np.asarray(v).dtype and f[k].shape == np.shape(v), k
            assert_close(f"h5py reads h5lite {k}", f[k][()], v, atol=0)
    with h5py.File(tmp_path / "py.h5", "w", libver="latest") as f:
        for k, v in data.items():
            f[k] = v
    for path in ("lite.h5", "py.h5"):
        f = h5lite.File(tmp_path / path, "r")
        assert sorted(f.keys()) == ["g", "k"] and "g/x" in f and "g/y" not in f
        for k, v in data.items():
            assert_close(f"h5lite reads {path} {k}", f[k][()], v, atol=0)
        assert_close("h5lite slice", f["g/x"][100:250], data["g/x"][100:250], atol=0)
        assert f["g/t"][7] == data["g/t"][7] and len(f["g/p"]) == 5000
        f.close()


_NO_H5PY = """
import sys, numpy as np
sys.modules["h5py"] = None  # as on a host without h5py
from event_representation_study_tpu_torch.data.gen1 import Gen1H5, write_gen1_fixture
from event_representation_study_tpu_torch.events import h5_io
root = sys.argv[1]
write_gen1_fixture(root + "/training.h5", num_files=2, boxes_per_file=6, events_per_file=6000,
                   seed=5)
write_gen1_fixture(root + "/blosc.h5", num_files=2, boxes_per_file=6, events_per_file=6000,
                   seed=5, blosc=True)
out = {}
ds = Gen1H5(root + "/blosc.h5", num_events=1500)
out["blosc_events"] = np.stack([ds[i].events for i in range(len(ds))])
for mode in ("count", "time"):
    ds = Gen1H5(root, num_events=1500, window_mode=mode, time_window=150_000)
    out[mode + "_events"] = np.stack([ds[i].events for i in range(len(ds))])
    out[mode + "_labels"] = np.stack([ds[i].labels for i in range(len(ds))])
ev = h5_io.load_events_from_path(root + "/ev.h5")
out["ev_t"], out["ev_p"] = ev["t"], ev["p"]
assert "h5py" not in [m.split(".")[0] for m in sys.modules if sys.modules[m] is not None]
np.savez(root + "/out.npz", **out)
"""


def test_gen1_without_h5py(tmp_path):
    """Without h5py the port writes the Gen1 fixture through h5lite (plain
    datasets, and Blosc chunks with ``blosc=True``) and reads it and event
    files back: the same windows and labels as the JAX package's reader
    (through h5py) on that file, and the same datasets as the JAX package's
    writer."""
    import os
    import subprocess
    import sys

    with h5py.File(tmp_path / "ev.h5", "w", libver="latest") as f:
        f["events/x"] = np.arange(50, dtype=np.uint16)
        f["events/y"] = np.arange(50, dtype=np.uint16)
        f["events/t"] = np.arange(50) * 10
        f["events/p"] = (np.arange(50) % 2).astype(np.int8)
    subprocess.run([sys.executable, "-c", _NO_H5PY, str(tmp_path)], check=True, timeout=120,
                   env={**os.environ, "PYTHONPATH": os.getcwd()})
    got = np.load(tmp_path / "out.npz")
    jax_gen1.write_gen1_fixture(tmp_path / "jax.h5", num_files=2, boxes_per_file=6,
                                events_per_file=6000, seed=5)
    a, b = _datasets(tmp_path / "training.h5"), _datasets(tmp_path / "jax.h5")
    assert sorted(a) == sorted(b)
    for name in b:
        assert a[name][0] == b[name][0] and a[name][1] == b[name][1], name
        assert_close(f"h5lite fixture {name}", a[name][4], b[name][4], atol=0)
    for mode in ("count", "time"):
        want = jax_gen1.Gen1H5(tmp_path, num_events=1500, window_mode=mode, time_window=150_000)
        assert_close(f"{mode} windows without h5py",
                     got[mode + "_events"], np.stack([want[i].events for i in range(len(want))]),
                     atol=0)
        assert_close(f"{mode} labels without h5py",
                     got[mode + "_labels"], np.stack([want[i].labels for i in range(len(want))]),
                     atol=0)
    assert_close("h5 events without h5py", got["ev_p"], 2 * (np.arange(50) % 2) - 1, atol=0)
    want = jax_gen1.Gen1H5(tmp_path / "blosc.h5", num_events=1500)
    assert_close("Blosc fixture written without h5py", got["blosc_events"],
                 np.stack([want[i].events for i in range(len(want))]), atol=0)
    assert_close("Blosc and plain fixtures", got["blosc_events"], got["count_events"], atol=0)
