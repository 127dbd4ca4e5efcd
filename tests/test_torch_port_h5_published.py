"""Published-format Gen1 files without h5py: the port's ``events/h5lite.py``
reads what h5py writes by default (``libver="earliest"``: superblock v0,
version-1 object headers, symbol-table groups, chunks indexed by a v1
B-tree, Blosc filter 32001), and ``Gen1H5``, ``H5EventHandle`` and
``load_events_from_path`` read those files bit-equal to the JAX package's
h5py read. The reads without h5py run in one subprocess with
``sys.modules["h5py"] = None``, as on a host without it. Also: the port's
``events/windows.py`` and the handle's window queries against the JAX
package's at boundary timestamps and with mixed units, the committed
fixture against its script, and the refusals of what h5lite does not read.
Everything is host NumPy on both sides, so every comparison is exact."""
import json
import os
import pathlib
import subprocess
import sys

import h5py
import numpy as np
import pytest

from event_representation_study_tpu.data import gen1 as jax_gen1
from event_representation_study_tpu.events import blosc_codec as jax_blosc
from event_representation_study_tpu.events import h5_io as jax_h5_io
from event_representation_study_tpu.events import windows as jax_windows
from event_representation_study_tpu_torch.events import h5_io, h5lite, windows
from torch_port_helpers import assert_close

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests/data/gen1_blosc_seed7.h5"
GEN1_KW = dict(num_events=1500, time_window=150_000)
# (t0, t1) of get_between_time, and the window arguments of the queries
BETWEEN = [(0, 100_000), (250_000, 250_000), (123_456, 900_000)]
WINDOWS = [(3000, 3000), (2500, 4000), (7000, 2000)]
UNITS = [("nr", "nr"), ("us", "us"), ("nr", "us"), ("us", "nr")]
TIME_AND_INDEX = [(5000, 8000, "nr", "nr"), (50_000, 120_000, "us", "us"),
                  (40_000, 7000, "nr", "us"), (3000, 90_000, "us", "nr")]


def _event_file(path, t):
    """An events file written by the JAX package's ``H5Writer``: resizable
    Blosc datasets in chunks of 65,536 rows."""
    w = jax_h5_io.H5Writer(path, 240, 304)
    rng = np.random.default_rng(3)
    n = len(t)
    w.add(rng.integers(0, 304, n), rng.integers(0, 240, n), t, rng.integers(0, 2, n))
    w.close()


def _boundary_times(n: int) -> np.ndarray:
    """Sorted timestamps with runs of equal values and round values, so
    that window edges fall on events."""
    return (np.arange(n) // 3 * 50).astype(np.int64)


@pytest.fixture(scope="module")
def published(tmp_path_factory):
    """Files written here with h5py (libver earliest), and what the port
    reads from them in a process without h5py."""
    root = tmp_path_factory.mktemp("published")
    for i, split in enumerate(("training.h5", "validation.h5")):
        jax_gen1.write_gen1_fixture(root / split, num_files=2, boxes_per_file=6,
                                    events_per_file=20_000, seed=5 + i, blosc=True)
    _event_file(root / "events.h5", _boundary_times(150_000))
    spec = {"root": str(root), "fixture": str(FIXTURE), "gen1": GEN1_KW, "between": BETWEEN,
            "windows": WINDOWS, "time_and_index": TIME_AND_INDEX}
    subprocess.run([sys.executable, "-c", _WITHOUT_H5PY, json.dumps(spec)], check=True,
                   timeout=120, env={**os.environ, "PYTHONPATH": str(REPO)})
    return root, np.load(root / "out.npz")


_WITHOUT_H5PY = """
import json, sys
import numpy as np
sys.modules["h5py"] = None  # as on a host without h5py
from event_representation_study_tpu_torch.data.gen1 import Gen1H5
from event_representation_study_tpu_torch.events import blosc_codec, h5_io, h5lite
spec = json.loads(sys.argv[1])
root = spec["root"]
out = {}
for name, path in (("split", root), ("fixture", spec["fixture"])):
    for mode in ("count", "time"):
        ds = Gen1H5(path, window_mode=mode, **spec["gen1"])
        assert isinstance(ds.h5, h5lite.File)
        out[f"{name}_{mode}_events"] = np.stack([ds[i].events for i in range(len(ds))])
        out[f"{name}_{mode}_labels"] = np.stack([ds[i].labels for i in range(len(ds))])
        out[f"{name}_{mode}_num"] = np.array([ds[i].num_events for i in range(len(ds))])
ev = h5_io.load_events_from_path(root + "/events.h5")
for k in "xytp":
    out["load_" + k] = ev[k]
h = h5_io.H5EventHandle(root + "/events.h5")
out["between"] = np.concatenate([h.get_between_time(a, b)["t"] for a, b in spec["between"]])
out["index_from_time"] = np.array([h.index_from_time(t) for t in (0, 49, 50, 51, 10**9)])
out["index_windows"] = np.concatenate([h.compute_index_windows(w, s) for w, s in spec["windows"]])
out["time_windows"] = np.concatenate([h.compute_time_windows(w, s) for w, s in spec["windows"]])
for j, (step, win, su, wu) in enumerate(spec["time_and_index"]):
    (t0, t1), (i0, i1) = h.compute_time_and_index_windows(step, win, su, wu)
    out.update({f"tai{j}_t0": t0, f"tai{j}_t1": t1, f"tai{j}_i0": i0, f"tai{j}_i1": i1})
h.close()
g = h5_io.H5EventHandle(spec["fixture"], group="rec001/events")
out["group_windows"] = g.compute_time_windows(50_000, 20_000)
out["group_index_windows"] = g.compute_index_windows(5000, 3000)
out["group_between"] = g.get_between_time(200_000, 260_000)["x"]
g.close()
# a row slice decodes only the chunks it overlaps: rows 70,000..80,000 of
# 65,536-row chunks lie in chunk 1 alone
decoded = []
real = blosc_codec.decompress_frame
blosc_codec.decompress_frame = lambda frame: decoded.append(1) or real(frame)
f = h5lite.File(root + "/events.h5")
out["slice_t"] = f["events/t"][70_000:80_000]
out["slice_decodes"] = np.array(len(decoded))
assert "h5py" not in [m.split(".")[0] for m in sys.modules if sys.modules[m] is not None]
np.savez(root + "/out.npz", **out)
"""


@pytest.mark.parametrize("source", ["split", "fixture"])
@pytest.mark.parametrize("mode", ["count", "time"])
def test_gen1h5_blosc_without_h5py_like_jax(published, source, mode):
    """Windows and boxes of ``Gen1H5`` over Blosc files, read through
    h5lite, equal the JAX package's h5py read (a file with a chunk whose
    filter was skipped, and the committed fixture)."""
    root, got = published
    want = jax_gen1.Gen1H5(root if source == "split" else FIXTURE, window_mode=mode, **GEN1_KW)
    assert len(got[f"{source}_{mode}_events"]) == len(want)
    assert_close(f"{source} {mode} events", got[f"{source}_{mode}_events"],
                 np.stack([want[i].events for i in range(len(want))]), atol=0)
    assert_close(f"{source} {mode} boxes", got[f"{source}_{mode}_labels"],
                 np.stack([want[i].labels for i in range(len(want))]), atol=0)
    np.testing.assert_array_equal(got[f"{source}_{mode}_num"],
                                  [want[i].num_events for i in range(len(want))])


def test_load_events_blosc_without_h5py_like_jax(published):
    root, got = published
    want = jax_h5_io.load_events_from_path(root / "events.h5")
    for k in "xytp":
        assert got["load_" + k].dtype == want[k].dtype
        assert_close(f"load_events_from_path {k}", got["load_" + k], want[k], atol=0)


def _jax_queries(path) -> dict:
    h = jax_h5_io.H5EventHandle(path)
    out = {
        "between": np.concatenate([h.get_between_time(a, b)["t"] for a, b in BETWEEN]),
        "index_from_time": np.array([h.index_from_time(t) for t in (0, 49, 50, 51, 10**9)]),
        "index_windows": np.concatenate([h.compute_index_windows(w, s) for w, s in WINDOWS]),
        "time_windows": np.concatenate([h.compute_time_windows(w, s) for w, s in WINDOWS]),
    }
    for j, args in enumerate(TIME_AND_INDEX):
        (t0, t1), (i0, i1) = h.compute_time_and_index_windows(*args)
        out.update({f"tai{j}_t0": t0, f"tai{j}_t1": t1, f"tai{j}_i0": i0, f"tai{j}_i1": i1})
    h.close()
    return out


@pytest.mark.parametrize("reader", ["h5lite_without_h5py", "h5py"])
def test_handle_queries_like_jax(published, reader):
    """``H5EventHandle``'s time and index queries over a Blosc events file,
    through h5lite without h5py and through h5py, at timestamps that fall
    on events and with mixed units."""
    root, lite = published
    want = _jax_queries(root / "events.h5")
    if reader == "h5py":
        h = h5_io.H5EventHandle(root / "events.h5")
        got = {"between": np.concatenate([h.get_between_time(a, b)["t"] for a, b in BETWEEN]),
               "index_from_time": np.array([h.index_from_time(t)
                                            for t in (0, 49, 50, 51, 10**9)]),
               "index_windows": np.concatenate([h.compute_index_windows(w, s)
                                                for w, s in WINDOWS]),
               "time_windows": np.concatenate([h.compute_time_windows(w, s)
                                               for w, s in WINDOWS])}
        for j, args in enumerate(TIME_AND_INDEX):
            (t0, t1), (i0, i1) = h.compute_time_and_index_windows(*args)
            got.update({f"tai{j}_t0": t0, f"tai{j}_t1": t1, f"tai{j}_i0": i0, f"tai{j}_i1": i1})
        h.close()
    else:
        got = {k: lite[k] for k in want}
    for k, v in want.items():
        assert_close(f"{reader} {k}", got[k], v, atol=0)


def test_handle_over_a_gen1_recording_like_jax(published):
    """``H5EventHandle(path, group="rec001/events")`` over the committed
    Blosc fixture, without h5py: the JAX package's window functions and
    row reads on its h5py read of that recording."""
    _, got = published
    f = jax_blosc.open_h5(FIXTURE, "r")
    t, x = f["rec001/events/t"][:], f["rec001/events/x"][:]
    assert_close("recording time windows", got["group_windows"],
                 jax_windows.time_windows(t, 50_000, 20_000), atol=0)
    assert_close("recording index windows", got["group_index_windows"],
                 jax_windows.index_windows(len(t), 5000, 3000), atol=0)
    i0, i1 = jax_windows.find_index_from_timestamps([200_000, 260_000], t)
    assert i1 > i0
    assert_close("recording events between", got["group_between"], x[i0:i1], atol=0)


def test_row_slice_decodes_only_overlapping_chunks(published):
    root, got = published
    with h5py.File(root / "events.h5") as f:
        assert f["events/t"].chunks == (65536,)
    assert int(got["slice_decodes"]) == 1
    assert_close("slice", got["slice_t"], _boundary_times(150_000)[70_000:80_000], atol=0)


@pytest.mark.parametrize("step_unit,window_unit", UNITS)
def test_windows_like_jax(step_unit, window_unit):
    """``events/windows.py`` against the JAX package's: the +1e-3 boundary
    rule, the crossed units, the deduplicated i0 of the nr span."""
    t = _boundary_times(3001)
    for step, win in ((300, 450), (150, 100), (1000, 3000)):
        got = windows.time_and_index_windows(t, step, win, step_unit, window_unit)
        want = jax_windows.time_and_index_windows(t, step, win, step_unit, window_unit)
        for name, g, w in zip(("t0", "t1", "i0", "i1"), (*got[0], *got[1]), (*want[0], *want[1])):
            assert_close(f"time_and_index {name}", g, w, atol=0)
    for q in (0, 49, 50, 51, [100, 150.5, 10**6]):
        assert_close("find_index", windows.find_index_from_timestamps(q, t),
                     jax_windows.find_index_from_timestamps(q, t), atol=0)
    for n, w, s in ((3001, 500, None), (3001, 500, 200), (10, 50, 5), (0, 5, 5)):
        assert_close("index_windows", windows.index_windows(n, w, s),
                     jax_windows.index_windows(n, w, s), atol=0)
    for w, s in ((500, None), (450, 150)):
        assert_close("time_windows", windows.time_windows(t, w, s),
                     jax_windows.time_windows(t, w, s), atol=0)
    assert windows.time_windows(t[:0], 5).shape == jax_windows.time_windows(t[:0], 5).shape


def test_committed_fixture_matches_its_script(tmp_path):
    """``tests/data/gen1_blosc_seed7.h5`` holds what
    ``scripts/make_gen1_blosc_fixture.py`` writes (data, not bytes), in the
    published format: superblock v0, Blosc chunks."""
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        import make_gen1_blosc_fixture as script
    finally:
        sys.path.remove(str(REPO / "scripts"))
    fresh = script.write(tmp_path / "fresh.h5")
    names = []
    with h5py.File(FIXTURE, "r") as raw:
        assert raw.id.get_create_plist().get_version()[0] == 0
        raw.visititems(lambda n, o: names.append(n) if isinstance(o, h5py.Dataset) else None)
        assert raw["rec000/events/t"].chunks and "32001" in raw["rec000/events/t"]._filters
    a, b = jax_blosc.open_h5(FIXTURE, "r"), jax_blosc.open_h5(fresh, "r")
    assert len(names) == 28
    for n in names:
        assert a[n].dtype == b[n].dtype, n
        assert_close(f"fixture {n}", np.asarray(a[n][()]), np.asarray(b[n][()]), atol=0)


def test_h5lite_reads_earliest_layouts(tmp_path):
    """What h5py writes by default beyond the Gen1 layout: a group of 150
    links (a B-tree of several levels), header continuation blocks, chunks
    never written (zeros), a chunk stored raw with its filter marked
    skipped in the chunk's mask (the JAX package's chunk reader ignores the
    mask, so the source array is the reference), N-d chunks with edges,
    300 chunks of one dataset, a filter pipeline message of version 2
    (libver v108)."""
    rng = np.random.default_rng(0)
    data = {}
    for libver in ("earliest", "v108"):
        path = tmp_path / f"{libver}.h5"
        with h5py.File(path, "w", libver=libver) as f:
            for i in range(150 if libver == "earliest" else 6):
                f[f"many/d{i:03d}"] = np.arange(i, dtype=np.int32)
            big = rng.integers(0, 1 << 40, 300_000)
            jax_blosc.write_blosc(jax_blosc.create_blosc_dataset(
                f, "a/big", big.shape, big.dtype, chunks=(1000,)), big)
            skip = rng.integers(0, 100, 5000).astype(np.uint16)
            ds = jax_blosc.create_blosc_dataset(f, "a/skip", skip.shape, skip.dtype,
                                                chunks=(2048,))
            jax_blosc.write_blosc(ds, skip)
            raw = np.zeros(2048, np.uint16)
            raw[:5000 - 4096] = skip[4096:]
            ds.id.write_direct_chunk((4096,), raw.tobytes(), filter_mask=1)
            assert ds.id.get_chunk_info_by_coord((4096,)).filter_mask == 1
            holes = f.create_dataset("a/holes", shape=(100,), dtype=np.float32, chunks=(10,))
            holes[20:30] = np.arange(10, dtype=np.float32)
            m = rng.random((37, 5, 3)).astype(np.float32)
            f.create_dataset("a/nd", data=m, chunks=(8, 2, 3))
            jax_blosc.write_blosc(jax_blosc.create_blosc_dataset(
                f, "b/ndb", m.shape, m.dtype, chunks=(8, 5, 3)), m)
            cont = f.create_dataset("b/cont", data=np.arange(10.0), chunks=(4,))
            f["b/after"] = np.arange(3)
            for i in range(30):  # the header outgrows its block: continuations
                cont.attrs[f"attribute_{i}"] = np.arange(40)
        hole = np.zeros(100, np.float32)
        hole[20:30] = np.arange(10)
        data[path] = {"a/big": big, "a/skip": skip, "a/holes": hole, "a/nd": m, "b/ndb": m,
                      "b/cont": np.arange(10.0), "b/after": np.arange(3),
                      "many/d005": np.arange(5, dtype=np.int32)}
    for path, want in data.items():
        f = h5lite.File(path)
        assert len(f["many"]) == (150 if path.stem == "earliest" else 6)
        for k, v in want.items():
            assert f[k].dtype == v.dtype and f[k].shape == v.shape, k
            assert_close(f"{path.stem} {k}", f[k][()], v, atol=0)
            assert_close(f"{path.stem} {k} rows", f[k][len(v) // 3:len(v) // 2],
                         v[len(v) // 3:len(v) // 2], atol=0)
        f.close()


def test_h5lite_refusals_name_what_is_missing(tmp_path):
    """Chunk indexes of data layout version 4 (libver latest) and filters
    other than Blosc and deflate raise, naming the layout and the filter id
    (here h5py's LZF, filter 32000); h5lite writes no other filter either."""
    with h5py.File(tmp_path / "latest.h5", "w", libver="latest") as f:
        f.create_dataset("chunked", data=np.arange(100), chunks=(10,))
        f.create_dataset("contiguous", data=np.arange(100))
    with h5py.File(tmp_path / "lzf.h5", "w") as f:
        f.create_dataset("lzf", data=np.arange(100), chunks=(10,), compression="lzf")
    f = h5lite.File(tmp_path / "latest.h5")
    np.testing.assert_array_equal(f["contiguous"][()], np.arange(100))
    with pytest.raises(NotImplementedError, match="data layout version 4 with a fixed array"):
        f["chunked"]
    f.close()
    with pytest.raises(NotImplementedError, match="HDF5 filter 32000 "):
        h5lite.File(tmp_path / "lzf.h5")["lzf"]
    with h5lite.File(tmp_path / "w.h5", "w") as f, \
            pytest.raises(NotImplementedError, match="compression 'lzf'"):
        f.create_dataset("lzf", data=np.arange(100), compression="lzf")
