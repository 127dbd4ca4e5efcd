"""HDF5 files that the port writes without h5py, through ``events/h5lite.py``,
read by h5py and the JAX package's readers: Blosc (filter 32001) datasets
of 1 and 2 axes with edge chunks, one with more chunks than a B-tree leaf
holds (internal nodes), a ``BloscAppender`` fed in pieces, ``H5Writer``,
deflate (filter 1) datasets, a chunk stored with its filter skipped, the
scalar and integer dtypes of the event layout; and the 1 Mpx (Gen4)
consolidation, by its npz and its ``*_td.dat`` + ``*_bbox.npy`` routes,
against the JAX package's consolidation through h5py. The writes run in one
subprocess with ``sys.modules["h5py"] = None``, as on a host without h5py.
Everything is host NumPy on both sides, so every comparison is exact."""
import json
import os
import pathlib
import subprocess
import sys

import h5py
import numpy as np
import pytest

from event_representation_study_tpu.data import gen4 as jax_gen4
from event_representation_study_tpu.events import blosc_codec as jax_blosc
from event_representation_study_tpu.events import h5_io as jax_h5_io
from event_representation_study_tpu_torch.events import h5lite
from torch_port_helpers import assert_close

REPO = pathlib.Path(__file__).resolve().parents[1]
BLOSC, DEFLATE = 32001, 1

_WITHOUT_H5PY = """
import json, sys
import numpy as np
sys.modules["h5py"] = None  # as on a host without h5py
from event_representation_study_tpu_torch.data import gen4
from event_representation_study_tpu_torch.events import blosc_codec, h5_io, h5lite
from event_representation_study_tpu_torch.events.prophesee import write_dat
assert blosc_codec.h5py is h5lite and gen4.h5py is h5lite and blosc_codec.available()
root = json.loads(sys.argv[1])
rng = np.random.default_rng(0)
src = {
    "b1": rng.integers(0, 1 << 40, 10_007),  # int64, an edge chunk
    "b2": rng.random((37, 5, 3)).astype(np.float32),  # edge chunks on two axes
    "leaves": rng.integers(0, 60_000, 70 * 64 + 5).astype(np.uint16),  # 71 chunks
    "append": rng.integers(-1, 2, 200_003).astype(np.int8),
    "gz": rng.random((9, 40, 50)).astype(np.float64),
    "gz_rows": rng.integers(0, 1 << 20, 3_000).astype(np.int32),
    "x": rng.integers(0, 1280, 150_000).astype(np.uint16),
    "t": np.sort(rng.integers(0, 10**7, 150_000)),
    "p": rng.integers(0, 2, 150_000),
}
with h5lite.File(root + "/written.h5", "w") as f:
    g = f.create_group("blosc")
    for name, chunks in (("b1", (4096,)), ("b2", (8, 2, 3)), ("leaves", (64,))):
        ds = blosc_codec.create_blosc_dataset(g, name, src[name].shape, src[name].dtype,
                                              chunks=chunks)
        blosc_codec.write_blosc(ds, src[name])
    app = blosc_codec.BloscAppender(g, "append", np.int8, chunk=1 << 16)
    for a, b in ((0, 1), (1, 70_000), (70_000, 70_001), (70_001, 200_003)):
        app.append(src["append"][a:b])
    app.close()
    d = f.create_group("deflate")
    d.create_dataset("gz", data=src["gz"], compression="gzip")
    d.create_dataset("gz_chunked", data=src["gz"], chunks=(4, 7, 50), compression="gzip",
                     compression_opts=6)
    rows = d.create_dataset("gz_rows", shape=(0,), maxshape=(None,), dtype=np.int32,
                            chunks=(256,), compression="gzip")
    for a, b in ((0, 100), (100, 101), (101, 2_000), (2_000, 3_000)):
        rows.resize((b,))
        rows[a:b] = src["gz_rows"][a:b]
    skip = d.create_dataset("skip", shape=(10,), dtype=np.uint16, chunks=(4,),
                            compression="gzip")
    skip[()] = np.arange(10)
    skip.id.write_direct_chunk((4,), np.arange(100, 104, dtype=np.uint16).tobytes(),
                               filter_mask=1)
    s = f.create_group("scalars")
    s["height"], s["width"], s["divider"] = 720, 1280, 1
with h5_io.H5Writer(root + "/events.h5", 720, 1280) as w:
    for a, b in ((0, 3), (3, 65_536), (65_536, 150_000)):
        w.add(src["x"][a:b], src["x"][a:b] % 720, src["t"][a:b], src["p"][a:b])
np.savez(root + "/src.npz", **src)

# the 1 Mpx consolidation, both routes, and the plain fall-back without a codec
npz = gen4.write_gen4_npz_fixture(root + "/npz", num_recordings=2, n_events=9_000, seed=4)
for path in npz:  # boxes that a *_bbox.npy (float32 x, y, w, h) holds exactly
    z = dict(np.load(path))
    z["boxes"] = z["boxes"].astype(np.float32).astype(np.float64)
    np.savez(path, **z)
gen4.consolidate_npz(npz, root + "/port_npz.h5")
dats, boxes = [], []
for i, path in enumerate(npz):
    z = np.load(path)
    ev = np.zeros(len(z["x"]), dtype=[("x", "<i4"), ("y", "<i4"), ("t", "<i8"), ("p", "<i4")])
    ev["x"], ev["y"], ev["t"], ev["p"] = z["x"], z["y"], z["t"], np.where(z["p"], 1, -1)
    write_dat(root + f"/rec{i}_td.dat", ev, 720, 1280)
    gt = np.zeros(len(z["boxes"]), dtype=[("t", "<u8"), ("x", "<f4"), ("y", "<f4"),
                                          ("w", "<f4"), ("h", "<f4"), ("class_id", "<u4")])
    for k, col in zip(("t", "x", "y", "w", "h", "class_id"), z["boxes"].T):
        gt[k] = col
    np.save(root + f"/rec{i}_bbox.npy", gt)
    dats.append(root + f"/rec{i}_td.dat")
    boxes.append(root + f"/rec{i}_bbox.npy")
gen4.consolidate_recordings(dats, boxes, root + "/port_dat.h5")
blosc_codec.available = lambda: False
gen4.consolidate_npz(npz, root + "/port_plain.h5")
with h5_io.H5Writer(root + "/events_gzip.h5", 720, 1280) as w:
    for a, b in ((0, 3), (3, 65_536), (65_536, 150_000)):
        w.add(src["x"][a:b], src["x"][a:b] % 720, src["t"][a:b], src["p"][a:b])
assert "h5py" not in [m.split(".")[0] for m in sys.modules if sys.modules[m] is not None]
"""


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    root = tmp_path_factory.mktemp("h5lite_written")
    subprocess.run([sys.executable, "-c", _WITHOUT_H5PY, json.dumps(str(root))], check=True,
                   timeout=120, env={**os.environ, "PYTHONPATH": str(REPO)})
    return root, dict(np.load(root / "src.npz"))


def _filter_ids(dset) -> tuple:
    plist = dset.id.get_create_plist()
    return tuple(plist.get_filter(i)[0] for i in range(plist.get_nfilters()))


def _read_h5py(path, name):
    """A dataset read by h5py, through the JAX package's Blosc view where
    the dataset is Blosc."""
    with jax_blosc.open_h5(path) as f:
        return np.asarray(f[name]), f[name].dtype


@pytest.mark.parametrize("name,chunks", [("b1", (4096,)), ("b2", (8, 2, 3)),
                                         ("leaves", (64,)), ("append", (65536,))])
def test_blosc_datasets_read_in_h5py(written, name, chunks):
    root, src = written
    with h5py.File(root / "written.h5") as f:
        d = f[f"blosc/{name}"]
        assert d.chunks == chunks and _filter_ids(d) == (BLOSC,)
        assert d.maxshape == ((None,) if name == "append" else d.shape)
        cd = d.id.get_create_plist().get_filter(0)[2]
        assert cd == jax_blosc._cd_values(d.dtype.itemsize, int(np.prod(chunks)) * d.dtype.itemsize,
                                          1, 2, 5)
    got, dtype = _read_h5py(root / "written.h5", f"blosc/{name}")
    assert dtype == src[name].dtype
    assert_close(f"h5py reads h5lite's Blosc {name}", got, src[name], atol=0)
    f = h5lite.File(root / "written.h5")
    assert_close(f"h5lite reads its Blosc {name}", f[f"blosc/{name}"][()], src[name], atol=0)
    rows = f[f"blosc/{name}"][len(src[name]) // 3:len(src[name]) // 2]
    assert_close(f"h5lite rows of {name}", rows, src[name][len(src[name]) // 3:len(src[name]) // 2],
                 atol=0)
    f.close()


def test_btree_with_internal_nodes(written):
    """71 chunks: two leaves of a version-1 B-tree under a root of level 1;
    h5py finds each chunk by its offset."""
    root, src = written
    f = h5lite.File(root / "written.h5")
    btree = f["blosc/leaves"]._btree
    f.close()
    with open(root / "written.h5", "rb") as fh:
        fh.seek(btree)
        head = fh.read(8)
    assert head[:4] == b"TREE" and head[5] == 1 and int.from_bytes(head[6:8], "little") == 2
    with h5py.File(root / "written.h5") as h:
        d = h["blosc/leaves"]
        assert d.id.get_num_chunks() == 71
        for k in (0, 63, 64, 70):
            info = d.id.get_chunk_info(k)
            assert info.chunk_offset == (64 * k,) and info.filter_mask == 0
            _, frame = d.id.read_direct_chunk((64 * k,))
            chunk = np.frombuffer(jax_blosc.decompress_frame(frame), np.uint16)
            assert_close(f"chunk {k}", chunk[:len(src["leaves"]) - 64 * k][:64],
                         src["leaves"][64 * k:64 * k + 64], atol=0)


@pytest.mark.parametrize("name", ["gz", "gz_chunked", "gz_rows", "skip"])
def test_deflate_datasets_read_in_h5py(written, name):
    """Deflate chunks (h5py decodes them itself), rows rewritten in place,
    and a chunk stored raw with its filter marked skipped."""
    root, src = written
    want = {"gz": src["gz"], "gz_chunked": src["gz"], "gz_rows": src["gz_rows"],
            "skip": np.array([0, 1, 2, 3, 100, 101, 102, 103, 8, 9], np.uint16)}[name]
    with h5py.File(root / "written.h5") as f:
        d = f[f"deflate/{name}"]
        assert _filter_ids(d) == (DEFLATE,) and d.dtype == want.dtype
        assert_close(f"h5py reads h5lite's deflate {name}", d[()], want, atol=0)
        if name == "gz_chunked":
            assert d.chunks == (4, 7, 50) and d.compression_opts == 6
        if name == "skip":
            assert d.id.get_chunk_info_by_coord((4,)).filter_mask == 1
    f = h5lite.File(root / "written.h5")
    assert_close(f"h5lite reads its deflate {name}", f[f"deflate/{name}"][()], want, atol=0)
    f.close()


def test_scalars_keep_their_dtypes(written):
    root, _ = written
    with h5py.File(root / "written.h5") as f, h5py.File(root / "events.h5") as e:
        for g in (f["scalars"], e["events"]):
            for k, v in (("height", 720), ("width", 1280), ("divider", 1)):
                assert g[k].shape == () and g[k].dtype == np.int64 and g[k][()] == v
        for k, dtype in (("x", np.uint16), ("y", np.uint16), ("t", np.int64), ("p", np.int8)):
            assert e[f"events/{k}"].dtype == dtype and e[f"events/{k}"].maxshape == (None,)


@pytest.mark.parametrize("path,filters", [("events.h5", (BLOSC,)),
                                          ("events_gzip.h5", (DEFLATE,))])
def test_h5writer_reads_in_jax(written, path, filters):
    """``H5Writer`` through h5lite: Blosc when a codec is present, deflate
    only without one; the JAX package's handle reads both."""
    root, src = written
    with h5py.File(root / path) as f:
        assert all(_filter_ids(f[f"events/{k}"]) == filters for k in "xytp")
    h = jax_h5_io.H5EventHandle(root / path)
    assert (len(h), h.height, h.width) == (150_000, 720, 1280)
    ev = h.get_between_idx(0, len(h))
    h.close()
    assert_close("x", ev["x"], src["x"], atol=0)
    assert_close("y", ev["y"], src["x"] % 720, atol=0)
    assert_close("t", ev["t"], src["t"], atol=0)
    assert_close("p", ev["p"], np.where(src["p"] > 0, 1, -1), atol=0)


def _groups(path):
    """{recording/group/key: (array, dtype, filter ids)} of a split file."""
    out = {}
    with h5py.File(path) as raw, jax_blosc.open_h5(path) as f:
        for rec in f:
            for grp in ("events", "bbox"):
                for key in f[rec][grp]:
                    name = f"{rec}/{grp}/{key}"
                    out[name] = (np.asarray(f[name]), raw[name].dtype, _filter_ids(raw[name])
                                 if raw[name].shape else None)
    return out


@pytest.fixture(scope="module")
def jax_split(written, tmp_path_factory):
    root, _ = written
    npz = sorted(str(p) for p in (root / "npz").glob("*.npz"))
    path = tmp_path_factory.mktemp("jax_split") / "jax.h5"
    jax_gen4.consolidate_npz(npz, path)
    return _groups(path)


@pytest.mark.parametrize("route", ["port_npz", "port_dat", "port_plain"])
def test_consolidation_like_jax(written, jax_split, route):
    """Every array of every group equal to the JAX package's consolidation
    (h5py, hdf5plugin-free Blosc), with its dtype; Blosc on every event and
    box column while a codec is present (the npz and .dat routes), plain
    only without one."""
    root, _ = written
    got = _groups(root / f"{route}.h5")
    assert sorted(got) == sorted(jax_split) and len(got) == 2 * 14
    for name, (want, dtype, filters) in jax_split.items():
        g, g_dtype, g_filters = got[name]
        assert g_dtype == dtype, name
        assert_close(f"{route} {name}", g, want, atol=0)
        if route == "port_plain":
            assert g_filters in (None, ()), name
        elif want.ndim and len(want):
            assert g_filters == filters == (BLOSC,), name


def test_dat_route_equals_npz_route_in_h5lite(written):
    """The two routes read through h5lite, array by array."""
    root, _ = written
    a, b = h5lite.File(root / "port_npz.h5"), h5lite.File(root / "port_dat.h5")
    assert sorted(a.keys()) == sorted(b.keys())
    for rec in a.keys():
        for grp in ("events", "bbox"):
            for key in a[f"{rec}/{grp}"].keys():
                x, y = a[f"{rec}/{grp}/{key}"], b[f"{rec}/{grp}/{key}"]
                assert x.dtype == y.dtype and x.filter_ids == y.filter_ids
                assert_close(f"{rec}/{grp}/{key}", x[()], y[()], atol=0)
    a.close()
    b.close()
