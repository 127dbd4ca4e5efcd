"""Blosc-ZSTD HDF5 support without ``hdf5plugin`` (a copy of the JAX
package's ``events/blosc_codec.py``: NumPy, ctypes and h5py only).

The published Gen1 split files and the Gen4 consolidation are written with
the registered Blosc HDF5 filter (id 32001) configured for ZSTD + bit-shuffle
(ev-YOLOv6/yolov6/data/gen4/precompute_reps.py:31-48,
ev-licious/src/evlicious/io/utils/h5_writer.py:8-28:
``compression_opts=(0, 0, 0, 0, clevel=1, shuffle=2, compressor=5)``).
Without ``hdf5plugin`` or the python ``blosc``/``zstandard`` packages a
stock ``h5py`` read raises on every chunk.  This module makes
those files readable and writable anyway, through three layers:

1. ctypes bindings to the system ``libblosc`` (where installed) —
   ``blosc_compress_ctx``/``blosc_decompress_ctx`` handle the full frame
   including the codec and the (bit-)shuffle;
2. a pure-Python frame codec over ``libzstd``/stdlib ``zlib`` plus a NumPy
   bit/byte-unshuffle, used when ``libblosc`` itself is absent.  The Blosc1
   frame layout implemented here was verified against libblosc 1.21.3:
   16-byte header (version, versionlz, flags, typesize, u32 nbytes/blocksize/
   cbytes LE), then u32 per-block start offsets, each block a single
   ``[u32 csize][payload]`` stream (zstd/zlib are never split), stored raw
   when ``csize == block nbytes``; a block is bit-shuffled only when its
   byte-size is a multiple of ``8*typesize`` (otherwise raw), and the
   bit-shuffle layout is ``[typesize][8 bit positions][nelem/8]`` with
   little-endian bit order;
3. chunk-level HDF5 access: reading via ``read_direct_chunk`` + frame decode
   (``BloscDatasetView``), writing via ``write_direct_chunk`` of frames we
   compress ourselves (``create_blosc_dataset`` / ``BloscAppender``) under
   ``allow_unknown_filter=True`` — producing files byte-compatible with
   hdf5plugin readers (the HDF5 pipeline compresses full, fill-padded edge
   chunks, which is exactly what we emit).
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
import zlib
from typing import Optional, Tuple

import numpy as np

try:
    import h5py
except ImportError:  # no h5py: plain (unchunked) datasets through h5lite only
    from . import h5lite as h5py

BLOSC_H5_FILTER_ID = 32001
# (reserved, reserved, typesize, chunkbytes, clevel, shuffle, compressor);
# slots 0-3 are overwritten by the filter's set_local in hdf5plugin installs,
# readers only consult the frame header — mirror the reference's literal.
REFERENCE_CD_VALUES = (0, 0, 0, 0, 1, 2, 5)  # clevel 1, bit-shuffle, zstd

NOSHUFFLE, SHUFFLE, BITSHUFFLE = 0, 1, 2
_COMPCODE = {"blosclz": 0, "lz4": 1, "lz4hc": 2, "snappy": 3, "zlib": 4, "zstd": 5}
# header flags bits 5-7 carry the *format* code (zstd=4, zlib=3), not the enum
_FORMAT_TO_NAME = {0: "blosclz", 1: "lz4", 2: "snappy", 3: "zlib", 4: "zstd"}


@functools.lru_cache(maxsize=None)
def _libblosc():
    path = ctypes.util.find_library("blosc")
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:  # pragma: no cover
        return None
    lib.blosc_compress_ctx.restype = ctypes.c_int
    lib.blosc_compress_ctx.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_size_t, ctypes.c_size_t,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
    ]
    lib.blosc_decompress_ctx.restype = ctypes.c_int
    lib.blosc_decompress_ctx.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
    ]
    lib.blosc_cbuffer_sizes.restype = None
    lib.blosc_cbuffer_sizes.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_size_t),
        ctypes.POINTER(ctypes.c_size_t),
        ctypes.POINTER(ctypes.c_size_t),
    ]
    return lib


@functools.lru_cache(maxsize=None)
def _libzstd():
    path = ctypes.util.find_library("zstd")
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:  # pragma: no cover
        return None
    lib.ZSTD_decompress.restype = ctypes.c_size_t
    lib.ZSTD_decompress.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
    ]
    lib.ZSTD_compress.restype = ctypes.c_size_t
    lib.ZSTD_compress.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
        ctypes.c_int,
    ]
    lib.ZSTD_isError.restype = ctypes.c_uint
    lib.ZSTD_compressBound.restype = ctypes.c_size_t
    lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
    return lib


def available() -> bool:
    """True if this process can decode Blosc-ZSTD frames at all."""
    return _libblosc() is not None or _libzstd() is not None


# --------------------------------------------------------------------------
# frame codec
# --------------------------------------------------------------------------

def frame_sizes(frame) -> Tuple[int, int, int]:
    """(nbytes, blocksize, cbytes) from a Blosc1 frame header."""
    head = bytes(frame[:16])
    if len(head) < 16:
        raise ValueError("truncated blosc frame")
    nbytes, blocksize, cbytes = np.frombuffer(head[4:16], "<u4")
    return int(nbytes), int(blocksize), int(cbytes)


def decompress_frame(frame) -> bytes:
    """Blosc1 frame -> raw bytes (libblosc when present, else pure path)."""
    lib = _libblosc()
    if lib is not None:
        nbytes, _, _ = frame_sizes(frame)
        src = np.frombuffer(frame, np.uint8)
        dst = np.empty(max(nbytes, 1), np.uint8)
        n = lib.blosc_decompress_ctx(
            src.ctypes.data, dst.ctypes.data, nbytes, 1
        )
        if n < 0 or n != nbytes:
            raise ValueError(f"blosc_decompress_ctx failed (rc={n})")
        return dst.tobytes()[:nbytes]
    return _decompress_frame_py(frame)


def _bit_unshuffle(buf: np.ndarray, typesize: int) -> np.ndarray:
    """Inverse of blosc's per-block bitshuffle (layout verified empirically,
    see module docstring)."""
    n = len(buf) // typesize
    nb = n - n % 8
    core = buf[: nb * typesize]
    bits = np.unpackbits(
        core.reshape(typesize, 8, nb // 8), axis=-1, bitorder="little"
    )
    out = np.packbits(
        bits.transpose(2, 0, 1), axis=-1, bitorder="little"
    ).reshape(nb * typesize)
    return np.concatenate([out, buf[nb * typesize:]])


def _byte_unshuffle(buf: np.ndarray, typesize: int) -> np.ndarray:
    n = len(buf) // typesize
    core = buf[: n * typesize].reshape(typesize, n).T.reshape(-1)
    return np.concatenate([core, buf[n * typesize:]])


def _decompress_frame_py(frame) -> bytes:
    frame = bytes(frame)
    flags, typesize = frame[2], frame[3]
    nbytes, blocksize, cbytes = frame_sizes(frame)
    if flags & 0x2:  # memcpyed: raw original buffer follows the header
        return frame[16:16 + nbytes]
    codec = _FORMAT_TO_NAME.get(flags >> 5, "?")
    if codec not in ("zstd", "zlib"):
        raise ValueError(
            f"pure-python blosc fallback supports zstd/zlib frames, got {codec}"
        )
    zstd = _libzstd()
    if codec == "zstd" and zstd is None:
        raise ValueError("libzstd not found and frame codec is zstd")
    nblocks = (nbytes + blocksize - 1) // blocksize
    bstarts = np.frombuffer(frame[16:16 + 4 * nblocks], "<u4")
    out = np.empty(nbytes, np.uint8)
    pos = 0
    for j in range(nblocks):
        neblock = min(blocksize, nbytes - j * blocksize)
        off = int(bstarts[j])
        csize = int(np.frombuffer(frame[off:off + 4], "<u4")[0])
        payload = frame[off + 4: off + 4 + csize]
        if csize == neblock:  # uncompressible block stored raw (post-shuffle)
            dec = np.frombuffer(payload, np.uint8)
        elif codec == "zlib":
            dec = np.frombuffer(zlib.decompress(payload), np.uint8)
        else:
            dec = np.empty(neblock, np.uint8)
            r = zstd.ZSTD_decompress(
                dec.ctypes.data, neblock, payload, csize
            )
            if zstd.ZSTD_isError(r) or r != neblock:
                raise ValueError(f"zstd block decode failed (rc={r})")
        # a block is shuffled only when its size is a whole number of
        # 8*typesize groups (libblosc 1.21 stores others raw)
        if neblock % (8 * typesize) == 0:
            if flags & 0x4:
                dec = _bit_unshuffle(dec, typesize)
            elif flags & 0x1:
                dec = _byte_unshuffle(dec, typesize)
        out[pos:pos + neblock] = dec
        pos += neblock
    return out.tobytes()


def compress_frame(
    data, typesize: int, clevel: int = 1, shuffle: int = BITSHUFFLE,
    cname: str = "zstd",
) -> bytes:
    """Raw bytes -> Blosc1 frame (libblosc; pure zstd single-block fallback)."""
    data = bytes(data)
    lib = _libblosc()
    if lib is not None:
        src = np.frombuffer(data, np.uint8)
        dst = np.empty(len(data) + (1 << 17), np.uint8)
        n = lib.blosc_compress_ctx(
            clevel, shuffle, typesize, len(data),
            src.ctypes.data if len(data) else None,
            dst.ctypes.data, len(dst), cname.encode(), 0, 1,
        )
        if n <= 0:
            raise ValueError(f"blosc_compress_ctx failed (rc={n})")
        return dst.tobytes()[:n]
    return _compress_frame_py(data, typesize, clevel, cname)


def _bit_shuffle(buf: np.ndarray, typesize: int) -> np.ndarray:
    n = len(buf) // typesize
    nb = n - n % 8
    core = buf[: nb * typesize].reshape(nb, typesize)
    bits = np.unpackbits(core[:, :, None], axis=-1, bitorder="little")
    out = np.packbits(
        bits.transpose(1, 2, 0), axis=-1, bitorder="little"
    ).reshape(nb * typesize)
    return np.concatenate([out, buf[nb * typesize:]])


def _compress_frame_py(data: bytes, typesize: int, clevel: int, cname: str) -> bytes:
    """Single-block frame writer for the no-libblosc case: bit-shuffle +
    one zstd (or zlib) stream, raw-memcpy frame when incompressible."""
    nbytes = len(data)
    buf = np.frombuffer(data, np.uint8)
    shuffled = (
        _bit_shuffle(buf, typesize) if nbytes % (8 * typesize) == 0 else buf
    )
    if cname == "zlib":
        payload = zlib.compress(shuffled.tobytes(), clevel)
        fmt = 3
    else:
        zstd = _libzstd()
        if zstd is None:
            raise ValueError("libzstd not found; cannot write zstd frames")
        bound = zstd.ZSTD_compressBound(nbytes)
        dst = np.empty(bound, np.uint8)
        r = zstd.ZSTD_compress(
            dst.ctypes.data, bound,
            shuffled.ctypes.data if nbytes else None, nbytes, max(clevel, 1),
        )
        if zstd.ZSTD_isError(r):
            raise ValueError("zstd compress failed")
        payload = dst.tobytes()[:int(r)]
        fmt = 4
    # 0x10: set in every libblosc-1.21 frame and required by its decoder
    # (verified empirically — frames differing only in this bit are rejected)
    flags = 0x4 | 0x10 | (fmt << 5)  # bitshuffle + codec format
    if len(payload) + 24 >= nbytes:  # store memcpyed (original, unshuffled)
        header = bytes([2, 1, 0x2 | 0x10 | (fmt << 5), typesize & 0xFF]) + np.asarray(
            [nbytes, nbytes, nbytes + 16], "<u4"
        ).tobytes()
        return header + data
    cbytes = 16 + 4 + 4 + len(payload)
    header = bytes([2, 1, flags, typesize & 0xFF]) + np.asarray(
        [nbytes, nbytes, cbytes], "<u4"
    ).tobytes()
    return (
        header
        + np.asarray([20], "<u4").tobytes()          # single bstart (16+4)
        + np.asarray([len(payload)], "<u4").tobytes()  # stream csize
        + payload
    )


# --------------------------------------------------------------------------
# HDF5 chunk-level access
# --------------------------------------------------------------------------

def dataset_uses_blosc(dset) -> bool:
    try:
        plist = dset.id.get_create_plist()
        for i in range(plist.get_nfilters()):
            if plist.get_filter(i)[0] == BLOSC_H5_FILTER_ID:
                return True
    except Exception:  # pragma: no cover
        return False
    return False


def h5py_can_decode_blosc() -> bool:
    """True when a registered HDF5 blosc plugin (hdf5plugin) is importable —
    then native h5py reads work and no wrapping is needed."""
    try:
        import hdf5plugin  # noqa: F401

        return True
    except ImportError:
        return False


class BloscDatasetView:
    """Read-only view over a Blosc-compressed HDF5 dataset, decoding chunks
    manually via ``read_direct_chunk`` (the chunk payload is a plain Blosc1
    frame).  Supports int/slice/tuple indexing plus ``__array__`` so NumPy
    consumers (``np.searchsorted`` over ``events/t`` etc.) work unchanged."""

    def __init__(self, dset, cache_chunks: int = 8):
        self._d = dset
        self.shape = tuple(dset.shape)
        self.dtype = dset.dtype
        self.chunks = tuple(dset.chunks) if dset.chunks else self.shape
        self._cache = {}
        self._cache_order = []
        self._cache_cap = cache_chunks

    def __len__(self):
        return self.shape[0] if self.shape else 0

    @property
    def name(self):
        return self._d.name

    def _chunk(self, offset: Tuple[int, ...]) -> np.ndarray:
        got = self._cache.get(offset)
        if got is not None:
            return got
        from h5py._objects import phil

        try:
            # the low-level call does not take h5py's global lock itself:
            # without it, two threads reading chunks crash inside HDF5
            with phil:
                _, raw = self._d.id.read_direct_chunk(offset)
        except Exception:
            # unallocated chunk -> fill value (zeros)
            arr = np.zeros(self.chunks, self.dtype)
        else:
            buf = decompress_frame(raw)
            arr = np.frombuffer(buf, self.dtype)[: int(np.prod(self.chunks))]
            arr = arr.reshape(self.chunks)
        if len(self._cache_order) >= self._cache_cap:
            self._cache.pop(self._cache_order.pop(0), None)
        self._cache[offset] = arr
        self._cache_order.append(offset)
        return arr

    def _read_all(self) -> np.ndarray:
        out = np.zeros(self.shape, self.dtype)
        if int(np.prod(self.shape)) == 0:
            return out
        grids = [range(0, s, c) for s, c in zip(self.shape, self.chunks)]
        import itertools

        for offset in itertools.product(*grids):
            sel = tuple(
                slice(o, min(o + c, s))
                for o, c, s in zip(offset, self.chunks, self.shape)
            )
            valid = tuple(slice(0, sl.stop - sl.start) for sl in sel)
            out[sel] = self._chunk(offset)[valid]
        return out

    def __array__(self, dtype=None, copy=None):
        arr = self._read_all()
        return arr.astype(dtype) if dtype is not None else arr

    def __getitem__(self, key):
        if key is Ellipsis or (isinstance(key, tuple) and key == ()):
            arr = self._read_all()
            return arr if arr.shape else arr[()]
        if not isinstance(key, tuple):
            key = (key,)
        # normalize: ints and slices over the leading axes
        sels = []
        squeeze = []
        for ax, k in enumerate(key):
            if isinstance(k, (int, np.integer)):
                k = int(k)
                if k < 0:
                    k += self.shape[ax]
                sels.append(slice(k, k + 1))
                squeeze.append(ax)
            elif isinstance(k, slice):
                start, stop, step = k.indices(self.shape[ax])
                if step != 1:
                    # stepped/negative-step slices: the chunk-copy path below
                    # assumes unit stride, so match h5py semantics via a full
                    # read (correct, if not chunk-minimal)
                    return self._read_all()[key]
                sels.append(slice(start, stop))
            else:
                # fancy indexing: fall back to full read
                return self._read_all()[key]
        for ax in range(len(sels), len(self.shape)):
            sels.append(slice(0, self.shape[ax]))
        out_shape = [max(0, s.stop - s.start) for s in sels]
        out = np.zeros(out_shape, self.dtype)
        if int(np.prod(out_shape)) > 0:
            grids = [
                range(
                    (s.start // c) * c,
                    s.stop if s.stop > s.start else s.start,
                    c,
                )
                for s, c in zip(sels, self.chunks)
            ]
            import itertools

            for offset in itertools.product(*grids):
                chunk = self._chunk(offset)
                src, dst = [], []
                for o, c, s, full in zip(offset, self.chunks, sels, self.shape):
                    lo = max(s.start, o)
                    hi = min(s.stop, o + c, full)
                    src.append(slice(lo - o, hi - o))
                    dst.append(slice(lo - s.start, hi - s.start))
                out[tuple(dst)] = chunk[tuple(src)]
        for ax in reversed(squeeze):
            out = np.squeeze(out, axis=ax)
        return out


def wrap_dataset(dset):
    """Return ``dset`` when natively readable, a ``BloscDatasetView`` when it
    uses filter 32001 and no HDF5 plugin is registered."""
    if not isinstance(dset, h5py.Dataset):
        return dset
    if dataset_uses_blosc(dset) and not h5py_can_decode_blosc():
        if not available():
            raise RuntimeError(
                "dataset uses Blosc (HDF5 filter 32001) but neither "
                "hdf5plugin nor libblosc/libzstd are available"
            )
        return BloscDatasetView(dset)
    return dset


class H5Group:
    """Thin group proxy that wraps Blosc datasets on access; mirrors the
    h5py mapping surface our readers use (keys/contains/getitem)."""

    def __init__(self, group):
        self._g = group

    def __getitem__(self, key):
        obj = self._g[key]
        if isinstance(obj, h5py.Group):
            return H5Group(obj)
        return wrap_dataset(obj)

    def __contains__(self, key):
        return key in self._g

    def keys(self):
        return self._g.keys()

    def __iter__(self):
        return iter(self._g)

    def __len__(self):
        return len(self._g)

    @property
    def attrs(self):
        return self._g.attrs

    @property
    def name(self):
        return self._g.name

    def close(self):
        self._g.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def open_h5(path, mode: str = "r"):
    """``h5py.File`` opener that transparently decodes Blosc datasets when no
    HDF5 plugin is registered.  Drop-in for read paths."""
    f = h5py.File(path, mode)
    if mode == "r" and not h5py_can_decode_blosc():
        return H5Group(f)
    return f


# --------------------------------------------------------------------------
# writing
# --------------------------------------------------------------------------

def _cd_values(typesize: int, chunk_nbytes: int, clevel: int, shuffle: int,
               compcode: int) -> Tuple[int, ...]:
    # same 7-slot layout the registered filter writes (revision, blosc
    # version, typesize, chunk bytes, clevel, shuffle, compressor)
    return (2, 2, typesize, chunk_nbytes, clevel, shuffle, compcode)


def create_blosc_dataset(
    group, name: str, shape, dtype, chunks=None, maxshape=None,
    clevel: int = 1, shuffle: int = BITSHUFFLE, cname: str = "zstd",
):
    """Create a filter-32001 dataset writable via ``write_blosc`` /
    ``BloscAppender`` without hdf5plugin (uses ``allow_unknown_filter``).
    Uses the reference's codec configuration by default
    (precompute_reps.py:31-48: zstd, bit-shuffle, clevel 1)."""
    if not hasattr(group, "create_dataset"):
        raise NotImplementedError("Blosc-compressed datasets need h5py (not installed)")
    dtype = np.dtype(dtype)
    shape = tuple(shape)
    if chunks is None:
        chunks = tuple(min(s, 1 << 14) if i == 0 else s
                       for i, s in enumerate(shape)) or (1,)
        chunks = tuple(max(c, 1) for c in chunks)
    chunk_nbytes = int(np.prod(chunks)) * dtype.itemsize
    return group.create_dataset(
        name, shape=shape, dtype=dtype, chunks=chunks, maxshape=maxshape,
        compression=BLOSC_H5_FILTER_ID,
        compression_opts=_cd_values(
            dtype.itemsize, chunk_nbytes, clevel, shuffle, _COMPCODE[cname]
        ),
        allow_unknown_filter=True,
    )


def write_blosc(dset, data, clevel: int = 1, shuffle: int = BITSHUFFLE,
                cname: str = "zstd"):
    """Write a full array into a filter-32001 dataset chunk by chunk."""
    data = np.ascontiguousarray(data, dset.dtype)
    assert data.shape == tuple(dset.shape), (data.shape, dset.shape)
    chunks = tuple(dset.chunks)
    import itertools

    grids = [range(0, s, c) for s, c in zip(data.shape, chunks)]
    for offset in itertools.product(*grids):
        block = np.zeros(chunks, dset.dtype)  # fill-padded full edge chunks
        sel = tuple(
            slice(o, min(o + c, s))
            for o, c, s in zip(offset, chunks, data.shape)
        )
        valid = tuple(slice(0, sl.stop - sl.start) for sl in sel)
        block[valid] = data[sel]
        frame = compress_frame(
            block.tobytes(), dset.dtype.itemsize, clevel, shuffle, cname
        )
        dset.id.write_direct_chunk(offset, frame, filter_mask=0)


class BloscAppender:
    """Incremental 1-D appender over a resizable filter-32001 dataset:
    buffers to chunk boundaries, direct-chunk-writes complete chunks, and
    flushes the fill-padded tail chunk on ``close`` (the H5Writer pattern,
    h5_writer.py:29-67)."""

    def __init__(self, group, name, dtype, chunk: int = 1 << 16,
                 clevel: int = 1, shuffle: int = BITSHUFFLE, cname: str = "zstd"):
        self.dset = create_blosc_dataset(
            group, name, shape=(0,), dtype=dtype, chunks=(chunk,),
            maxshape=(None,), clevel=clevel, shuffle=shuffle, cname=cname,
        )
        self.chunk = chunk
        self._args = (clevel, shuffle, cname)
        self._tail = np.zeros(0, dtype)
        self._written = 0  # elements durably in complete chunks

    def append(self, arr):
        arr = np.ascontiguousarray(arr, self.dset.dtype)
        self._tail = np.concatenate([self._tail, arr])
        while len(self._tail) >= self.chunk:
            block, self._tail = self._tail[: self.chunk], self._tail[self.chunk:]
            self.dset.resize((self._written + self.chunk,))
            frame = compress_frame(
                block.tobytes(), self.dset.dtype.itemsize, *self._args
            )
            self.dset.id.write_direct_chunk(
                (self._written,), frame, filter_mask=0
            )
            self._written += self.chunk

    def close(self):
        n_tail = len(self._tail)
        if n_tail:
            block = np.zeros(self.chunk, self.dset.dtype)
            block[:n_tail] = self._tail
            self.dset.resize((self._written + n_tail,))
            frame = compress_frame(
                block.tobytes(), self.dset.dtype.itemsize, *self._args
            )
            self.dset.id.write_direct_chunk(
                (self._written,), frame, filter_mask=0
            )
            self._written += n_tail
            self._tail = self._tail[:0]
