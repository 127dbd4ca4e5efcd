"""A subset of HDF5 in pure Python and NumPy, for hosts without ``h5py``.

It writes files in the HDF5 format itself (``h5py`` and the HDF5 tools open
what it writes): superblock version 2, version-2 object headers, groups
with their links stored in the header (compact storage), and datasets of
little-endian integers or floats, scalar or N-d, stored contiguously or in
chunks. A chunked dataset is indexed by a version-1 B-tree (nodes of
2K = 64 entries, the default K of a version-2 superblock; internal nodes
once a dataset has more chunks than one leaf), may be extendable
(``maxshape`` with ``None``), and may pass through a filter: deflate
(filter 1, ``compression="gzip"``) or Blosc (filter 32001, frames from
``blosc_codec``). Chunks are written as they come, by
``ds[...] = array`` (each chunk through the pipeline) or by
``ds.id.write_direct_chunk(offsets, frame, filter_mask)`` (a frame already
filtered, as ``blosc_codec`` writes them); the metadata follows on
``close()``.

It reads what it writes, and the format that ``h5py`` writes by default
(``libver="earliest"``), in which the published Gen1 files come:
superblock version 0 or 1, version-1 object headers with continuation
blocks, symbol-table groups (a version-1 B-tree of SNOD nodes over a local
heap of names), and datasets stored contiguously, compactly or in chunks
indexed by a version-1 B-tree, unfiltered or through deflate or Blosc
(decoded by ``zlib`` and ``blosc_codec``'s frame decoder). A chunk whose
filter mask marks a filter as skipped is read without it; a chunk never
written reads as zeros (h5py's default fill value). ``ds[i0:i1]`` decodes
only the chunks that the rows overlap. What it does not cover raises,
naming what is missing: other filters, the chunk indexes of data layout
version 4 (``libver="latest"``), attributes, dense link storage.

The surface is the part of ``h5py`` that this package uses: ``File(path,
"r" | "w")``, ``Group.create_group``/``create_dataset``/``keys``/``[path]``/
``[name] = array``, ``Dataset.shape``/``dtype``/``chunks``/``[index]``/
``[()]``/``np.asarray``, and in write mode ``Dataset.resize``,
``ds[rows] = array`` and ``Dataset.id.write_direct_chunk``.

Format reference: the HDF5 File Format Specification, version 3.0
(superblocks §II.A, v1 B-trees §III.A.1, SNOD §III.B, local heaps §III.D,
object headers §IV.A.1, messages §IV.A.2).
"""
from __future__ import annotations

import itertools
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF
_SUPERBLOCK_SIZE = 48
# object header message types
_DATASPACE, _LINK_INFO, _DATATYPE, _FILL_VALUE, _LINK, _LAYOUT, _GROUP_INFO = (
    0x01, 0x02, 0x03, 0x05, 0x06, 0x08, 0x0A)
_FILTERS, _CONTINUATION, _SYMBOL_TABLE = 0x0B, 0x10, 0x11
BLOSC_FILTER_ID = 32001
DEFLATE_FILTER_ID = 1
_FILTER_NAMES = {DEFLATE_FILTER_ID: "deflate", BLOSC_FILTER_ID: "blosc"}
_BTREE_K = 32  # chunk B-tree K of a version-2 superblock: 2K entries a node
_OPTIONAL = 0x0001  # filter flag: a chunk may skip it (h5py sets it for both)
_CHUNK_INDEXES = {1: "single chunk", 2: "implicit", 3: "fixed array", 4: "extensible array",
                  5: "version-2 B-tree"}


def _rot(x: int, k: int) -> int:
    return ((x << k) | (x >> (32 - k))) & 0xFFFFFFFF


def checksum(data: bytes) -> int:
    """Jenkins' lookup3 ``hashlittle`` with initval 0, byte by byte: the
    checksum of HDF5's version-2 metadata (H5_checksum_lookup3)."""
    m = 0xFFFFFFFF
    a = b = c = (0xDEADBEEF + len(data)) & m
    k = data
    n = len(k)
    i = 0
    while n > 12:
        a = (a + int.from_bytes(k[i:i + 4], "little")) & m
        b = (b + int.from_bytes(k[i + 4:i + 8], "little")) & m
        c = (c + int.from_bytes(k[i + 8:i + 12], "little")) & m
        a = (a - c) & m; a ^= _rot(c, 4); c = (c + b) & m  # noqa: E702
        b = (b - a) & m; b ^= _rot(a, 6); a = (a + c) & m  # noqa: E702
        c = (c - b) & m; c ^= _rot(b, 8); b = (b + a) & m  # noqa: E702
        a = (a - c) & m; a ^= _rot(c, 16); c = (c + b) & m  # noqa: E702
        b = (b - a) & m; b ^= _rot(a, 19); a = (a + c) & m  # noqa: E702
        c = (c - b) & m; c ^= _rot(b, 4); b = (b + a) & m  # noqa: E702
        n -= 12
        i += 12
    if n == 0:
        return c
    tail = k[i:] + b"\0" * (12 - n)
    a = (a + int.from_bytes(tail[0:4], "little")) & m
    b = (b + int.from_bytes(tail[4:8], "little")) & m
    c = (c + int.from_bytes(tail[8:12], "little")) & m
    c ^= b; c = (c - _rot(b, 14)) & m  # noqa: E702
    a ^= c; a = (a - _rot(c, 11)) & m  # noqa: E702
    b ^= a; b = (b - _rot(a, 25)) & m  # noqa: E702
    c ^= b; c = (c - _rot(b, 16)) & m  # noqa: E702
    a ^= c; a = (a - _rot(c, 4)) & m  # noqa: E702
    b ^= a; b = (b - _rot(a, 14)) & m  # noqa: E702
    c ^= b; c = (c - _rot(b, 24)) & m  # noqa: E702
    return c


# ---------------------------------------------------------------- datatypes

def _datatype_message(dtype: np.dtype) -> bytes:
    dtype = np.dtype(dtype)
    size = dtype.itemsize
    if dtype.kind in "iu" and dtype.byteorder in "<=|":
        bits = 0x08 if dtype.kind == "i" else 0x00  # bit 3: signed
        return struct.pack("<B3sIHH", 0x10, bytes([bits, 0, 0]), size, 0, 8 * size)
    if dtype.kind == "f" and size in (4, 8) and dtype.byteorder in "<=":
        sign, exp_loc, exp_size, mant_size, bias = (
            (31, 23, 8, 23, 127) if size == 4 else (63, 52, 11, 52, 1023))
        # bits 4-5 = 2: implied leading mantissa bit; byte 1: sign location
        return struct.pack("<B3sIHHBBBBI", 0x11, bytes([0x20, sign, 0]), size, 0, 8 * size,
                           exp_loc, exp_size, 0, mant_size, bias)
    raise NotImplementedError(f"h5lite stores little-endian ints and floats, not {dtype}")


def _parse_datatype(data: bytes) -> np.dtype:
    cls = data[0] & 0x0F
    bits, size = data[1], struct.unpack_from("<I", data, 4)[0]
    if cls == 0:
        if bits & 0x01:
            raise NotImplementedError("big-endian integers")
        return np.dtype(f"<{'i' if bits & 0x08 else 'u'}{size}")
    if cls == 1 and size in (4, 8) and not bits & 0x41:
        return np.dtype(f"<f{size}")
    raise NotImplementedError(f"HDF5 datatype class {cls} (size {size}) is not in h5lite")


# ----------------------------------------------------------------- writing

def _message(mtype: int, data: bytes) -> bytes:
    return struct.pack("<BHB", mtype, len(data), 0) + data


def _object_header(messages: bytes) -> bytes:
    # flags 0x02: a 4-byte "size of chunk #0"; no times, no attribute order
    head = b"OHDR" + struct.pack("<BBI", 2, 0x02, len(messages)) + messages
    return head + struct.pack("<I", checksum(head))


def _dataspace_message(shape, maxshape=None) -> bytes:
    """Version 2; ``maxshape`` (``None`` for an unlimited axis) adds the
    maximum dimensions."""
    space = struct.pack("<BBBB", 2, len(shape), 0 if maxshape is None else 1,
                        1 if len(shape) else 0)
    space += struct.pack(f"<{len(shape)}Q", *shape)
    if maxshape is not None:
        space += struct.pack(f"<{len(shape)}Q", *(_UNDEF if m is None else m for m in maxshape))
    return space


def _filter_message(filters) -> bytes:
    """Filter pipeline message version 2 of ``filters``, (id, name, flags,
    client data values) each, in the order they are applied."""
    out = struct.pack("<BB", 2, len(filters))
    for fid, name, flags, values in filters:
        out += struct.pack("<H", fid)
        raw = name.encode() + b"\0" if fid >= 256 else b""
        if fid >= 256:  # filters of the HDF5 library itself carry no name
            out += struct.pack("<H", len(raw))
        out += struct.pack("<HH", flags, len(values)) + raw
        out += struct.pack(f"<{len(values)}I", *values)
    return out


def _chunk_btree(w: "_Writer", entries, rank: int, itemsize: int) -> int:
    """Write the version-1 B-tree (type 1) over ``entries``, (offsets, stored
    size, filter mask, address) of each chunk in offset order, and return
    its root's address. A key is the size, the mask and an 8-byte offset per
    axis plus one (the element axis, 0); the last key of the tree holds the
    last chunk's offsets with the element axis at ``itemsize``, as the HDF5
    library writes it. Nodes hold at most 2K entries and are written at
    their full size, which readers read whole."""
    if not entries:
        return _UNDEF
    key_size = 8 + 8 * (rank + 1)
    node_size = 24 + 2 * _BTREE_K * (key_size + 8) + key_size

    def key(offsets, size, mask, last=0):
        return struct.pack(f"<II{rank + 1}Q", size, mask, *offsets, last)

    final = key(entries[-1][0], 0, 0, itemsize)
    nodes = [(key(offsets, size, mask), addr) for offsets, size, mask, addr in entries]
    level = 0
    while True:
        groups = [nodes[i:i + 2 * _BTREE_K] for i in range(0, len(nodes), 2 * _BTREE_K)]
        base = w.pos
        for g, children in enumerate(groups):
            left = base + (g - 1) * node_size if g else _UNDEF
            right = base + (g + 1) * node_size if g + 1 < len(groups) else _UNDEF
            blob = b"TREE" + struct.pack("<BBHQQ", 1, level, len(children), left, right)
            blob += b"".join(k + struct.pack("<Q", child) for k, child in children)
            blob += groups[g + 1][0][0] if g + 1 < len(groups) else final
            w.put(blob + b"\0" * (node_size - len(blob)))
        if len(groups) == 1:
            return base
        nodes = [(children[0][0], base + g * node_size) for g, children in enumerate(groups)]
        level += 1


class _Writer:
    def __init__(self, f):
        self.f = f
        self.pos = _SUPERBLOCK_SIZE
        f.write(b"\0" * _SUPERBLOCK_SIZE)

    def put(self, blob: bytes) -> int:
        addr = self.pos
        self.f.seek(addr)  # a chunk read back in between may have moved it
        self.f.write(blob)
        self.pos += len(blob)
        return addr

    def dataset(self, arr: np.ndarray) -> int:
        arr = np.asarray(arr, order="C")  # keeps 0-d arrays 0-d
        raw = arr.tobytes()
        data_addr = self.put(raw) if raw else _UNDEF
        msgs = (_message(_DATASPACE, _dataspace_message(arr.shape))
                + _message(_DATATYPE, _datatype_message(arr.dtype))
                # fill value v3: late allocation, written if set, none set
                + _message(_FILL_VALUE, bytes([3, 0x02 | (2 << 2)]))
                + _message(_LAYOUT, struct.pack("<BBQQ", 3, 1, data_addr, len(raw))))
        return self.put(_object_header(msgs))

    def group(self, children: Dict[str, int]) -> int:
        msgs = _message(_LINK_INFO, struct.pack("<BBQQ", 0, 0, _UNDEF, _UNDEF))
        msgs += _message(_GROUP_INFO, bytes([0, 0]))
        for name, addr in children.items():
            raw = name.encode()
            if len(raw) > 255:
                raise ValueError(f"link name too long: {name!r}")
            msgs += _message(_LINK, struct.pack("<BBB", 1, 0, len(raw)) + raw
                             + struct.pack("<Q", addr))
        return self.put(_object_header(msgs))

    def superblock(self, root: int) -> None:
        sb = _SIGNATURE + struct.pack("<BBBBQQQQ", 2, 8, 8, 0, 0, _UNDEF, self.pos, root)
        self.f.seek(0)
        self.f.write(sb + struct.pack("<I", checksum(sb)))


# ----------------------------------------------------------------- reading

def _messages(block: bytes, version: int, step: int, msgs: Dict[int, list],
              more: list) -> None:
    """Add a block's messages to ``msgs``, and its continuations (address,
    length) to ``more``. A version-1 message: type (2), size (2, a multiple
    of 8), flags (1), 3 reserved bytes; version 2: type (1), size (2),
    flags (1), with ``step`` 6 a 2-byte creation order; then the data."""
    i = 0
    while i + step <= len(block):
        if version == 1:
            mtype, msize, mflags = struct.unpack_from("<HHB", block, i)
        else:
            mtype, msize, mflags = block[i], struct.unpack_from("<H", block, i + 1)[0], block[i + 3]
        data = block[i + step:i + step + msize]
        if mflags & 0x02 and mtype:
            raise NotImplementedError(f"shared object header messages (type {mtype:#x})")
        if mtype == _CONTINUATION:
            more.append(struct.unpack_from("<QQ", data))
        elif mtype:
            msgs.setdefault(mtype, []).append(data)
        i += step + msize


def _read_header(fh, addr: int) -> Dict[int, list]:
    """{message type: [message data, ...]} of the object header at ``addr``
    (version 1 or 2), its continuation blocks followed."""
    fh.seek(addr)
    head = fh.read(16)
    msgs: Dict[int, list] = {}
    more: List[Tuple[int, int]] = []
    if head[0] == 1:  # version 1: 16-byte prefix, messages 8-byte aligned
        (size,) = struct.unpack_from("<I", head, 8)
        fh.seek(addr + 16)
        _messages(fh.read(size), 1, 8, msgs, more)
        while more:
            at, length = more.pop(0)
            fh.seek(at)
            _messages(fh.read(length), 1, 8, msgs, more)
        return msgs
    if head[:4] != b"OHDR" or head[4] != 2:
        raise NotImplementedError(f"object header at {addr}: not a version-1 or 2 header")
    flags = head[5]
    # bit 5: four 4-byte times; bit 4: two 2-byte attribute phase values
    at = addr + 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
    width = 1 << (flags & 0x03)
    fh.seek(addr)
    head = fh.read(at - addr + width)
    size = int.from_bytes(head[-width:], "little")
    body = fh.read(size)
    (stored,) = struct.unpack("<I", fh.read(4))
    if checksum(head + body) != stored:
        raise OSError(f"object header at {addr}: checksum mismatch")
    step = 6 if flags & 0x04 else 4
    _messages(body, 2, step, msgs, more)
    while more:
        at, length = more.pop(0)
        fh.seek(at)
        block = fh.read(length)
        if block[:4] != b"OCHK" or checksum(block[:-4]) != struct.unpack_from("<I", block,
                                                                              length - 4)[0]:
            raise OSError(f"object header continuation at {at}: bad signature or checksum")
        _messages(block[4:-4], 2, step, msgs, more)
    return msgs


def _btree_children(fh, addr: int, node_type: int, key_size: int):
    """(key bytes, child address) of every entry under the version-1 B-tree
    node at ``addr``, leaves only, in key order."""
    fh.seek(addr)
    head = fh.read(24)
    if head[:4] != b"TREE" or head[4] != node_type:
        raise OSError(f"v1 B-tree node at {addr}: bad signature or node type")
    level, entries = head[5], struct.unpack_from("<H", head, 6)[0]
    body = fh.read(entries * (key_size + 8) + key_size)
    out = []
    for e in range(entries):
        i = e * (key_size + 8)
        key, child = body[i:i + key_size], struct.unpack_from("<Q", body, i + key_size)[0]
        out.extend(_btree_children(fh, child, node_type, key_size) if level else [(key, child)])
    return out


def _symbol_table_links(fh, btree: int, heap: int) -> Dict[str, int]:
    """The links of an old-style group: its B-tree (type 0) over SNOD nodes
    of symbol table entries, their names in the local heap."""
    fh.seek(heap)
    h = fh.read(32)
    if h[:4] != b"HEAP":
        raise OSError(f"local heap at {heap}: bad signature")
    heap_size, _, heap_data = struct.unpack_from("<QQQ", h, 8)
    fh.seek(heap_data)
    names = fh.read(heap_size)
    links = {}
    for _, snod in _btree_children(fh, btree, 0, 8):
        fh.seek(snod)
        head = fh.read(8)
        if head[:4] != b"SNOD":
            raise OSError(f"symbol table node at {snod}: bad signature")
        (count,) = struct.unpack_from("<H", head, 6)
        table = fh.read(40 * count)
        for k in range(count):
            name_at, header = struct.unpack_from("<QQ", table, 40 * k)
            links[names[name_at:names.index(b"\0", name_at)].decode()] = header
    return links


def _filters(data: bytes) -> List[Tuple[int, str]]:
    """(id, name) of each filter of a filter pipeline message, version 1 or
    2, in the order the writer applied them."""
    version, count = data[0], data[1]
    i = 8 if version == 1 else 2
    out = []
    for _ in range(count):
        fid = struct.unpack_from("<H", data, i)[0]
        if version == 1 or fid >= 256:
            name_len, _, n_values = struct.unpack_from("<HHH", data, i + 2)
            i += 8
        else:
            name_len, (_, n_values) = 0, struct.unpack_from("<HH", data, i + 2)
            i += 6
        name = data[i:i + name_len].split(b"\0")[0].decode(errors="replace")
        i += (name_len + 7) // 8 * 8 if version == 1 else name_len
        i += 4 * n_values + (4 if version == 1 and n_values % 2 else 0)
        out.append((fid, name))
    return out


def _decode_chunk(raw: bytes, filters, mask: int) -> bytes:
    """Undo the pipeline (filters by id first), last filter first; bit j of
    ``mask`` marks filter j as skipped for this chunk."""
    for j in reversed(range(len(filters))):
        if mask >> j & 1:
            continue
        if filters[j][0] == DEFLATE_FILTER_ID:
            raw = zlib.decompress(raw)
        elif filters[j][0] == BLOSC_FILTER_ID:
            from . import blosc_codec  # imports this module: taken here, not at import

            raw = blosc_codec.decompress_frame(raw)
        else:  # refused when the dataset opened
            raise AssertionError(filters[j])
    return raw


def _encode_chunk(raw: bytes, filters, itemsize: int) -> bytes:
    """Apply the pipeline of (id, name, flags, client data values) filters
    in order: deflate at its level, Blosc as its 7 values say (typesize,
    clevel, shuffle and compressor in slots 2, 4, 5 and 6)."""
    for fid, _, _, values in filters:
        if fid == DEFLATE_FILTER_ID:
            raw = zlib.compress(raw, values[0] if values else 4)
        else:
            from . import blosc_codec

            cname = {v: k for k, v in blosc_codec._COMPCODE.items()}[values[6]]
            raw = blosc_codec.compress_frame(raw, itemsize, values[4], values[5], cname)
    return raw


class Dataset:
    def __init__(self, file: "File", name: str, msgs: Dict[int, list]):
        self._file = file
        self.name = name
        space = msgs[_DATASPACE][0]
        ndim = space[1]
        if space[0] == 1:  # version 1: rank 0 is a scalar
            dims_at, scalar = 8, ndim == 0
        elif space[0] == 2:
            dims_at, scalar = 4, space[3] != 1
        else:
            raise NotImplementedError(f"dataspace message version {space[0]}")
        self.shape = () if scalar else tuple(struct.unpack_from(f"<{ndim}Q", space, dims_at))
        self.dtype = _parse_datatype(msgs[_DATATYPE][0])
        self.chunks: Optional[Tuple[int, ...]] = None
        self._filters = _filters(msgs[_FILTERS][0]) if _FILTERS in msgs else []
        self.filter_ids = tuple(fid for fid, _ in self._filters)
        for fid, fname in self._filters:
            if fid not in _FILTER_NAMES:
                raise NotImplementedError(
                    f"{name}: HDF5 filter {fid} ({fname or 'unnamed'}) is not in h5lite, "
                    f"which decodes only filters {DEFLATE_FILTER_ID} (deflate) and "
                    f"{BLOSC_FILTER_ID} (Blosc); read it with h5py")
        layout = msgs[_LAYOUT][0]
        version, cls = layout[0], layout[1]
        self._inline = None
        if version not in (3, 4):
            raise NotImplementedError(f"{name}: data layout message version {version}")
        if cls == 0:  # compact: the data is in the header
            (n,) = struct.unpack_from("<H", layout, 2)
            self._inline = bytes(layout[4:4 + n])
        elif cls == 1:
            self._addr = struct.unpack_from("<Q", layout, 2)[0]
        elif cls == 2 and version == 3:
            rank = layout[2] - 1  # the last dimension is the element size
            self._btree = struct.unpack_from("<Q", layout, 3)[0]
            self.chunks = tuple(struct.unpack_from(f"<{rank}I", layout, 11))
        elif cls == 2:
            ndims, width = layout[3], layout[4]
            index = layout[5 + ndims * width]
            raise NotImplementedError(
                f"{name}: chunked data layout version 4 with a "
                f"{_CHUNK_INDEXES.get(index, f'type {index}')} chunk index (written with "
                "libver='latest' or 'v110' and later) is not in h5lite, which reads chunks "
                "indexed by a version-1 B-tree (h5py's default, libver='earliest'); "
                "read it with h5py or rewrite it with libver='earliest'")
        else:
            raise NotImplementedError(f"{name}: data layout class {cls}")
        if self._filters and self.chunks is None:
            raise NotImplementedError(f"{name}: a filter on a dataset that is not chunked")

    def __len__(self):
        if not self.shape:
            raise TypeError("a scalar dataset has no len()")
        return self.shape[0]

    def _chunk_index(self):
        """[(offsets, stored size, filter mask, address)] of the written
        chunks in B-tree key order, cached per file. A key holds the size,
        the mask and one 8-byte offset per axis plus one."""
        cache = self._file._chunk_indexes
        if self._btree not in cache:
            rank = len(self.chunks)
            entries = (_btree_children(self._file._fh, self._btree, 1, 16 + 8 * rank)
                       if self._btree != _UNDEF else [])
            cache[self._btree] = [(struct.unpack_from(f"<{rank}Q", key, 8),
                                   *struct.unpack_from("<II", key), addr)
                                  for key, addr in entries]
        return cache[self._btree]

    def _chunk(self, size: int, mask: int, addr: int) -> np.ndarray:
        fh = self._file._fh
        fh.seek(addr)
        raw = _decode_chunk(fh.read(size), self._filters, mask)
        n = int(np.prod(self.chunks, dtype=np.int64))
        return np.frombuffer(raw, self.dtype, count=n).reshape(self.chunks)

    def _rows(self, i0: int, i1: int) -> np.ndarray:
        """Rows [i0, i1) of axis 0 (the whole of a scalar), as a new array."""
        rest = self.shape[1:]
        if not self.shape:
            i0, i1 = 0, 1
        count = max(i1 - i0, 0)
        if self.chunks is not None:
            out = np.zeros((count,) + rest, self.dtype)
            c0 = self.chunks[0]
            for offsets, size, mask, addr in self._chunk_index():
                lo, hi = max(i0, offsets[0]), min(i1, offsets[0] + c0)
                if lo >= hi:
                    continue
                # the chunk's part inside the dataset, on every other axis
                inner = tuple(slice(0, min(c, r - o))
                              for c, r, o in zip(self.chunks[1:], rest, offsets[1:]))
                where = tuple(slice(o, o + s.stop) for o, s in zip(offsets[1:], inner))
                chunk = self._chunk(size, mask, addr)
                out[(slice(lo - i0, hi - i0),) + where] = chunk[
                    (slice(lo - offsets[0], hi - offsets[0]),) + inner]
            return out
        row = int(np.prod(rest, dtype=np.int64))
        size = self.dtype.itemsize * row
        if self._inline is not None:
            flat = np.frombuffer(self._inline[i0 * size:i1 * size], self.dtype).copy()
        elif count == 0 or self._addr == _UNDEF:
            flat = np.zeros(count * row, self.dtype)
        else:
            self._file._fh.seek(self._addr + i0 * size)
            flat = np.frombuffer(self._file._fh.read(count * size), self.dtype).copy()
        return flat.reshape((count,) + rest)

    def __getitem__(self, index):
        if index == () or index is Ellipsis:
            out = self._rows(0, self.shape[0] if self.shape else 1)
            return out.reshape(self.shape)[()] if self.shape else out.reshape(())[()]
        if not self.shape:
            raise IndexError("a scalar dataset takes only [()]")
        lead = index[0] if isinstance(index, tuple) else index
        rest = index[1:] if isinstance(index, tuple) else ()
        if isinstance(lead, slice):
            start, stop, step = lead.indices(self.shape[0])
            if step != 1:
                raise NotImplementedError("strided reads")
            out = self._rows(start, stop)
        else:
            i = int(lead) + (self.shape[0] if int(lead) < 0 else 0)
            if not 0 <= i < self.shape[0]:
                raise IndexError(f"index {lead} out of range for {self.shape[0]}")
            out = self._rows(i, i + 1)[0]
            out = out[()] if not self.shape[1:] else out
        return out[rest] if rest else out

    def __array__(self, dtype=None, copy=None):
        out = self[()]
        return np.asarray(out, dtype=dtype)


class ChunkedDatasetWriter:
    """A chunked dataset of a file open for writing: its chunks go to the
    file as they are written, its B-tree and header on ``close()``."""

    def __init__(self, file: "File", name: str, shape, dtype, chunks, maxshape, filters):
        self._file = file
        self.name = name
        self.shape = tuple(int(s) for s in shape)
        self.dtype = np.dtype(dtype)
        _datatype_message(self.dtype)  # refuse what cannot be stored, now
        self.chunks = tuple(int(c) for c in chunks)
        self.maxshape = None if maxshape is None else tuple(maxshape)
        if not self.shape or len(self.chunks) != len(self.shape) or min(self.chunks) < 1:
            raise ValueError(f"{name}: chunks {self.chunks} for shape {self.shape}")
        if self.maxshape is not None and (len(self.maxshape) != len(self.shape) or any(
                m is not None and m < s for m, s in zip(self.maxshape, self.shape))):
            raise ValueError(f"{name}: maxshape {self.maxshape} for shape {self.shape}")
        self._filters = filters  # (id, name, flags, client data values)
        self.filter_ids = tuple(f[0] for f in filters)
        self._index: Dict[Tuple[int, ...], Tuple[int, int, int]] = {}  # -> size, mask, address

    @property
    def id(self):
        """h5py's low-level handle, for ``write_direct_chunk``."""
        return self

    def __len__(self):
        return self.shape[0]

    def resize(self, shape) -> None:
        shape = (int(shape),) if np.ndim(shape) == 0 else tuple(int(s) for s in shape)
        if self.maxshape is None or len(shape) != len(self.shape) or any(
                m is not None and s > m for s, m in zip(shape, self.maxshape)):
            raise ValueError(f"{self.name}: cannot resize {self.shape} to {shape} "
                             f"(maxshape {self.maxshape})")
        self.shape = shape
        # chunks wholly outside the new extent are dropped, as HDF5 does
        self._index = {o: v for o, v in self._index.items()
                       if all(a < s for a, s in zip(o, shape))}

    def write_direct_chunk(self, offsets, data, filter_mask: int = 0) -> None:
        """Store ``data``, a chunk already through the pipeline (bit j of
        ``filter_mask`` set where filter j was skipped), at ``offsets``."""
        offsets = tuple(int(o) for o in offsets)
        if len(offsets) != len(self.shape) or any(
                o % c or o >= s for o, c, s in zip(offsets, self.chunks, self.shape)):
            raise ValueError(f"{self.name}: no chunk at {offsets} (chunks {self.chunks}, "
                             f"shape {self.shape})")
        data = bytes(data)
        self._index[offsets] = (len(data), int(filter_mask), self._file._writer.put(data))

    def _read_chunk(self, offsets) -> np.ndarray:
        if offsets not in self._index:
            return np.zeros(self.chunks, self.dtype)
        size, mask, addr = self._index[offsets]
        fh = self._file._fh
        fh.seek(addr)
        raw = _decode_chunk(fh.read(size), self._filters, mask)
        return np.frombuffer(raw, self.dtype, count=int(np.prod(self.chunks))).reshape(
            self.chunks).copy()

    def __setitem__(self, index, value) -> None:
        """``ds[()]``, ``ds[...]`` or ``ds[i0:i1]`` = an array (broadcast):
        each chunk the rows overlap is read back where it holds other rows,
        filled and written anew through the pipeline."""
        if index == () or index is Ellipsis:
            i0, i1 = 0, self.shape[0]
        elif isinstance(index, slice) and index.step in (None, 1):
            i0, i1, _ = index.indices(self.shape[0])
        else:
            raise NotImplementedError(f"{self.name}: h5lite writes whole rows, ds[i0:i1] = ...")
        rest = self.shape[1:]
        value = np.broadcast_to(np.asarray(value, self.dtype), (max(i1 - i0, 0),) + rest)
        c0 = self.chunks[0]
        grids = [range(0, s, c) for s, c in zip(rest, self.chunks[1:])]
        for o0 in range(i0 // c0 * c0, i1, c0):
            for inner in itertools.product(*grids):
                offsets = (o0,) + inner
                block = self._read_chunk(offsets)
                lo, hi = max(i0, o0), min(i1, o0 + c0)
                span = tuple(slice(o, min(o + c, s))
                             for o, c, s in zip(inner, self.chunks[1:], rest))
                block[(slice(lo - o0, hi - o0),) + tuple(slice(0, sl.stop - sl.start)
                                                         for sl in span)] = value[
                    (slice(lo - i0, hi - i0),) + span]
                self.write_direct_chunk(
                    offsets, _encode_chunk(block.tobytes(), self._filters, self.dtype.itemsize))

    def _write(self, w: "_Writer") -> int:
        entries = [(o, *self._index[o]) for o in sorted(self._index)]
        btree = _chunk_btree(w, entries, len(self.shape), self.dtype.itemsize)
        layout = struct.pack("<BBBQ", 3, 2, len(self.shape) + 1, btree)
        layout += struct.pack(f"<{len(self.chunks) + 1}I", *self.chunks, self.dtype.itemsize)
        msgs = (_message(_DATASPACE, _dataspace_message(self.shape, self.maxshape))
                + _message(_DATATYPE, _datatype_message(self.dtype))
                # fill value v3: incremental allocation, written if set, none set
                + _message(_FILL_VALUE, bytes([3, 0x03 | (2 << 2)])))
        if self._filters:
            msgs += _message(_FILTERS, _filter_message(self._filters))
        return w.put(_object_header(msgs + _message(_LAYOUT, layout)))


def _guess_chunks(shape, itemsize: int) -> Tuple[int, ...]:
    """The whole array, its largest axis halved until a chunk holds at most
    1 MiB (h5py's largest automatic chunk)."""
    chunks = [max(int(s), 1) for s in shape]
    while int(np.prod(chunks)) * itemsize > 1 << 20 and max(chunks) > 1:
        i = int(np.argmax(chunks))
        chunks[i] = (chunks[i] + 1) // 2
    return tuple(chunks)


class Group:
    def __init__(self, file: "File", name: str, links: Optional[Dict[str, int]] = None):
        self._file = file
        self.name = name
        self._links = links  # read mode: name -> object header address
        self._children: Dict[str, object] = {}  # write mode: name -> Group | array

    def _node(self, name: str):
        if self._links is None:
            return self._children[name]
        addr = self._links[name]
        msgs = _read_header(self._file._fh, addr)
        path = f"{self.name.rstrip('/')}/{name}"
        if _LAYOUT in msgs:
            return Dataset(self._file, path, msgs)
        return Group(self._file, path, _links_of(self._file._fh, msgs))

    def __getitem__(self, path: str):
        node = self
        for part in [p for p in path.split("/") if p]:
            if not isinstance(node, Group):
                raise KeyError(path)
            node = node._node(part)
        return node

    def __contains__(self, path: str) -> bool:
        try:
            self[path]
        except KeyError:
            return False
        return True

    def keys(self):
        return list(self._children if self._links is None else self._links)

    def __iter__(self):
        return iter(self.keys())

    def __len__(self):
        return len(self.keys())

    def _check_writable(self):
        if self._links is not None:
            raise OSError("file opened read-only")

    def create_group(self, name: str) -> "Group":
        self._check_writable()
        if name in self._children:
            raise ValueError(f"{name!r} exists")
        g = Group(self._file, f"{self.name.rstrip('/')}/{name}")
        self._children[name] = g
        return g

    def __setitem__(self, name: str, value) -> None:
        self._check_writable()
        if name in self._children:
            raise ValueError(f"{name!r} exists")
        arr = np.asarray(value)
        _datatype_message(arr.dtype)  # refuse what cannot be stored, now
        self._children[name] = arr

    def create_dataset(self, name: str, shape=None, dtype=None, data=None, chunks=None,
                       maxshape=None, compression=None, compression_opts=None,
                       allow_unknown_filter: bool = False):
        """h5py's ``create_dataset``: contiguous unless ``chunks``,
        ``maxshape`` or ``compression`` asks for chunks; ``compression`` is
        ``"gzip"`` (deflate, level ``compression_opts`` or 4) or Blosc's
        filter id 32001 with its 7 client data values in
        ``compression_opts``. Other filters raise, naming them."""
        self._check_writable()
        if name in self._children:
            raise ValueError(f"{name!r} exists")
        if data is not None:
            data = np.asarray(data, dtype)
            shape, dtype = data.shape if shape is None else tuple(shape), data.dtype
        dtype = np.dtype("<f4" if dtype is None else dtype)
        filters = []
        if compression in ("gzip", DEFLATE_FILTER_ID):
            level = 4 if compression_opts is None else int(compression_opts)
            filters.append((DEFLATE_FILTER_ID, "deflate", _OPTIONAL, (level,)))
        elif compression == BLOSC_FILTER_ID:
            if compression_opts is None or len(compression_opts) != 7:
                raise ValueError(f"{name}: Blosc takes its 7 client data values, "
                                 f"not {compression_opts!r}")
            filters.append((BLOSC_FILTER_ID, "blosc", _OPTIONAL,
                            tuple(int(v) for v in compression_opts)))
        elif compression is not None:
            raise NotImplementedError(
                f"{name}: compression {compression!r} is not in h5lite, which writes "
                f"filters {DEFLATE_FILTER_ID} (gzip) and {BLOSC_FILTER_ID} (Blosc) only")
        if chunks is None and maxshape is None and not filters:
            self[name] = np.zeros(shape, dtype) if data is None else data
            return self._children[name]
        if chunks is None or chunks is True:
            chunks = _guess_chunks(shape, dtype.itemsize)
        ds = ChunkedDatasetWriter(self._file, f"{self.name.rstrip('/')}/{name}", shape, dtype,
                                  chunks, maxshape, filters)
        if data is not None and data.size:
            ds[()] = data
        self._children[name] = ds
        return ds

    def _write(self, w: _Writer) -> int:
        addrs = {}
        for name, child in self._children.items():
            addrs[name] = (child._write(w) if isinstance(child, (Group, ChunkedDatasetWriter))
                           else w.dataset(child))
        return w.group(addrs)


def _links_of(fh, msgs: Dict[int, list]) -> Dict[str, int]:
    """name -> object header address of a group: its symbol table (the
    old-style group) or its link messages (compact storage)."""
    if _SYMBOL_TABLE in msgs:
        return _symbol_table_links(fh, *struct.unpack_from("<QQ", msgs[_SYMBOL_TABLE][0]))
    links = {}
    for data in msgs.get(_LINK, []):
        flags = data[1]
        i = 2
        if flags & 0x08:
            if data[i] != 0:
                raise NotImplementedError("soft and external links")
            i += 1
        if flags & 0x04:
            i += 8
        if flags & 0x10:
            i += 1
        width = 1 << (flags & 0x03)
        n = int.from_bytes(data[i:i + width], "little")
        i += width
        name = data[i:i + n].decode()
        links[name] = struct.unpack_from("<Q", data, i + n)[0]
    if msgs.get(_LINK_INFO):
        heap = struct.unpack_from("<Q", msgs[_LINK_INFO][0], 2 + (8 if msgs[_LINK_INFO][0][1] & 1
                                                                   else 0))[0]
        if heap != _UNDEF:
            raise NotImplementedError("dense link storage (fractal heap)")
    return links


class File(Group):
    """``File(path, "r")`` reads; ``File(path, "w")`` writes chunks as they
    come and the rest of the tree on ``close()``."""

    def __init__(self, path, mode: str = "r"):
        if mode not in ("r", "w"):
            raise ValueError(f"h5lite opens files with mode 'r' or 'w', not {mode!r}")
        self.filename = str(path)
        self.mode = mode
        self._fh = None
        self._chunk_indexes: Dict[int, list] = {}  # B-tree address -> chunk index
        if mode == "r":
            self._fh = open(path, "rb")
            try:
                root = self._root_header(path)
                links = _links_of(self._fh, _read_header(self._fh, root))
            except BaseException:
                self._fh.close()
                raise
            super().__init__(self, "/", links)
        else:
            self._fh = open(path, "w+b")  # chunks are read back when rows are rewritten
            try:
                self._writer = _Writer(self._fh)
            except BaseException:
                self._fh.close()
                raise
            super().__init__(self, "/")

    def _root_header(self, path) -> int:
        """The root group's object header address, from a version 0-3
        superblock with 8-byte offsets and lengths."""
        sb = self._fh.read(96)
        version = sb[8] if sb[:8] == _SIGNATURE else None
        sizes = sb[13:15] if version in (0, 1) else sb[9:11]
        if version not in (0, 1, 2, 3) or sizes != b"\x08\x08":
            raise NotImplementedError(f"{path}: not an HDF5 file with a version 0-3 "
                                      "superblock and 8-byte offsets; open it with h5py")
        if version in (0, 1):
            # v1 adds 4 bytes (indexed storage K); then four addresses (base,
            # free space, end of file, VFD information block), then the root
            # symbol table entry: link name offset, object header address, ...
            at = 24 + 4 * version
            if struct.unpack_from("<Q", sb, at)[0] != 0:
                raise NotImplementedError(f"{path}: a user block (base address != 0)")
            return struct.unpack_from("<Q", sb, at + 32 + 8)[0]
        if checksum(sb[:44]) != struct.unpack_from("<I", sb, 44)[0]:
            raise OSError(f"{path}: superblock checksum mismatch")
        return struct.unpack_from("<Q", sb, 36)[0]

    def close(self) -> None:
        if self._fh is None or self._fh.closed:
            return
        try:
            if self.mode == "w":
                self._writer.superblock(self._write(self._writer))
        finally:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
