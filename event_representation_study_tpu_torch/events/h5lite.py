"""A subset of HDF5 in pure Python and NumPy, for hosts without ``h5py``.

It writes and reads files in the HDF5 format itself (``h5py`` and the HDF5
tools open what it writes): superblock version 2, version-2 object headers,
groups with their links stored in the header (compact storage), and
datasets of little-endian integers or floats, scalar or N-d, stored
contiguously. That covers the Gen1 layout that ``data/gen1.py`` writes
without Blosc. What it does not cover (chunked or compressed datasets,
attributes, dense link storage, older superblocks, as in the published
Gen1 files) raises: such files need ``h5py``.

The surface is the part of ``h5py`` that this package uses: ``File(path,
"r" | "w")``, ``Group.create_group``/``keys``/``[path]``/``[name] = array``,
and ``Dataset.shape``/``dtype``/``[index]``/``[()]``/``np.asarray``.

Format reference: the HDF5 File Format Specification, version 3.0
(superblock v2 §II.A, object header v2 §IV.A.1.b, messages §IV.A.2).
"""
from __future__ import annotations

import struct
from typing import Dict, Optional

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF
_SUPERBLOCK_SIZE = 48
# object header message types
_DATASPACE, _LINK_INFO, _DATATYPE, _FILL_VALUE, _LINK, _LAYOUT, _GROUP_INFO = (
    0x01, 0x02, 0x03, 0x05, 0x06, 0x08, 0x0A)


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


class _Writer:
    def __init__(self, f):
        self.f = f
        self.pos = _SUPERBLOCK_SIZE
        f.write(b"\0" * _SUPERBLOCK_SIZE)

    def put(self, blob: bytes) -> int:
        addr = self.pos
        self.f.write(blob)
        self.pos += len(blob)
        return addr

    def dataset(self, arr: np.ndarray) -> int:
        arr = np.asarray(arr, order="C")  # keeps 0-d arrays 0-d
        raw = arr.tobytes()
        data_addr = self.put(raw) if raw else _UNDEF
        space = struct.pack("<BBBB", 2, arr.ndim, 0, 1 if arr.ndim else 0)
        space += struct.pack(f"<{arr.ndim}Q", *arr.shape)
        msgs = (_message(_DATASPACE, space) + _message(_DATATYPE, _datatype_message(arr.dtype))
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

def _read_header(fh, addr: int) -> Dict[int, list]:
    """{message type: [message data, ...]} of the object header at ``addr``."""
    fh.seek(addr)
    head = fh.read(6)
    if head[:4] != b"OHDR" or head[4] != 2:
        raise NotImplementedError("only version-2 object headers are in h5lite")
    flags = head[5]
    # bit 5: four 4-byte times; bit 4: two 2-byte attribute phase values
    head += fh.read((16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0))
    width = 1 << (flags & 0x03)
    size = int.from_bytes(fh.read(width), "little")
    body = fh.read(size)
    (stored,) = struct.unpack("<I", fh.read(4))
    if checksum(head + size.to_bytes(width, "little") + body) != stored:
        raise OSError(f"object header at {addr}: checksum mismatch")
    msgs: Dict[int, list] = {}
    i, step = 0, 6 if flags & 0x04 else 4
    while i + step <= len(body):
        mtype, msize = body[i], struct.unpack_from("<H", body, i + 1)[0]
        if mtype == 0x10:
            raise NotImplementedError("object header continuation blocks")
        msgs.setdefault(mtype, []).append(body[i + step:i + step + msize])
        i += step + msize
    return msgs


class Dataset:
    def __init__(self, fh, name: str, msgs: Dict[int, list]):
        self._fh = fh
        self.name = name
        space = msgs[_DATASPACE][0]
        if space[0] != 2:
            raise NotImplementedError("dataspace message version != 2")
        ndim = space[1]
        self.shape = tuple(struct.unpack_from(f"<{ndim}Q", space, 4)) if space[3] == 1 else ()
        self.dtype = _parse_datatype(msgs[_DATATYPE][0])
        layout = msgs[_LAYOUT][0]
        self._inline = None
        if layout[0] in (3, 4) and layout[1] == 0:  # compact: the data is in the header
            (n,) = struct.unpack_from("<H", layout, 2)
            self._inline = bytes(layout[4:4 + n])
        elif layout[0] in (3, 4) and layout[1] == 1:
            self._addr = struct.unpack_from("<Q", layout, 2)[0]
        else:
            raise NotImplementedError("only contiguous and compact datasets are in h5lite "
                                      "(no chunks, no compression); read this file with h5py")

    def __len__(self):
        if not self.shape:
            raise TypeError("a scalar dataset has no len()")
        return self.shape[0]

    def _read(self, start: int, count: int) -> np.ndarray:
        size = self.dtype.itemsize
        if self._inline is not None:
            return np.frombuffer(self._inline[start * size:(start + count) * size],
                                 self.dtype).copy()
        if count <= 0 or self._addr == _UNDEF:
            return np.zeros(max(count, 0), self.dtype)
        self._fh.seek(self._addr + start * size)
        return np.frombuffer(self._fh.read(count * size), self.dtype).copy()

    def __getitem__(self, index):
        if index == () or index is Ellipsis:
            out = self._read(0, int(np.prod(self.shape, dtype=np.int64)))
            return out.reshape(self.shape)[()] if self.shape else out[0]
        if not self.shape:
            raise IndexError("a scalar dataset takes only [()]")
        row = int(np.prod(self.shape[1:], dtype=np.int64))
        lead = index[0] if isinstance(index, tuple) else index
        rest = index[1:] if isinstance(index, tuple) else ()
        if isinstance(lead, slice):
            start, stop, step = lead.indices(self.shape[0])
            if step != 1:
                raise NotImplementedError("strided reads")
            out = self._read(start * row, max(stop - start, 0) * row)
            out = out.reshape((max(stop - start, 0),) + self.shape[1:])
        else:
            i = int(lead) + (self.shape[0] if int(lead) < 0 else 0)
            if not 0 <= i < self.shape[0]:
                raise IndexError(f"index {lead} out of range for {self.shape[0]}")
            out = self._read(i * row, row).reshape(self.shape[1:])
            out = out[()] if not self.shape[1:] else out
        return out[rest] if rest else out

    def __array__(self, dtype=None, copy=None):
        out = self[()]
        return np.asarray(out, dtype=dtype)


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
            return Dataset(self._file._fh, path, msgs)
        return Group(self._file, path, _links_of(msgs))

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

    def _write(self, w: _Writer) -> int:
        addrs = {}
        for name, child in self._children.items():
            addrs[name] = child._write(w) if isinstance(child, Group) else w.dataset(child)
        return w.group(addrs)


def _links_of(msgs: Dict[int, list]) -> Dict[str, int]:
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
    """``File(path, "r")`` reads; ``File(path, "w")`` builds the tree in
    memory and writes it on ``close()``."""

    def __init__(self, path, mode: str = "r"):
        if mode not in ("r", "w"):
            raise ValueError(f"h5lite opens files with mode 'r' or 'w', not {mode!r}")
        self.filename = str(path)
        self.mode = mode
        self._fh = None
        if mode == "r":
            self._fh = open(path, "rb")
            sb = self._fh.read(_SUPERBLOCK_SIZE)
            if sb[:8] != _SIGNATURE or sb[8] not in (2, 3) or sb[9:11] != b"\x08\x08":
                self._fh.close()
                raise NotImplementedError(f"{path}: not an HDF5 file with a version 2/3 "
                                          "superblock and 8-byte offsets; open it with h5py")
            if checksum(sb[:44]) != struct.unpack_from("<I", sb, 44)[0]:
                self._fh.close()
                raise OSError(f"{path}: superblock checksum mismatch")
            root = struct.unpack_from("<Q", sb, 36)[0]
            super().__init__(self, "/", _links_of(_read_header(self._fh, root)))
        else:
            super().__init__(self, "/")

    def close(self) -> None:
        if self.mode == "w" and self._fh is None:
            with open(self.filename, "wb") as fh:
                self._fh = fh
                w = _Writer(fh)
                w.superblock(self._write(w))
        elif self._fh is not None and not self._fh.closed:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
