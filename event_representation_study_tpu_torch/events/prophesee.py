"""Prophesee .dat (EVT) and N-MNIST/N-Caltech .bin event decoding — the
equivalents of ev-licious/src/evlicious/io/utils/prophesee_utils.py:1-471
(DAT reader with n-event / delta-t streaming) and the reference's N-MNIST
reader (representations/tore.py:86-113). A copy of the JAX package's
``events/prophesee.py`` (NumPy only).

DAT layout: '%% '-prefixed ASCII header lines (Height/Width among them),
then one event-type byte + one event-size byte, then packed records:
``t: uint32`` followed by a 32-bit word with x in bits 0-13, y in bits
14-27, p in bit 28 (prophesee_utils.py:31-33 masks).

N-MNIST .bin layout: 5 bytes per event — x, y, (p<<7 | t[22:16]), t[15:8],
t[7:0]; rows with y == 240 are timestamp-overflow markers adding 2^13 us
(tore.py:95-105).

All readers return the canonical structured dtype (x, y: i4; t: i8; p: i4 in
{-1, +1}).
"""
from __future__ import annotations

import pathlib
from typing import Optional, Tuple

import numpy as np

EVENT_DTYPE = [("x", "<i4"), ("y", "<i4"), ("t", "<i8"), ("p", "<i4")]
X_MASK = 2**14 - 1
Y_MASK = 2**28 - 2**14
P_MASK = 2**29 - 2**28


def parse_dat_header(f) -> Tuple[int, int, int, Tuple[Optional[int], Optional[int]]]:
    """Returns (data_offset, ev_type, ev_size, (height, width))
    (prophesee_utils.py:64-122)."""
    f.seek(0)
    height = width = None
    bod = 0
    n_comments = 0
    while True:
        bod = f.tell()
        line = f.readline()
        if line[:2] != b"% ":
            break
        words = line.split()
        if len(words) > 2:
            if words[1] == b"Height":
                height = int(words[2])
            elif words[1] == b"Width":
                width = int(words[2])
        n_comments += 1
    f.seek(bod)
    if n_comments > 0:
        ev_type = int(np.frombuffer(f.read(1), np.uint8)[0])
        ev_size = int(np.frombuffer(f.read(1), np.uint8)[0])
    else:
        ev_type, ev_size = 0, 8
    return f.tell(), ev_type, ev_size, (height, width)


def _decode_words(raw) -> np.ndarray:
    out = np.zeros(len(raw), dtype=EVENT_DTYPE)
    word = raw["w"]
    out["x"] = np.bitwise_and(word, X_MASK)
    out["y"] = np.right_shift(np.bitwise_and(word, Y_MASK), 14)
    p = np.right_shift(np.bitwise_and(word, P_MASK), 28).astype(np.int32)
    out["p"] = np.where(p == 0, -1, 1)
    out["t"] = raw["t"]
    return out


class EventDatReader:
    """Streaming DAT reader (prophesee_utils.py:446-520 + EventBaseReader):
    ``load_n_events`` / ``load_delta_t`` / ``seek_time`` over the packed
    records without loading the whole file."""

    RECORD = np.dtype([("t", "<u4"), ("w", "<i4")])

    def __init__(self, path):
        self.path = pathlib.Path(path)
        self._file = open(self.path, "rb")
        self._start, self.ev_type, self._ev_size, self.size = parse_dat_header(
            self._file
        )
        assert self._ev_size == self.RECORD.itemsize, self._ev_size
        end = self._file.seek(0, 2)
        self._num = (end - self._start) // self._ev_size
        self.reset()

    def __len__(self):
        return self._num

    @property
    def height(self):
        return self.size[0]

    @property
    def width(self):
        return self.size[1]

    def reset(self):
        self._file.seek(self._start)
        self._idx = 0

    def is_done(self) -> bool:
        return self._idx >= self._num

    def load_n_events(self, n: int) -> np.ndarray:
        raw = np.fromfile(self._file, dtype=self.RECORD, count=n)
        self._idx += len(raw)
        return _decode_words(raw)

    def load_delta_t(self, delta_t_us: int) -> np.ndarray:
        """Events in the next delta_t window (chunked scan,
        prophesee_utils.py:249-297)."""
        pos = self._file.tell()
        start_idx = self._idx
        first = np.fromfile(self._file, dtype=self.RECORD, count=1)
        if len(first) == 0:
            return np.zeros(0, dtype=EVENT_DTYPE)
        t0 = int(first["t"][0])
        self._file.seek(pos)
        out = []
        CHUNK = 65536
        while True:
            raw = np.fromfile(self._file, dtype=self.RECORD, count=CHUNK)
            if len(raw) == 0:
                break
            over = np.searchsorted(raw["t"], t0 + delta_t_us, side="left")
            out.append(raw[:over])
            if over < len(raw):
                # rewind past the unconsumed tail
                self._file.seek((over - len(raw)) * self._ev_size, 1)
                break
        raw = np.concatenate(out) if out else np.zeros(0, dtype=self.RECORD)
        self._idx = start_idx + len(raw)
        return _decode_words(raw)

    def seek_event(self, n: int):
        n = int(np.clip(n, 0, self._num))
        self._file.seek(self._start + n * self._ev_size)
        self._idx = n

    def seek_time(self, t_us: int):
        """Binary search to the first event with t >= t_us
        (prophesee_utils.py:367-418)."""
        lo, hi = 0, self._num
        while lo < hi:
            mid = (lo + hi) // 2
            self._file.seek(self._start + mid * self._ev_size)
            rec = np.fromfile(self._file, dtype=self.RECORD, count=1)
            if len(rec) and int(rec["t"][0]) < t_us:
                lo = mid + 1
            else:
                hi = mid
        self.seek_event(lo)

    def close(self):
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def read_dat(path) -> np.ndarray:
    """Whole-file decode to the canonical structured dtype."""
    with EventDatReader(path) as r:
        return r.load_n_events(len(r))


def write_dat(path, events: np.ndarray, height: int, width: int):
    """Inverse of read_dat (for fixtures / round-trip tests)."""
    with open(path, "wb") as f:
        f.write(b"% Data file\n")
        f.write(f"% Height {height}\n".encode())
        f.write(f"% Width {width}\n".encode())
        f.write(np.uint8(12).tobytes())  # EventCD
        f.write(np.uint8(8).tobytes())
        rec = np.zeros(len(events), dtype=EventDatReader.RECORD)
        rec["t"] = events["t"]
        p01 = (np.asarray(events["p"]) > 0).astype(np.int32)
        rec["w"] = (
            np.asarray(events["x"], np.int32)
            | (np.asarray(events["y"], np.int32) << 14)
            | (p01 << 28)
        )
        rec.tofile(f)


def read_nmnist_bin(path) -> np.ndarray:
    """N-MNIST/N-Caltech101 .bin decode (tore.py:86-113), canonical dtype."""
    raw = np.fromfile(path, dtype=np.uint8).astype(np.uint32)
    all_x = raw[0::5]
    all_y = raw[1::5]
    all_p = (raw[2::5] & 128) >> 7
    all_t = ((raw[2::5] & 127) << 16) | (raw[3::5] << 8) | raw[4::5]
    all_t = all_t.astype(np.int64)
    overflow = np.where(all_y == 240)[0]
    for i in overflow:
        all_t[i:] += 2**13
    keep = all_y != 240
    out = np.zeros(int(keep.sum()), dtype=EVENT_DTYPE)
    out["x"] = all_x[keep]
    out["y"] = all_y[keep]
    out["t"] = all_t[keep]
    out["p"] = np.where(all_p[keep] == 0, -1, 1)
    return out


def write_nmnist_bin(path, events: np.ndarray):
    """Inverse of read_nmnist_bin (fixtures)."""
    n = len(events)
    raw = np.zeros(5 * n, np.uint8)
    t = np.asarray(events["t"], np.int64)
    assert (t < 2**23).all(), "write_nmnist_bin does not emit overflow rows"
    p01 = (np.asarray(events["p"]) > 0).astype(np.uint32)
    raw[0::5] = np.asarray(events["x"], np.uint32)
    raw[1::5] = np.asarray(events["y"], np.uint32)
    raw[2::5] = (p01 << 7) | ((t >> 16) & 127)
    raw[3::5] = (t >> 8) & 255
    raw[4::5] = t & 255
    raw.tofile(path)
