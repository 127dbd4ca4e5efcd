"""Event-file I/O (the JAX package's ``events/h5_io.py``): the read handle
:class:`H5EventHandle` over the canonical ``events/{x,y,t,p,height,width}``
layout with its time and index window queries (``events/windows.py``), the
incremental writer :class:`H5Writer` (ev-licious h5_writer.py:29-67), and
the suffix-dispatched ``load_events_from_path`` (.h5/.hdf5, .npz, .npy,
Prophesee .dat, N-MNIST .bin, ROS1 .bag). Files are read and written
through h5py, or without it through ``events/h5lite.py``; Blosc-ZSTD chunks
are encoded and decoded by ``blosc_codec`` either way."""
from __future__ import annotations

import pathlib
from typing import Optional

import numpy as np

from . import blosc_codec
from .core import normalize_polarity
from .windows import (find_index_from_timestamps, index_windows, time_and_index_windows,
                      time_windows)

try:
    import hdf5plugin

    _COMPRESSION = dict(hdf5plugin.Blosc(cname="zstd", clevel=1, shuffle=2))
except ImportError:
    _COMPRESSION = None  # Blosc frames through blosc_codec (gzip if it has no codec)

_DTYPE = [("x", "<i4"), ("y", "<i4"), ("t", "<i8"), ("p", "<i4")]
_FIELDS = (("x", np.uint16), ("y", np.uint16), ("t", np.int64), ("p", np.int8))


class H5EventHandle:
    """Read handle over the canonical layout. ``group`` names the group of
    ``x, y, t, p`` columns: ``events`` in an events file, and
    ``<recording>/events`` in a Gen1 split file."""

    def __init__(self, path, group: str = "events"):
        self.f = blosc_codec.open_h5(path, "r")
        self.group = group
        g = self.f[group]
        if not all(k in g for k in ("x", "y", "t", "p")):
            raise ValueError(f"{path}: not an events file (no {group}/x, y, t, p)")
        self.height = int(g["height"][()]) if "height" in g else int(g["y"][:].max()) + 1
        self.width = int(g["width"][()]) if "width" in g else int(g["x"][:].max()) + 1

    def _t(self) -> np.ndarray:
        return self.f[f"{self.group}/t"][:]

    def __len__(self):
        return len(self.f[f"{self.group}/t"])

    def index_from_time(self, t_us: int) -> int:
        """Reference lookup (h5_event_handle.py:10-11): searchsorted of
        t_us + 1e-3, so an event exactly AT t_us belongs to the window
        ENDING here."""
        return int(find_index_from_timestamps(t_us, self._t()))

    def get_between_idx(self, i0: int, i1: int) -> np.ndarray:
        g = self.f[self.group]
        out = np.zeros(i1 - i0, dtype=_DTYPE)
        out["x"] = g["x"][i0:i1]
        out["y"] = g["y"][i0:i1]
        out["t"] = g["t"][i0:i1]
        out["p"] = normalize_polarity(np.asarray(g["p"][i0:i1]))
        return out

    def get_between_time(self, t0_us: int, t1_us: int) -> np.ndarray:
        return self.get_between_idx(self.index_from_time(t0_us), self.index_from_time(t1_us))

    def compute_index_windows(self, window: int, stride: Optional[int] = None):
        """Fixed-count END-aligned windows (h5_event_handle.py:71-103,
        units nr/nr: ends on the stride grid, spans reaching back).
        Needs only the stream length: no dataset read."""
        return index_windows(len(self), window, stride)

    def compute_time_windows(self, window_us: int, stride_us: Optional[int] = None):
        """Fixed-duration END-aligned windows (units us/us)."""
        return time_windows(self._t(), window_us, stride_us)

    def compute_time_and_index_windows(self, step_size: int, window: int,
                                       step_size_unit: str, window_unit: str):
        """The reference's full (mixed-unit) form (h5_event_handle.py:71-103)."""
        return time_and_index_windows(self._t(), step_size, window, step_size_unit,
                                      window_unit)

    def close(self):
        self.f.close()


class H5Writer:
    """Incremental appender (h5_writer.py:29-67) writing the reference's
    Blosc-ZSTD bit-shuffle chunks of 65,536 events (compression 32001, opts
    (0, 0, 0, 0, 1, 2, 5), h5_writer.py:8-28): through hdf5plugin when it
    is importable, else as frames of ``blosc_codec.BloscAppender``; deflate
    (gzip) only when this process has no Blosc codec at all. The file is an
    h5py one, or without h5py an h5lite one."""

    def __init__(self, path, height: int, width: int):
        self.f = blosc_codec.h5py.File(path, "w")
        g = self.f.create_group("events")
        self._ds = {}
        self._appenders = {}
        if _COMPRESSION is not None:
            for name, dtype in _FIELDS:
                self._ds[name] = g.create_dataset(name, shape=(0,), maxshape=(None,),
                                                  dtype=dtype, chunks=(1 << 16,), **_COMPRESSION)
        elif blosc_codec.available():
            for name, dtype in _FIELDS:
                self._appenders[name] = blosc_codec.BloscAppender(g, name, dtype, chunk=1 << 16)
        else:
            for name, dtype in _FIELDS:
                self._ds[name] = g.create_dataset(
                    name, shape=(0,), maxshape=(None,), dtype=dtype, chunks=(1 << 16,),
                    compression="gzip", compression_opts=4)
        g["height"], g["width"], g["divider"] = height, width, 1

    def add(self, x, y, t, p):
        if self._appenders:
            for name, arr in (("x", x), ("y", y), ("t", t), ("p", p)):
                self._appenders[name].append(arr)
            return
        n0 = self._ds["x"].shape[0]
        n1 = n0 + len(x)
        for name, arr in (("x", x), ("y", y), ("t", t), ("p", p)):
            self._ds[name].resize((n1,))
            self._ds[name][n0:n1] = arr

    def close(self):
        for app in self._appenders.values():
            app.close()
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def _from_columns(raw: np.ndarray) -> np.ndarray:
    out = np.zeros(len(raw), dtype=_DTYPE)
    out["x"], out["y"], out["t"], out["p"] = (
        raw[:, 0], raw[:, 1], raw[:, 2], normalize_polarity(raw[:, 3])
    )
    return out


def load_events_from_path(path) -> np.ndarray:
    """Suffix-dispatched loader (io/__init__.py:22-39): structured
    ``(x, y, t, p)`` array."""
    path = pathlib.Path(path)
    if path.suffix in (".h5", ".hdf5"):
        h = H5EventHandle(path)
        try:
            return h.get_between_idx(0, len(h))
        finally:
            h.close()
    if path.suffix == ".npz":
        fh = np.load(path)
        key = "event_data" if "event_data" in fh else list(fh.keys())[0]
        raw = fh[key]
        if raw.dtype.names:
            out = np.zeros(len(raw), dtype=_DTYPE)
            for k in "xytp":
                out[k] = raw[k] if k != "t" or "t" in raw.dtype.names else raw["ts"]
            out["p"] = normalize_polarity(out["p"])
            return out
        return _from_columns(raw)
    if path.suffix == ".npy":
        return _from_columns(np.load(path))
    if path.suffix == ".dat":
        from .prophesee import read_dat

        return read_dat(path)
    if path.suffix == ".bin":
        from .prophesee import read_nmnist_bin

        return read_nmnist_bin(path)
    if path.suffix == ".bag":  # rosbag handle (io/rosbag_event_handle.py)
        from .rosbag import RosbagEventHandle

        h = RosbagEventHandle(path)
        return h.get_between_idx(0, len(h))
    raise ValueError(f"unsupported event file: {path}")
