"""Event-file loading (the JAX package's ``events/h5_io.py``): the read part
of :class:`H5EventHandle` over the canonical ``events/{x,y,t,p,height,
width}`` layout, with Blosc-ZSTD chunks decoded by ``blosc_codec`` when no
HDF5 plugin is installed, and the ``.h5``/``.hdf5``, ``.npz`` and ``.npy``
branches of ``load_events_from_path``. The time and index window queries
and ``H5Writer`` (ROADMAP M19), and ``.dat``, ``.bin`` and ``.bag`` (M19),
are not ported."""
from __future__ import annotations

import pathlib

import numpy as np

from . import blosc_codec
from .core import normalize_polarity

_DTYPE = [("x", "<i4"), ("y", "<i4"), ("t", "<i8"), ("p", "<i4")]


class H5EventHandle:
    """Read handle over the canonical layout."""

    def __init__(self, path):
        self.f = blosc_codec.open_h5(path, "r")
        g = self.f["events"]
        if not all(k in g for k in ("x", "y", "t", "p")):
            raise ValueError(f"{path}: not an events file (no events/x, y, t, p)")
        self.height = int(g["height"][()]) if "height" in g else int(g["y"][:].max()) + 1
        self.width = int(g["width"][()]) if "width" in g else int(g["x"][:].max()) + 1

    def __len__(self):
        return len(self.f["events/t"])

    def get_between_idx(self, i0: int, i1: int) -> np.ndarray:
        g = self.f["events"]
        out = np.zeros(i1 - i0, dtype=_DTYPE)
        out["x"] = g["x"][i0:i1]
        out["y"] = g["y"][i0:i1]
        out["t"] = g["t"][i0:i1]
        out["p"] = normalize_polarity(np.asarray(g["p"][i0:i1]))
        return out

    def close(self):
        self.f.close()


def _from_columns(raw: np.ndarray) -> np.ndarray:
    out = np.zeros(len(raw), dtype=_DTYPE)
    out["x"], out["y"], out["t"], out["p"] = (
        raw[:, 0], raw[:, 1], raw[:, 2], normalize_polarity(raw[:, 3])
    )
    return out


def load_events_from_path(path) -> np.ndarray:
    """Suffix-dispatched loader: structured ``(x, y, t, p)`` array."""
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
    raise NotImplementedError(
        f"{path.suffix} event files are not ported yet (ROADMAP M19: .dat/.bin/.bag); "
        "use .h5, .hdf5, .npz or .npy"
    )
