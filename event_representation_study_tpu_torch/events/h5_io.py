"""Event-file loading: the ``.npz`` and ``.npy`` branches of the JAX
package's ``events/h5_io.py::load_events_from_path``. HDF5 (with Blosc
chunks), ``.dat``, ``.bin`` and ``.bag`` are ROADMAP item M9/M19."""
from __future__ import annotations

import pathlib

import numpy as np

from .core import normalize_polarity

_DTYPE = [("x", "<i4"), ("y", "<i4"), ("t", "<i8"), ("p", "<i4")]


def _from_columns(raw: np.ndarray) -> np.ndarray:
    out = np.zeros(len(raw), dtype=_DTYPE)
    out["x"], out["y"], out["t"], out["p"] = (
        raw[:, 0], raw[:, 1], raw[:, 2], normalize_polarity(raw[:, 3])
    )
    return out


def load_events_from_path(path) -> np.ndarray:
    """Suffix-dispatched loader: structured ``(x, y, t, p)`` array."""
    path = pathlib.Path(path)
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
        f"{path.suffix} event files are not ported yet (ROADMAP M9: HDF5/Blosc; "
        "M19: .dat/.bin/.bag); use .npz or .npy"
    )
