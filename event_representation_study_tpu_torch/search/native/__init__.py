"""ctypes bindings for the host C kernel evaluator (``kernel_evaluator.c``,
a copy of the JAX package's): the float64 oracle that ``search/kernels.py``
is held against.

The library is built at first use with the system C compiler (``$CC``, else
``cc``) into the package's ``_build/`` directory (listed in .gitignore),
named by a hash of its source and flags, so an edited source is rebuilt.
It is built serial: as an oracle it evaluates a few hundred candidates, and
the source guards its OpenMP pragmas with ``_OPENMP``. A failed build raises
with the compiler's output: there is no fallback implementation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
from typing import Optional, Tuple

import numpy as np

SOURCE = pathlib.Path(__file__).resolve().parent / "kernel_evaluator.c"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "_build"
CFLAGS = ("-O3", "-shared", "-fPIC")
_lib: Optional[ctypes.CDLL] = None

_DP = ctypes.POINTER(ctypes.c_double)
_LP = ctypes.POINTER(ctypes.c_long)


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CFLAGS).encode())
    return BUILD_DIR / f"libkernel_evaluator-{digest.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the library if it is not current; raise with the compiler's
    output if that fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [os.environ.get("CC", "cc"), *CFLAGS, str(SOURCE), "-o", str(tmp), "-lm"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"C build of {SOURCE.name} failed: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"C build of {SOURCE.name} failed (exit {proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.kernel_contrib_categorical.argtypes = [
            _DP, _LP, _LP, _DP, ctypes.c_double,
            ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_long,
            _DP, _DP, _DP,
        ]
        lib.kernel_contrib_categorical.restype = None
        lib.reshape_cat_probs.argtypes = [
            _DP, _DP, ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_long,
            ctypes.c_double, _DP,
        ]
        lib.reshape_cat_probs.restype = None
        _lib = lib
    return _lib


def kernel_contrib_categorical(
    cat_probs: np.ndarray,  # (draws, obs, total_options) f64
    offsets: np.ndarray,  # (dims,) int64
    samples: np.ndarray,  # (S, dims) int64
    objs: np.ndarray,  # (obs,) f64
    inv_vol: float,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(num, inv_den, probs) of every candidate, in float64."""
    lib = load()
    cat_probs = np.ascontiguousarray(cat_probs, np.float64)
    offsets = np.ascontiguousarray(offsets, np.int64)
    samples = np.ascontiguousarray(samples, np.int64)
    objs = np.ascontiguousarray(objs, np.float64)
    draws, obs, total = cat_probs.shape
    S, dims = samples.shape
    num = np.zeros(S)
    inv_den = np.zeros(S)
    probs = np.zeros((S, obs))
    lib.kernel_contrib_categorical(
        cat_probs.ctypes.data_as(_DP), offsets.ctypes.data_as(_LP),
        samples.ctypes.data_as(_LP), objs.ctypes.data_as(_DP),
        inv_vol, draws, obs, total, dims, S,
        num.ctypes.data_as(_DP), inv_den.ctypes.data_as(_DP),
        probs.ctypes.data_as(_DP),
    )
    return num, inv_den, probs


def reshape_cat_probs_native(
    raw_probs: np.ndarray,  # (draws, obs, options) f64, one categorical dim
    descriptors: np.ndarray,  # (options, desc_dim) f64
    sigma: float = 1.0,
) -> np.ndarray:
    """Descriptor-space kernel reshaping, the C twin of
    ``kernels.reshape_probs_one_dim``."""
    lib = load()
    raw_probs = np.ascontiguousarray(raw_probs, np.float64)
    descriptors = np.ascontiguousarray(descriptors, np.float64)
    draws, obs, options = raw_probs.shape
    desc_dim = descriptors.shape[1]
    if desc_dim > 64:
        raise ValueError(f"the C twin takes up to 64 descriptor dims, got {desc_dim}")
    out = np.zeros_like(raw_probs)
    lib.reshape_cat_probs(
        raw_probs.ctypes.data_as(_DP), descriptors.ctypes.data_as(_DP),
        draws, obs, options, desc_dim, ctypes.c_double(sigma),
        out.ctypes.data_as(_DP),
    )
    return out
