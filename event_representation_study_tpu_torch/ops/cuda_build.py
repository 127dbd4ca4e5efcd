"""Build the package's CUDA sources (``csrc/*.cu``) at first use.

Each source becomes its own shared library with a plain C interface,
compiled by ``nvcc`` for Hopper (``sm_90a``) and loaded with ctypes. A
library is named by a hash of its source and flags and kept in ``_build/``
beside the package (listed in .gitignore), so an edited source is rebuilt
and an unchanged one is not. :func:`build_all` starts one ``nvcc`` per
missing library, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

PKG_DIR = pathlib.Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# the C entry points of each source: name -> (argtypes, restype)
PROTOTYPES = {
    "fused_segment_reduce": {
        "fused_segment_reduce": ([_P] * 5 + [_I] * 5 + [_P], _I),
        "fused_segment_reduce_error_string": ([_I], ctypes.c_char_p),
    },
    "roll_rows": {
        "roll_rows": ([_P] * 3 + [_I] * 5 + [_P], _I),
        "roll_rows_error_string": ([_I], ctypes.c_char_p),
    },
    "window_attention": {
        "window_attention_fwd": ([_P] * 6 + [_I] * 5 + [_P], _I),
        "window_attention_bwd": ([_P] * 12 + [_I] * 5 + [_P], _I),
        "window_attention_error_string": ([_I], ctypes.c_char_p),
    },
}
SOURCES = tuple(PROTOTYPES)

_loaded: dict = {}


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
            return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not pathlib.Path(found).exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str) -> pathlib.Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> dict:
    """Compile every ``csrc/<name>.cu`` whose library is not current, one
    ``nvcc`` process per source, all started together. Returns
    ``{name: (seconds, ptxas log)}`` for the sources it compiled; raises with
    the compiler's output when any build fails."""
    nvcc = None
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas=-v", "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    report, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"CUDA build of {name}.cu failed (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: concurrent builders never see half a file
        report[name] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return report


def load_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built first if needed, with
    its C prototypes set."""
    if name not in _loaded:
        build_all((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, (argtypes, restype) in PROTOTYPES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _loaded[name] = lib
    return _loaded[name]
