"""Build the package's CUDA source (``csrc/fused_segment_reduce.cu``) at
first use.

The source becomes a shared library with a plain C interface, compiled by
``nvcc`` for Hopper (``sm_90a``) and loaded with ctypes. The library is named
by a hash of its source and flags and kept in ``_build/`` beside the package
(listed in .gitignore), so an edited source is rebuilt and an unchanged one
is not.
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
SOURCE = "fused_segment_reduce"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_loaded: dict = {}


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
            return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not pathlib.Path(found).exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str = SOURCE) -> pathlib.Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str = SOURCE):
    """Compile ``csrc/<name>.cu`` unless its library is current. Returns
    ``(seconds, ptxas log)`` when it compiled, else None; raises with the
    compiler's output on failure."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-Xptxas=-v", "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if proc.returncode:
        raise RuntimeError(f"CUDA build of {name}.cu failed (nvcc exit {proc.returncode}):\n"
                           f"{proc.stdout}")
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    return time.perf_counter() - t0, proc.stdout


def load_library() -> ctypes.CDLL:
    """The ctypes handle of ``csrc/fused_segment_reduce.cu``, built first if
    needed, with its C prototypes set."""
    if SOURCE not in _loaded:
        build()
        lib = ctypes.CDLL(str(library_path()))
        lib.fused_segment_reduce.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.fused_segment_reduce.restype = ctypes.c_int
        lib.fused_segment_reduce_error_string.argtypes = [ctypes.c_int]
        lib.fused_segment_reduce_error_string.restype = ctypes.c_char_p
        _loaded[SOURCE] = lib
    return _loaded[SOURCE]
