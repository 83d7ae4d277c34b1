"""Build and load the port's CUDA kernels (plain C interface + ctypes).

The sources under ``hnsw_nsg_tpu_torch/csrc/`` are compiled with ``nvcc``
at first use into ``hnsw_nsg_tpu_torch/_build/``, one shared library
named by a hash of the sources and flags, so an edited source rebuilds
and an unchanged one loads at once. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_lib = None
build_seconds = None   # wall time of the build (or load) that ran here


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources():
    srcs = sorted(SRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {SRC_DIR}")
    return srcs


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in _sources():
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return BUILD_DIR / f"libhnsw_nsg_kernels_{h.hexdigest()[:16]}.so"


def load_library() -> ctypes.CDLL:
    """Compile the sources if their hash has no library yet, then load it
    and declare the C signatures."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    t0 = time.perf_counter()
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *map(str, _sources())]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
                f"{res.stdout}\n{res.stderr}"
            )
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.grouped_scan.argtypes = [
        vp, vp, vp, vp, vp, vp,          # qc, qidx, slabs, bias, vals, idx
        ci, ci, ci, ci, ci, ci,          # C, cap, qn, d, maxc, k
        ctypes.c_float, ci, ci, vp,      # scale, q dtype, slab dtype, stream
    ]
    lib.grouped_scan.restype = ci
    build_seconds = time.perf_counter() - t0
    _lib = lib
    return lib
