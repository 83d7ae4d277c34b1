"""ctypes bridge to the native xvecs reader and writer (counterpart of
hnsw_nsg_tpu/utils/native.py).

``native/xvecs_io.cpp`` (mmap, rows copied by several threads, a plain C
ABI) is compiled at first use with ``g++`` into this package's
``_build/`` directory, under a name that hashes the source, so the
repository's ``native/`` directory is only read. ``utils/io.py``'s
readers take this path where the library loaded and numpy otherwise; the
bytes are the same either way.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np

_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "native", "xvecs_io.cpp")
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
_CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-pthread", "-shared"]
_lib = None
_tried = False


def library_path() -> str:
    """Where the library is (or would be) built: ``_build/`` and the
    source's hash."""
    with open(_SRC, "rb") as f:
        tag = hashlib.sha1(f.read() + " ".join(_CXXFLAGS).encode())
    return os.path.join(_BUILD_DIR, f"libxvecs_io-{tag.hexdigest()[:12]}.so")


def _compile(out: str) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise FileNotFoundError("no g++ on PATH")
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([cxx, *_CXXFLAGS, "-o", tmp, _SRC], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, out)    # atomic: concurrent compiles race safely
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_SRC):
        return None
    try:
        so = library_path()
        if not os.path.exists(so):
            _compile(so)
        lib = ctypes.CDLL(so)
    except (OSError, subprocess.SubprocessError):
        return None
    lib.xvecs_probe.argtypes = [
        ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.xvecs_read.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int,
    ]
    lib.xvecs_write.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
        ctypes.c_int64, ctypes.c_int32,
    ]
    _lib = lib
    return lib


def available() -> bool:
    """Whether the native library built and loaded."""
    return _load() is not None


def read_xvecs(path: str, dtype, elem_size: int,
               n_threads: int = 8) -> np.ndarray | None:
    """The native read of an fvecs/ivecs/bvecs file; None when the library
    is not there or the file is malformed (the numpy reader then gives
    the error)."""
    lib = _load()
    if lib is None:
        return None
    n = ctypes.c_int64()
    dim = ctypes.c_int32()
    if lib.xvecs_probe(path.encode(), elem_size, ctypes.byref(n),
                       ctypes.byref(dim)) != 0:
        return None
    out = np.empty((n.value, dim.value), dtype=dtype)
    rc = lib.xvecs_read(path.encode(), elem_size,
                        out.ctypes.data_as(ctypes.c_char_p), n.value,
                        dim.value, n_threads)
    return out if rc == 0 else None


def write_xvecs(path: str, arr: np.ndarray, elem_size: int) -> bool:
    """The native write; False when the library is not there or the write
    failed."""
    lib = _load()
    if lib is None:
        return False
    arr = np.ascontiguousarray(arr)
    return lib.xvecs_write(path.encode(), elem_size,
                           arr.ctypes.data_as(ctypes.c_char_p),
                           arr.shape[0], arr.shape[1]) == 0
