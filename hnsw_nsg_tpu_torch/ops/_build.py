"""Build and load the port's CUDA kernels (plain C interface + ctypes).

The sources under ``hnsw_nsg_tpu_torch/csrc/`` are compiled with ``nvcc``
at first use into ``hnsw_nsg_tpu_torch/_build/``, one shared library
named by a hash of the sources, the headers they share (``csrc/*.cuh``)
and the flags, so an edited source or header rebuilds and an unchanged
tree loads at once. Each source compiles in its own
``nvcc`` process, all started together, and one more links them. Nothing
here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
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
    for s in [*_sources(), *sorted(SRC_DIR.glob("*.cuh"))]:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return BUILD_DIR / f"libhnsw_nsg_kernels_{h.hexdigest()[:16]}.so"


def scratch(n_bytes: int, device):
    """The global scratch a general kernel asks for (its ``*_scratch``
    entry point's bytes) as (tensor, pointer), or (None, None) when it
    needs none. The caller holds the tensor until the launch is queued."""
    if not n_bytes:
        return None, None
    buf = torch.empty(n_bytes, dtype=torch.uint8, device=device)
    return buf, buf.data_ptr()


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
        tag = f"{so.stem}.{os.getpid()}"
        nvcc = _nvcc()
        objs, procs = [], []
        for src in _sources():
            obj = BUILD_DIR / f"{tag}.{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for cmd, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{out}")
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        if not failed:
            cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                   *map(str, objs)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        for obj in objs:
            obj.unlink(missing_ok=True)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.grouped_scan.argtypes = [
        vp, vp, vp, vp, vp, vp,          # qc, qidx, slabs, bias, vals, idx
        ci, ci, ci, ci, ci, ci,          # C, cap, qn, d, maxc, k
        cf, ci, ci, vp,                  # scale, q dtype, slab dtype, stream
    ]
    lib.grouped_scan.restype = ci
    lib.grouped_scan_general.argtypes = [
        vp, vp, vp, vp, vp, vp, vp,      # qc, qidx, slabs, bias, vals, idx,
                                         # scratch
        ci, ci, ci, ci, ci, ci,          # C, cap, qn, d, maxc, k
        cf, ci, ci, vp,                  # scale, q dtype, slab dtype, stream
    ]
    lib.grouped_scan_general.restype = ci
    lib.grouped_scan_general_scratch.argtypes = [
        ci, ci, ci, ci, ci, ci,          # C, cap, d, k, q dtype, slab dtype
    ]
    lib.grouped_scan_general_scratch.restype = ctypes.c_longlong
    lib.merge_select.argtypes = [
        vp, vp, vp, vp, vp,              # r_d, r_i, r_e, c_d, c_i
        vp, vp, vp, vp, vp,              # o_d, o_i, o_e, sel_i, sel_v
        ci, ci, ci, ci, vp,              # Q, L, C, expand, stream
    ]
    lib.merge_select.restype = ci
    lib.merge_select_general.argtypes = [
        vp, vp, vp, vp, vp,              # r_d, r_i, r_e, c_d, c_i
        vp, vp, vp, vp, vp, vp,          # o_d, o_i, o_e, sel_i, sel_v, scratch
        ci, ci, ci, ci, vp,              # Q, L, C, expand, stream
    ]
    lib.merge_select_general.restype = ci
    lib.merge_select_general_scratch.argtypes = [ci, ci]    # L, C
    lib.merge_select_general_scratch.restype = ctypes.c_longlong
    lib.merge_select_occupancy.argtypes = [ci, ci]      # L, C
    lib.merge_select_occupancy.restype = ci
    lib.cluster_join.argtypes = [
        vp, vp, vp, vp, vp, vp,          # qv, stacks, bias, vals, idx, scratch
        ci, ci, ci, ci, ci, ci,          # C, maxc, d, mm, k, group
        cf, ci, vp,                      # scale, dtype, stream
    ]
    lib.cluster_join.restype = ci
    lib.cluster_join_scratch.argtypes = [ci, ci, ci, ci, ci]  # C, maxc, d,
    lib.cluster_join_scratch.restype = ctypes.c_longlong     # k, dtype
    lib.cluster_join_rows.argtypes = [ci, ci, ci]             # d, k, dtype
    lib.cluster_join_rows.restype = ci
    lib.route_topk.argtypes = [
        vp, vp, vp, vp, vp,              # q, reps, bias, out, scratch
        ci, ci, ci, ci, ci, ci,          # Q, d, n_real, n_cols, n_rep, splits
        cf, vp,                          # scale, stream
    ]
    lib.route_topk.restype = ci
    lib.route_topk_splits.argtypes = [ci, ci, ci]     # Q, n_cols, SMs
    lib.route_topk_splits.restype = ci
    lib.route_topk_scratch.argtypes = [ci, ci, ci, ci]  # Q, n_cols, n_rep,
    lib.route_topk_scratch.restype = ctypes.c_longlong  # splits
    lib.probe_scan.argtypes = [
        vp, vp, vp, vp, vp,              # q, qnorm, visit, order, slabs
        vp, vp, vp, vp, vp,              # ids, cnorms, out_d, out_i, scratch
        ci, ci, ci, ci, ci, ci, ci,      # Q, npr, C, maxc, d, k, rows
        cf, vp,                          # scale, stream
    ]
    lib.probe_scan.restype = ci
    lib.probe_scan_rows.argtypes = [ci, ci, ci, ci]   # pairs, maxc, d, SMs
    lib.probe_scan_rows.restype = ci
    lib.probe_scan_scratch.argtypes = [ci, ci, ci, ci, ci]  # Q, npr, maxc,
    lib.probe_scan_scratch.restype = ctypes.c_longlong      # k, rows
    build_seconds = time.perf_counter() - t0
    _lib = lib
    return lib
