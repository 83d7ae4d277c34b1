"""Byte-compatible readers/writers for the reference's on-disk formats
(numpy-only copy of hnsw_nsg_tpu/utils/io.py; the port imports no JAX).

The xvecs readers take the native reader (``utils/native.py``, the
repository's ``native/xvecs_io.cpp``) where it built and loaded, numpy
otherwise, as the JAX package's do; the bytes are the same.

Formats (SURVEY.md §2.7):
  * fvecs/ivecs/bvecs — per row ``int32 dim`` + dim x (f32 / i32 / u8);
    readers in the reference at CNNS/src/utils/aux_util.cpp:8-31 and
    hnswlib/tests/cpp/sift_1m.cpp:233-258.
  * NSG graph — ``uint32 width, uint32 ep`` then per node ``uint32 k`` +
    k x uint32 ids (CNNS/src/nsg/index_nsg.cpp:37-68).
  * nn-descent graph — per node ``uint32 K`` + K x uint32 ids, no header
    (CNNS/efanna_graph/src/index_graph.cpp:348-377).
  * GT file — per query ``uint32 GK`` + GK x uint32 (aux_util.cpp:33-54),
    i.e. ivecs-compatible.
  * centroids file — ``int32 n_clusters, int32 m, uint32 dim`` header then
    n_clusters*(m+1) fvecs rows (CNNS/tests/cluster_IVF_nndescent.cpp:143-186).
  * mapping_<cid> — raw int64 local->global array
    (cluster_IVF_nndescent.cpp:201-204).

Keeping these byte-compatible means indices and datasets produced by the
reference validate this framework directly, and vice versa.
"""

from __future__ import annotations

import struct

import numpy as np

PAD_ID = -1


# ---------------------------------------------------------------------------
# fvecs / ivecs / bvecs


def _read_xvecs(path: str, dtype, elem_size: int) -> np.ndarray:
    from . import native
    fast = native.read_xvecs(path, dtype, elem_size)
    if fast is not None:
        return fast
    raw = np.fromfile(path, dtype=np.uint8)
    if raw.size == 0:
        return np.zeros((0, 0), dtype=dtype)
    dim = int(np.frombuffer(raw[:4].tobytes(), dtype=np.int32)[0])
    row_bytes = 4 + dim * elem_size
    if raw.size % row_bytes != 0:
        raise ValueError(
            f"{path}: size {raw.size} not a multiple of row size {row_bytes}"
        )
    n = raw.size // row_bytes
    rows = raw.reshape(n, row_bytes)[:, 4:]
    return rows.reshape(n, dim * elem_size).view(dtype).reshape(n, dim).copy()


def read_fvecs(path: str) -> np.ndarray:
    return _read_xvecs(path, np.float32, 4)


def read_ivecs(path: str) -> np.ndarray:
    return _read_xvecs(path, np.int32, 4)


def read_bvecs(path: str) -> np.ndarray:
    return _read_xvecs(path, np.uint8, 1)


def _write_xvecs(path: str, arr: np.ndarray, dtype) -> None:
    arr = np.ascontiguousarray(arr, dtype=dtype)
    n, dim = arr.shape
    dims = np.full((n, 1), dim, dtype=np.int32)
    with open(path, "wb") as f:
        rows = np.concatenate(
            [dims.view(np.uint8).reshape(n, 4),
             arr.view(np.uint8).reshape(n, -1)],
            axis=1,
        )
        rows.tofile(f)


def write_fvecs(path: str, arr: np.ndarray) -> None:
    _write_xvecs(path, arr, np.float32)


def write_ivecs(path: str, arr: np.ndarray) -> None:
    _write_xvecs(path, arr, np.int32)


def write_bvecs(path: str, arr: np.ndarray) -> None:
    _write_xvecs(path, arr, np.uint8)


# GT files are ivecs with unsigned ids (aux_util.cpp:33-54).
def read_gt(path: str) -> np.ndarray:
    return read_ivecs(path).astype(np.int64)


write_gt = write_ivecs


# ---------------------------------------------------------------------------
# Variable-degree graph formats <-> padded adjacency


def pad_adjacency(lists, width: int | None = None) -> np.ndarray:
    """Ragged neighbor lists -> int32 [N, width] padded with PAD_ID."""
    n = len(lists)
    if width is None:
        width = max((len(l) for l in lists), default=0)
    adj = np.full((n, width), PAD_ID, dtype=np.int32)
    for i, l in enumerate(lists):
        l = np.asarray(l, dtype=np.int32)[:width]
        adj[i, : len(l)] = l
    return adj


def adjacency_to_lists(adj: np.ndarray):
    """Padded adjacency -> list of valid-neighbor arrays."""
    return [row[row >= 0] for row in np.asarray(adj)]


def read_nsg(path: str):
    """Reference .nsg file -> (adj int32 [N, width], ep, width).

    Format: CNNS/src/nsg/index_nsg.cpp:37-68.
    """
    raw = np.fromfile(path, dtype=np.uint32)
    width, ep = int(raw[0]), int(raw[1])
    lists = []
    pos = 2
    while pos < raw.size:
        k = int(raw[pos])
        pos += 1
        lists.append(raw[pos : pos + k].astype(np.int32))
        pos += k
    max_deg = max(width, max((len(l) for l in lists), default=0))
    return pad_adjacency(lists, max_deg), ep, width


def write_nsg(path: str, adj: np.ndarray, ep: int, width: int | None = None):
    adj = np.asarray(adj)
    if width is None:
        width = adj.shape[1]
    out = [np.array([width, ep], dtype=np.uint32)]
    for row in adj:
        nbrs = row[row >= 0].astype(np.uint32)
        out.append(np.array([len(nbrs)], dtype=np.uint32))
        out.append(nbrs)
    np.concatenate(out).tofile(path)


def read_knn_graph(path: str) -> np.ndarray:
    """Reference nn-descent graph file -> padded adjacency.

    Format: per node (uint32 K, K x uint32), index_graph.cpp:348-377.
    """
    raw = np.fromfile(path, dtype=np.uint32)
    lists = []
    pos = 0
    while pos < raw.size:
        k = int(raw[pos])
        pos += 1
        lists.append(raw[pos : pos + k].astype(np.int32))
        pos += k
    return pad_adjacency(lists)


def write_knn_graph(path: str, adj: np.ndarray) -> None:
    adj = np.asarray(adj)
    out = []
    for row in adj:
        nbrs = row[row >= 0].astype(np.uint32)
        out.append(np.array([len(nbrs)], dtype=np.uint32))
        out.append(nbrs)
    np.concatenate(out).tofile(path)


# ---------------------------------------------------------------------------
# CNNS centroid file / id mappings


def read_centroids(path: str):
    """-> (reps float32 [n_clusters, m+1, dim]). Header per
    cluster_IVF_nndescent.cpp:143-186: first row of each group is the
    centroid, the remaining m rows are random member representatives."""
    with open(path, "rb") as f:
        n_clusters, m, dim = struct.unpack("<iiI", f.read(12))
        body = np.fromfile(f, dtype=np.uint8)
    row_bytes = 4 + dim * 4
    n_rows = n_clusters * (m + 1)
    rows = body[: n_rows * row_bytes].reshape(n_rows, row_bytes)[:, 4:]
    reps = rows.view(np.float32).reshape(n_clusters, m + 1, dim).copy()
    return reps


def write_centroids(path: str, reps: np.ndarray) -> None:
    reps = np.ascontiguousarray(reps, dtype=np.float32)
    n_clusters, m_plus_1, dim = reps.shape
    with open(path, "wb") as f:
        f.write(struct.pack("<iiI", n_clusters, m_plus_1 - 1, dim))
        flat = reps.reshape(n_clusters * m_plus_1, dim)
        dims = np.full((flat.shape[0], 1), dim, dtype=np.int32)
        np.concatenate(
            [dims.view(np.uint8).reshape(-1, 4),
             flat.view(np.uint8).reshape(flat.shape[0], -1)],
            axis=1,
        ).tofile(f)


def read_mapping(path: str) -> np.ndarray:
    """local->global id array (int64), cluster_IVF_nndescent.cpp:201-204."""
    return np.fromfile(path, dtype=np.int64)


def write_mapping(path: str, mapping: np.ndarray) -> None:
    np.ascontiguousarray(mapping, dtype=np.int64).tofile(path)


# ---------------------------------------------------------------------------
# DiskANN-style .bin format (the reference's converter apps, CNNS/apps/):
# header int32 npts, int32 dim, then row-major payload.


def read_bin(path: str, dtype=np.float32) -> np.ndarray:
    with open(path, "rb") as f:
        n, dim = struct.unpack("<ii", f.read(8))
        data = np.fromfile(f, dtype=dtype, count=n * dim)
    return data.reshape(n, dim)


def write_bin(path: str, arr: np.ndarray, dtype=None) -> None:
    arr = np.ascontiguousarray(arr, dtype=dtype or arr.dtype)
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", arr.shape[0], arr.shape[1]))
        arr.tofile(f)


def read_tsv(path: str) -> np.ndarray:
    return np.loadtxt(path, dtype=np.float32, delimiter="\t", ndmin=2)


def write_tsv(path: str, arr: np.ndarray) -> None:
    np.savetxt(path, np.asarray(arr), delimiter="\t", fmt="%.6f")
