"""The system under test for uint8 CNNS configurations (BIGANN-style 128-d
uint8 rows, L2): ``hnsw_nsg_tpu_torch``'s cluster index over uint8 rows,
built by ``build_cnns`` and searched by ``CNNSIndex.search``.

The contract is uint8 in, uint8 queries:

* ``build`` maps the drawn host rows to uint8 on the card (``uint8_map``
  of the configuration's reference, ``references/exact_knn_u8.py``),
  brings the uint8 rows back to the host before its clock starts, as a
  BIGANN user holds them already, and hands ``build_cnns`` the numpy
  ``uint8`` array;
* ``search`` hands ``CNNSIndex.search`` the request's queries as a
  ``torch.uint8`` tensor on the card. BIGANN's queries arrive as uint8, so
  each distinct batch is mapped once, at its first request (in the
  harness's warm-up, before the window), and kept.

A configuration's ``index`` group gives ``build_cnns``'s settings
(``n_clusters``, ``m``, ``kmeans_iters``, ``replicate``, ``slab_dtype``,
``seed``) and its top level the ``metric`` and the fixed ``nprobe``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from annbench import spec
from hnsw_nsg_tpu_torch.models.cnns import build_cnns
from hnsw_nsg_tpu_torch.ops import cluster_scan
from hnsw_nsg_tpu_torch.utils.params import CNNSConfig

_ref = spec.load_module("references", "exact_knn_u8")

# rows mapped a launch on the card: 512 MB of f32 at d = 128
_MAP_ROWS = 1 << 20

# id(f32 batch) -> (the batch, its uint8 map): the batch is held, so that
# its id is not reused while the entry lives; emptied by every build
_mapped: dict = {}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def build(x_host: np.ndarray, config: dict, device):
    """The index over the uint8 map of ``x_host`` and the build's seconds:
    ``build_s`` on the harness's clock around the whole call,
    synchronised, and ``kmeans_s``, ``upload_s`` and ``slabs_s`` from the
    program's own stage timers (absent where the program has none). The
    build's own seed is the configuration's (``index.seed``)."""
    ic = config["index"]
    _mapped.clear()
    x = torch.from_numpy(x_host)
    rows = torch.empty(x.shape, dtype=torch.uint8)
    for s in range(0, x.shape[0], _MAP_ROWS):
        rows[s : s + _MAP_ROWS] = _ref.uint8_map(
            x[s : s + _MAP_ROWS].to(device)).cpu()
    rows = rows.numpy()
    stages: dict = {}
    _sync(device)
    t0 = time.perf_counter()
    index = build_cnns(
        rows,
        CNNSConfig(n_clusters=int(ic["n_clusters"]), m=int(ic["m"]),
                   kmeans_iters=int(ic["kmeans_iters"]),
                   replicate=bool(ic["replicate"])),
        metric=config["metric"], seed=int(ic["seed"]),
        slab_dtype=getattr(torch, ic["slab_dtype"]),
        device=device, stage_seconds=stages)
    _sync(device)
    info = {"build_s": time.perf_counter() - t0,
            "kmeans_s": stages.get("kmeans"),
            "upload_s": stages.get("upload"),
            "slabs_s": stages.get("slabs"),
            "slabs": int(index.n_clusters), "maxc": int(index.maxc),
            "index_bytes": int(index.index_bytes())}
    return index, info


def search(index, queries: torch.Tensor, k: int, config: dict):
    """One request: (distances [Q, k], ids [Q, k]) on the index's device
    for the uint8 map of ``queries``, mapped at the batch's first
    request."""
    hit = _mapped.get(id(queries))
    if hit is None or hit[0] is not queries:
        hit = _mapped[id(queries)] = (queries, _ref.uint8_map(queries))
    return index.search(hit[1], k=k, nprobe=int(config["nprobe"]))


def counters() -> dict:
    """The program's own count of scan launches by kernel name."""
    return dict(cluster_scan.launches_by_kernel)
