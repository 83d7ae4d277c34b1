"""The system under test for CNNS configurations: ``hnsw_nsg_tpu_torch``'s
cluster index, built by ``build_cnns`` and searched by
``CNNSIndex.search``, the entry the measured window drives.

A configuration's ``index`` group gives ``build_cnns``'s settings
(``n_clusters``, ``m``, ``kmeans_iters``, ``replicate``, ``slab_dtype``,
``seed``) and its top level the ``metric`` and the fixed ``nprobe``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from hnsw_nsg_tpu_torch.models.cnns import build_cnns
from hnsw_nsg_tpu_torch.ops import cluster_scan
from hnsw_nsg_tpu_torch.utils.params import CNNSConfig


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def build(x_host: np.ndarray, config: dict, device,
          slab_dtype: str | None = None):
    """The index over ``x_host`` (the host array ``build_cnns`` takes) and
    the build's seconds: ``build_s`` on the harness's clock around the
    whole call, synchronised, and ``kmeans_s`` from the program's own
    stage timer. The build's own seed is the configuration's
    (``index.seed``): with the rows in the same order every run's k-means
    starts from the same rows. ``slab_dtype`` overrides the
    configuration's (the control runs the program's int8 path)."""
    ic = config["index"]
    stages: dict = {}
    _sync(device)
    t0 = time.perf_counter()
    index = build_cnns(
        x_host,
        CNNSConfig(n_clusters=int(ic["n_clusters"]), m=int(ic["m"]),
                   kmeans_iters=int(ic["kmeans_iters"]),
                   replicate=bool(ic["replicate"])),
        metric=config["metric"], seed=int(ic["seed"]),
        slab_dtype=getattr(torch, slab_dtype or ic["slab_dtype"]),
        device=device, stage_seconds=stages)
    _sync(device)
    info = {"build_s": time.perf_counter() - t0,
            "kmeans_s": stages.get("kmeans"),
            "slabs": int(index.n_clusters), "maxc": int(index.maxc),
            "index_bytes": int(index.index_bytes())}
    return index, info


def search(index, queries: torch.Tensor, k: int, config: dict):
    """One request: (distances [Q, k], ids [Q, k]) on the index's device."""
    return index.search(queries, k=k, nprobe=int(config["nprobe"]))


def counters() -> dict:
    """The program's own count of scan launches by kernel name."""
    return dict(cluster_scan.launches_by_kernel)
