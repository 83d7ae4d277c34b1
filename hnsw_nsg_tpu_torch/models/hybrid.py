"""Hybrid HNSW-upper / NSG-base index (counterpart of
hnsw_nsg_tpu/models/hybrid.py).

Reference: ``HNSW_NSG<dist_t>`` (hnsw_nsg/include/index_hnsw_nsg.h:12-161):
one point set, two structures: an hnswlib ``HierarchicalNSW`` whose upper
layers provide routing, and an ``IndexNSG`` over the base layer.
``searchKnn`` (:107-151) takes the node the upper levels land on as the NSG
entry point and calls ``SearchFromEnterpoint``
(hnsw_nsg/src/index_nsg.cpp:703-783).

The two structures share the data and norm tensors: HNSWIndex supplies the
upper-level adjacency (its own level-0 links are unused after
``build_nsg_layer``), NSGIndex the base layer. Insert, then build the NSG,
as the reference's test program does (hnsw_nsg/tests/test_hnsw_nsg_search.cpp:
331-347). Both live on one device (``device=None``: the card).

``build_nsg_layer`` picks how the kNN graph is made by N as the JAX package
does: exact up to 8,192 points, rp-trees refined by two nn-descent
iterations up to 200,000 (``models/rptree.py``, ``models/nndescent.py``),
and the cluster join above (``models/knn_ivf.py``). ``build_accel`` packs
the NSG layer into the int8 records (``models/records.py``), which its
searches then traverse.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops.bruteforce import knn_graph_exact
from ..ops.distance import as_f32_queries
from ..utils.params import HNSWConfig, NNDescentConfig, NSGBuildConfig
from .hnsw import HNSWIndex
from .nsg import NSGIndex, build_nsg
from .rptree import knn_graph_rp


class HybridHNSWNSG:
    """HNSW levels >= 1 for routing; NSG at the base layer."""

    def __init__(
        self,
        dim: int,
        max_elements: int,
        hnsw_cfg: HNSWConfig = HNSWConfig(),
        nsg_cfg: NSGBuildConfig = NSGBuildConfig(L=40, R=20, C=500),
        metric: str = "l2",
        device=None,
    ):
        self.hnsw = HNSWIndex(dim, max_elements, hnsw_cfg, metric,
                              device=device)
        self.nsg_cfg = nsg_cfg
        self.metric = metric
        self.nsg: NSGIndex | None = None

    @property
    def n(self) -> int:
        return self.hnsw.n

    @property
    def device(self):
        return self.hnsw.device

    def add_points(self, vecs, labels=None, batch_size: int = 4096):
        """addPoint inserts into HNSW only (index_hnsw_nsg.h:79-82)."""
        self.hnsw.add_items(vecs, labels, batch_size=batch_size)
        self.nsg = None  # base layer stale until rebuilt

    def build_nsg_layer(self, knn_adj=None, seed: int = 0,
                        stats: dict | None = None):
        """Build_NSG (index_hnsw_nsg.h:72-74): NSG over all points.
        ``knn_adj`` [N, K]: a kNN graph to build from (numpy or a tensor);
        by default one is made, with K = L + 10. When ``stats`` is a dict
        it receives the kNN graph (``knn_adj``), the cluster join's shape
        where the join ran (``n_slabs``, ``maxc``, ``probes``, ``k``),
        the wall seconds of the rp-trees (``rp_trees``) and of their
        nn-descent refinement (``nndescent``) where they ran, and those of
        the kNN graph (``knn``) and of each NSG build stage."""
        n = self.hnsw.n
        data = self.hnsw.data[:n]
        stats = {} if stats is None else stats
        t0 = time.perf_counter()
        if knn_adj is None:
            k = min(self.nsg_cfg.L + 10, n - 1)
            if n <= 8192:
                knn_adj = knn_graph_exact(data, k, query_block=4096)
            elif n <= 200_000:
                knn_adj = knn_graph_rp(
                    data, k, metric=self.metric, seed=seed,
                    refine=NNDescentConfig(K=k, L=k + 20, iters=2, S=8, R=8),
                    stats=stats)
            else:
                # large N: the cluster join (models/knn_ivf.py)
                from .knn_ivf import knn_graph_ivf

                knn_adj = knn_graph_ivf(data, k, metric=self.metric,
                                        seed=seed, as_device=True,
                                        stats=stats)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        stats.update(knn_adj=knn_adj, knn=time.perf_counter() - t0)
        self.nsg = build_nsg(data, knn_adj, self.nsg_cfg, metric=self.metric,
                             device=self.device, stage_seconds=stats)

    def build_accel(self) -> None:
        """Pack the NSG base layer into the int8 record layout
        (models/records.py): one row gather a frontier expansion. The HNSW
        side needs no packing: the routed entry is one product."""
        if self.nsg is None:
            raise RuntimeError("call build_nsg_layer() before build_accel")
        self.nsg.build_accel()

    def search_knn(
        self, queries, k: int = 10, ef: int = 100, l_search: int | None = None,
        expand: int = 1, entry: str = "routed",
    ):
        """searchKnn (index_hnsw_nsg.h:107-151): the HNSW upper levels pick
        the entry node, then NSG SearchFromEnterpoint with an ef-sized
        pool.

        entry: "routed" (one product over the level>=1 nodes, see
        HNSWIndex._entry_points) or "descend" (the reference's per-level
        greedy walk). Returns (labels [Q, k] int64, dists [Q, k] exact),
        numpy."""
        if self.nsg is None:
            raise RuntimeError("call build_nsg_layer() before searching")
        h = self.hnsw
        q = as_f32_queries(queries, h.device)
        if entry == "descend":
            cur = h._descend_entry(q)
        else:
            cur = h._entry_points(q)
        d, ids = self.nsg.search_from_enterpoint(
            q, cur, k=k, l_search=max(l_search or ef, k), expand=expand,
        )
        ids_np = ids.cpu().numpy()
        labels = np.where(
            ids_np >= 0, h.labels[np.clip(ids_np, 0, None)], -1
        )
        return labels, d.cpu().numpy()

    # -- persistence (two sub-indices, like _hnsw.bin/_nsg.bin,
    # index_hnsw_nsg.h:153-159) --------------------------------------------

    def save(self, prefix: str) -> None:
        self.hnsw.save(prefix + "_hnsw.npz")
        if self.nsg is not None:
            self.nsg.save(prefix + "_nsg.npz")

    @classmethod
    def load(cls, prefix: str, nsg_cfg=NSGBuildConfig(),
             device=None) -> "HybridHNSWNSG":
        """Read the two files either package wrote onto ``device``
        (default: the card)."""
        hnsw = HNSWIndex.load(prefix + "_hnsw.npz", device=device)
        obj = cls.__new__(cls)
        obj.hnsw = hnsw
        obj.nsg_cfg = nsg_cfg
        obj.metric = hnsw.metric
        try:
            obj.nsg = NSGIndex.load(prefix + "_nsg.npz", hnsw.data[: hnsw.n])
        except FileNotFoundError:
            obj.nsg = None
        return obj
