"""hnswlib-compatible Python API.

Mirrors the pybind11 module surface (hnswlib/python_bindings/bindings.cpp:
913-1010): ``Index(space, dim)`` with init_index / add_items / knn_query /
set_ef / save_index / load_index / mark_deleted / unmark_deleted /
resize_index / get_items / get_ids_list / get_current_count /
get_max_elements / element properties, plus ``BFIndex``. A user of the
reference's ``import hnswlib`` can switch the import and keep their code.
Counterpart of hnsw_nsg_tpu/api.py.

Space semantics match bindings.cpp:157-177 and 241-249: "l2" -> squared L2,
"ip" -> 1 - <a,b>, "cosine" -> vectors normalized on add and query, distance
= 1 - cos. ``num_threads`` arguments are accepted for compatibility; batching
replaces threading.

Every class takes a keyword ``device`` last (the JAX package has none):
``None`` puts the index on the card and raises where no card is visible,
``"cpu"`` keeps it on the CPU. Inputs and results are numpy, as hnswlib's.

``Index.epsilon_query`` (range search) and ``MultiVectorIndex`` (top-k
distinct documents) run the disciplines of ``models/extensions.py``;
``add_items(replace_deleted=True)`` on an index made or loaded with
``allow_replace_deleted`` reuses deleted slots through
``HNSWIndex.replace_point``.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.hnsw import HNSWIndex
from .ops.bruteforce import brute_force_topk
from .ops.distance import as_f32_queries, normalize
from .utils.device import resolve_device
from .utils.params import HNSWConfig

VALID_SPACES = ("l2", "ip", "cosine")


class Index:
    """Drop-in analogue of ``hnswlib.Index``."""

    def __init__(self, space: str, dim: int, device=None):
        if space not in VALID_SPACES:
            raise ValueError(f"Space {space} not available")
        self.space = space
        self.dim = int(dim)
        self.device = device   # resolved when the index is made or loaded
        self._index: HNSWIndex | None = None
        self._replace_deleted = False
        self.ef = 10

    # -- lifecycle ---------------------------------------------------------

    def init_index(
        self,
        max_elements: int,
        M: int = 16,
        ef_construction: int = 200,
        random_seed: int = 100,
        allow_replace_deleted: bool = False,
    ) -> None:
        cfg = HNSWConfig(
            M=M, ef_construction=ef_construction, random_seed=random_seed,
            allow_replace_deleted=allow_replace_deleted,
        )
        self._index = HNSWIndex(self.dim, max_elements, cfg, self._metric,
                                device=self.device)
        self._replace_deleted = allow_replace_deleted

    @property
    def _metric(self) -> str:
        return "ip" if self.space in ("ip", "cosine") else "l2"

    def _require(self) -> HNSWIndex:
        if self._index is None:
            raise RuntimeError("Index not initialized (call init_index)")
        return self._index

    def _prep(self, data) -> np.ndarray:
        x = np.asarray(data, np.float32)
        if x.ndim == 1:
            x = x[None]
        if x.shape[1] != self.dim:
            raise ValueError("wrong dimensionality of the vectors")
        if self.space == "cosine":
            x = normalize(x)
        return x

    # -- mutation ----------------------------------------------------------

    def add_items(
        self, data, ids=None, num_threads: int = -1,
        replace_deleted: bool = False, batch_size: int = 4096,
    ) -> None:
        x = self._prep(data)
        idx = self._require()
        if replace_deleted:
            if not self._replace_deleted:
                raise RuntimeError(
                    "replace_deleted=True requires "
                    "allow_replace_deleted at init"
                )
            x, ids = self._replace_into_deleted(x, ids)
            if x.shape[0] == 0:
                return
        idx.add_items(x, ids, batch_size=batch_size)

    def _replace_into_deleted(self, x, ids):
        """addPoint(replace_deleted=true) semantics (hnswalg.h:954-992):
        the first deleted slots, in slot order, take as many of the new
        points as there are; returns the points and labels left over."""
        idx = self._require()
        dead = np.nonzero(idx.deleted[: idx.n])[0]
        take = min(len(dead), x.shape[0])
        if ids is None:
            ids = np.arange(idx.n, idx.n + x.shape[0], dtype=np.int64)
        ids = np.asarray(ids, np.int64).reshape(x.shape[0])
        for j in range(take):
            slot = int(dead[j])
            idx.label_to_id.pop(int(idx.labels[slot]), None)
            idx.replace_point(slot, x[j], int(ids[j]))
        return x[take:], ids[take:]

    def mark_deleted(self, label: int) -> None:
        self._require().mark_deleted(label)

    def unmark_deleted(self, label: int) -> None:
        self._require().unmark_deleted(label)

    def resize_index(self, new_size: int) -> None:
        self._require().resize_index(new_size)

    def set_ef(self, ef: int) -> None:
        self.ef = int(ef)

    def set_num_threads(self, n: int) -> None:
        pass  # batching replaces threads

    # -- queries -----------------------------------------------------------

    def knn_query(
        self, data, k: int = 1, num_threads: int = -1, filter=None,
        ef: int | None = None,
    ):
        """Returns (labels [Q, k] int64, distances [Q, k] f32) like
        knnQuery_return_numpy (bindings.cpp:612-)."""
        x = self._prep(data)
        idx = self._require()
        if k > idx.n - idx.num_deleted:
            raise RuntimeError(
                "Cannot return the results in a contiguous 2D array. "
                "Probably ef or M is too small"
            )  # reference wording for insufficient results
        filter_ids = None
        if filter is not None:
            labels_arr = idx.labels[: idx.cap]
            filter_ids = np.zeros(idx.cap, bool)
            valid = labels_arr >= 0
            filter_ids[valid] = [bool(filter(int(l)))
                                 for l in labels_arr[valid]]
        labels, dists = idx.knn_query(
            x, k=k, ef=max(ef or self.ef, k), filter_ids=filter_ids
        )
        return labels, dists

    def epsilon_query(self, data, epsilon: float,
                      max_candidates: int = 128):
        """Range search (EpsilonSearchStopCondition semantics,
        stop_condition.h:218-275 via searchStopConditionClosest,
        hnswalg.h:1327-1378): all points with distance <= epsilon among
        the max_candidates closest explored. Returns (labels [Q, C]
        -1-padded, dists [Q, C], counts [Q])."""
        x = self._prep(data)
        return self._require().epsilon_query(x, epsilon, max_candidates)

    def get_items(self, ids) -> np.ndarray:
        return self._require().get_items(ids)

    def get_ids_list(self):
        return self._require().get_ids_list()

    def get_current_count(self) -> int:
        return self._require().n

    def get_max_elements(self) -> int:
        return self._require().max_elements

    @property
    def element_count(self) -> int:
        return self._require().n

    @property
    def max_elements(self) -> int:
        return self._require().max_elements

    # -- persistence -------------------------------------------------------

    def save_index(self, path: str) -> None:
        """Write the index at exactly ``path`` in the reference's binary
        format (hnswalg.h:685-713) — a file stock hnswlib can load, and
        vice versa. The native .npz container stays available through
        ``HNSWIndex.save`` for internal artifacts."""
        self._require().save_hnswlib_format(path)

    def load_index(
        self, path: str, max_elements: int = 0,
        allow_replace_deleted: bool = False,
    ) -> None:
        """Load either a reference/hnswlib binary index or a native .npz
        (sniffed by the zip magic that np.savez always writes)."""
        with open(path, "rb") as f:
            magic = f.read(4)
        if magic[:2] == b"PK":
            self._index = HNSWIndex.load(path, max_elements or None,
                                         device=self.device)
        else:
            self._index = HNSWIndex.load_hnswlib_format(
                path, metric=self._metric,
                max_elements=max_elements or None, device=self.device,
            )
        self._replace_deleted = allow_replace_deleted

    # -- pickle (bindings.cpp getAnnData/setAnnData, :351-610, 978-987) ----

    def __getstate__(self):
        """The index as numpy arrays and the device as it was asked for
        (never a resolved card, never a tensor): a pickle made on the card
        loads where ``device`` resolves on the reading side."""
        state = {"space": self.space, "dim": self.dim, "ef": self.ef,
                 "device": None if self.device is None else str(self.device),
                 "_replace_deleted": self._replace_deleted,
                 "index": None}
        if self._index is not None:
            idx = self._index
            state["index"] = dict(
                idx._arrays(),
                meta=(idx.n, idx.cap, idx.max_level, idx.ep, idx.cfg.M,
                      idx.cfg.ef_construction, idx.num_deleted, idx.metric),
            )
        return state

    def __setstate__(self, state):
        self.space = state["space"]
        self.dim = state["dim"]
        self.ef = state["ef"]
        self.device = state["device"]
        self._replace_deleted = state.get("_replace_deleted", False)
        self._index = None
        s = state["index"]
        if s is None:
            return
        n, cap, max_level, ep, m, efc, ndel, metric = s["meta"]
        self._index = HNSWIndex._from_arrays(
            s["data"], s["adj0"], s["adj_up"], s["levels"], s["labels"],
            s["deleted"], cap=cap, cfg=HNSWConfig(M=m, ef_construction=efc),
            metric=metric, max_level=max_level, ep=ep, device=self.device)


class LazyIndex(Index):
    """hnswlib/python_bindings/LazyIndex.py parity: init_index is deferred
    until the first add_items; init parameters may be passed up front."""

    def __init__(self, space: str, dim: int, max_elements: int = 1024,
                 device=None, **kwargs):
        super().__init__(space, dim, device=device)
        self.init_max_elements = max_elements
        self.init_kwargs = kwargs

    def init_index(self, max_elements: int = 0, **kwargs):
        if max_elements:
            self.init_max_elements = max_elements
        if kwargs:
            self.init_kwargs = kwargs
        super().init_index(self.init_max_elements, **self.init_kwargs)

    def add_items(self, data, ids=None, **kwargs):
        if self._index is None:
            self.init_index()
        n_needed = self._index.n + np.atleast_2d(np.asarray(data)).shape[0]
        if n_needed > self._index.cap:
            self._index.resize_index(max(n_needed, 2 * self._index.cap))
        super().add_items(data, ids, **kwargs)

    def knn_query(self, data, k: int = 1, **kwargs):
        if self._index is None:
            raise RuntimeError("index is empty")
        return super().knn_query(data, k, **kwargs)


class BFIndex:
    """Drop-in analogue of ``hnswlib.BFIndex`` (bindings.cpp:725-):
    exact search over a flat store."""

    def __init__(self, space: str, dim: int, device=None):
        if space not in VALID_SPACES:
            raise ValueError(f"Space {space} not available")
        self.space = space
        self.dim = int(dim)
        self.device = device   # the store is numpy; a query runs here
        self._x: np.ndarray | None = None
        self._labels: np.ndarray | None = None

    def init_index(self, max_elements: int) -> None:
        self.cap = int(max_elements)
        self._x = np.zeros((0, self.dim), np.float32)
        self._labels = np.zeros((0,), np.int64)

    def _prep(self, data) -> np.ndarray:
        x = np.asarray(data, np.float32)
        if x.ndim == 1:
            x = x[None]
        if self.space == "cosine":
            x = normalize(x)
        return x

    def add_items(self, data, ids=None) -> None:
        x = self._prep(data)
        if self._x is None:
            raise RuntimeError("Index not initialized")
        if len(self._x) + len(x) > self.cap:
            raise RuntimeError(
                "The number of elements exceeds the specified limit"
            )
        if ids is None:
            ids = np.arange(len(self._labels),
                            len(self._labels) + len(x), dtype=np.int64)
        self._x = np.concatenate([self._x, x])
        self._labels = np.concatenate(
            [self._labels, np.asarray(ids, np.int64).reshape(len(x))]
        )

    def delete_vector(self, label: int) -> None:
        """Swap-with-last removal (bruteforce.h:64-103)."""
        pos = int(np.nonzero(self._labels == label)[0][0])
        self._x[pos] = self._x[-1]
        self._labels[pos] = self._labels[-1]
        self._x = self._x[:-1]
        self._labels = self._labels[:-1]

    def knn_query(self, data, k: int = 1):
        x = self._prep(data)
        metric = "ip" if self.space in ("ip", "cosine") else "l2"
        dev = resolve_device(self.device)
        d, i = brute_force_topk(torch.from_numpy(x).to(dev),
                                torch.from_numpy(self._x).to(dev), k,
                                metric=metric)
        i = i.cpu().numpy()
        labels = np.where(i >= 0, self._labels[np.clip(i, 0, None)], -1)
        return labels, d.cpu().numpy()

    def save_index(self, path: str) -> None:
        with open(path, "wb") as f:  # file object: exact path, no ".npz"
            np.savez(f, x=self._x, labels=self._labels, cap=self.cap,
                     space=self.space)

    def load_index(self, path: str, max_elements: int = 0) -> None:
        z = np.load(path, allow_pickle=False)
        self._x = z["x"]
        self._labels = z["labels"]
        self.cap = max(int(z["cap"]), max_elements)


class MultiVectorIndex(Index):
    """Multivector document retrieval.

    Reference: ``MultiVectorL2Space/InnerProductSpace`` append a document
    id to each stored vector and ``MultiVectorSearchStopCondition``
    returns the top-k distinct documents, each scored by its closest
    vector (hnswlib/hnswlib/stop_condition.h:10-215). Here the document
    id travels in a side array: the graph is a plain vector-level HNSW,
    and the distinct-document top-k is applied to the level-0 beam
    (``models/extensions.topk_distinct_docs``)."""

    def add_items(self, data, doc_ids, ids=None, **kwargs) -> None:
        idx = self._require()
        if not hasattr(self, "_docs"):
            self._docs = np.full(idx.cap, -1, np.int64)
        start = idx.n
        super().add_items(data, ids=ids, **kwargs)
        docs = np.asarray(doc_ids, np.int64).reshape(-1)
        if len(docs) != idx.n - start:
            raise ValueError("doc_ids must have one entry per vector")
        if idx.cap > len(self._docs):
            grown = np.full(idx.cap, -1, np.int64)
            grown[: len(self._docs)] = self._docs
            self._docs = grown
        self._docs[start : idx.n] = docs

    def knn_doc_query(self, data, k: int = 1, ef: int | None = None):
        """Top-k distinct documents: the per-level greedy descent to a
        level-0 entry, then a beam of width max(ef, 4k) and the
        distinct-document top-k. Returns (doc_ids [Q, k] int64 -1-padded,
        dists [Q, k]), numpy."""
        from .models.beam import greedy_descent
        from .models.extensions import multivector_search

        x = self._prep(data)
        idx = self._require()
        q = as_f32_queries(x, idx.device)
        cur = torch.full((q.shape[0],), idx.ep, dtype=torch.int32,
                         device=idx.device)
        for lvl in range(idx.max_level, 0, -1):
            cur, _ = greedy_descent(q, idx.data, idx.norms,
                                    idx.adj_up[lvl - 1], cur,
                                    metric=idx.metric)
        width = max(ef or self.ef, 4 * k)
        d, docs, _ = multivector_search(
            q, idx.data, idx.norms, idx.adj0, cur[:, None],
            torch.from_numpy(self._docs).to(idx.device), k, width=width,
            metric=idx.metric)
        return docs.cpu().numpy(), d.cpu().numpy()
