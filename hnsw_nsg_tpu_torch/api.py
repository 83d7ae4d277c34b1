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

Waiting for their modules: ``MultiVectorIndex`` and ``Index.epsilon_query``
(``models/extensions.py``), ``allow_replace_deleted`` with
``add_items(replace_deleted=True)`` (``HNSWIndex.replace_point``).
"""

from __future__ import annotations

import numpy as np
import torch

from .models.hnsw import HNSWIndex
from .ops.bruteforce import brute_force_topk
from .ops.distance import normalize
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
        if allow_replace_deleted:
            _replace_not_ported()
        cfg = HNSWConfig(
            M=M, ef_construction=ef_construction, random_seed=random_seed,
        )
        self._index = HNSWIndex(self.dim, max_elements, cfg, self._metric,
                                device=self.device)

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
            # (allow_replace_deleted is refused at init_index and load_index,
            # so the flag is never set)
            raise RuntimeError(
                "replace_deleted=True requires "
                "allow_replace_deleted at init"
            )
        idx.add_items(x, ids, batch_size=batch_size)

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
        raise NotImplementedError(
            "Index.epsilon_query needs models/extensions.py "
            "(epsilon_search), which is not ported yet (ROADMAP.md Queue 1 "
            "step 7)")

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
        if allow_replace_deleted:
            _replace_not_ported()
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

    # -- pickle (bindings.cpp getAnnData/setAnnData, :351-610, 978-987) ----

    def __getstate__(self):
        """The index as numpy arrays and the device as it was asked for
        (never a resolved card, never a tensor): a pickle made on the card
        loads where ``device`` resolves on the reading side."""
        state = {"space": self.space, "dim": self.dim, "ef": self.ef,
                 "device": None if self.device is None else str(self.device),
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
        self._index = None
        s = state["index"]
        if s is None:
            return
        n, cap, max_level, ep, m, efc, ndel, metric = s["meta"]
        self._index = HNSWIndex._from_arrays(
            s["data"], s["adj0"], s["adj_up"], s["levels"], s["labels"],
            s["deleted"], cap=cap, cfg=HNSWConfig(M=m, ef_construction=efc),
            metric=metric, max_level=max_level, ep=ep, device=self.device)


def _replace_not_ported():
    raise NotImplementedError(
        "allow_replace_deleted needs HNSWIndex.replace_point (slot reuse "
        "with in-link repair), which is not ported yet (ROADMAP.md Queue 1 "
        "step 7)")


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
    """Multivector document retrieval (top-k distinct documents, each
    scored by its closest vector). Not ported."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "MultiVectorIndex needs models/extensions.py "
            "(multivector_search), which is not ported yet (ROADMAP.md "
            "Queue 1 step 7)")
