"""Search extensions: epsilon (range) search and multivector document
retrieval (counterpart of hnsw_nsg_tpu/models/extensions.py).

Reference: hnswlib/hnswlib/stop_condition.h:
  * ``EpsilonSearchStopCondition`` (:218-275): every point with distance
    <= epsilon, exploring at most max_num_candidates (driven through
    searchStopConditionClosest, hnswalg.h:1327-1378);
  * ``MultiVectorSearchStopCondition`` (:146-215) over
    ``MultiVectorL2Space/InnerProductSpace`` (:10-143): vectors belong to
    documents, and a search returns the top-k distinct documents, each
    scored by its closest vector.

Both are disciplines applied after the same fixed-width lockstep beam
(``beam_search_chunked``, whose hops run the fused merge+select): an
epsilon filter, where the beam width plays max_num_candidates, and a
best-vector-per-document top-k. The document top-k breaks ties by
position with a stable sort, where the JAX package's ``lax.top_k`` keeps
the lower index among equals: the same order.
"""

from __future__ import annotations

import torch

from ..ops.distance import PAD_DIST, PAD_ID, squared_norms
from ..ops.topk import mask_internal_dups, topk_smallest
from .beam import beam_search_chunked


def filter_epsilon(dists: torch.Tensor, ids: torch.Tensor, epsilon: float):
    """Keep only entries with dist <= epsilon (rows stay sorted and
    PAD-padded). Returns (dists, ids, counts [Q] int32)."""
    keep = (ids >= 0) & (dists <= epsilon)
    d = torch.where(keep, dists, PAD_DIST)
    i = torch.where(keep, ids, PAD_ID)
    return d, i, keep.sum(-1, dtype=torch.int32)


def epsilon_search(queries, data, norms, adj, init_ids, epsilon: float,
                   max_candidates: int, metric: str = "l2",
                   max_hops: int = 512, expand: int = 1):
    """Graph range search: a beam of width ``max_candidates``, then the
    epsilon filter; distances exact. Everything within epsilon among the
    ``max_candidates`` closest found is returned (searchStopCondition-
    Closest + EpsilonSearchStopCondition). Returns (dists, ids, counts)."""
    res = beam_search_chunked(queries, data, norms, adj, init_ids,
                              width=max_candidates, metric=metric,
                              max_hops=max_hops, expand=expand)
    d = res.dists
    if metric == "l2":
        d = d + squared_norms(queries)[:, None]
    return filter_epsilon(d, res.ids, epsilon)


def topk_distinct_docs(dists: torch.Tensor, ids: torch.Tensor,
                       doc_ids: torch.Tensor, k: int):
    """Best-vector-per-document top-k.

    dists/ids: [Q, L] distance-sorted beam results (vector ids); doc_ids
    [N]: vector id -> document id. Returns (doc_dists [Q, k'], docs
    [Q, k'], vec_ids [Q, k']) with k' = min(k, L), ascending and
    PAD-padded: the MultiVectorSearchStopCondition contract. A row holds
    each document once, with its first (closest) vector; equal distances
    keep their row order."""
    docs = torch.where(ids >= 0, doc_ids[ids.clamp(min=0).long()], PAD_ID)
    # rows are distance-sorted, so a document's first occurrence is its best
    # (an O(L^2) mask per row; L is the beam width)
    dup = mask_internal_dups(docs)
    d = torch.where(dup | (docs < 0), PAD_DIST, dists)
    out_d, idx = topk_smallest(d, torch.arange(
        d.shape[1], device=d.device).expand_as(d), min(k, d.shape[1]))
    live = out_d < PAD_DIST
    out_docs = torch.where(live, torch.gather(docs, 1, idx), PAD_ID)
    out_vecs = torch.where(live, torch.gather(ids, 1, idx), PAD_ID)
    return out_d, out_docs, out_vecs


def multivector_search(queries, data, norms, adj, init_ids, doc_ids, k: int,
                       width: int | None = None, metric: str = "l2",
                       max_hops: int = 512, expand: int = 1):
    """Top-k distinct documents by graph search over the vectors: a beam
    of ``width`` (default max(4k, 32)), then ``topk_distinct_docs``."""
    width = width or max(4 * k, 32)
    res = beam_search_chunked(queries, data, norms, adj, init_ids,
                              width=width, metric=metric, max_hops=max_hops,
                              expand=expand)
    d = res.dists
    if metric == "l2":
        d = d + squared_norms(queries)[:, None]
    return topk_distinct_docs(d, res.ids, doc_ids.to(d.device), k)
