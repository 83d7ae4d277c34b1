"""Inline neighbour-record layout and its beam, and the exact re-rank
(counterpart of hnsw_nsg_tpu/models/inline_graph.py).

The analogue of the reference's ``OptimizeGraph``/``SearchWithOptGraph``
(CNNS/src/nsg/index_nsg.cpp:570-682): per node, its R neighbours'
vectors, ids and norms stored contiguously, so a frontier expansion
gathers one fat row instead of R scattered ones:

  * ``recs``   [N, R, d]  (bf16 by default) - neighbour vectors,
  * ``nids``   [N, R] int32                 - neighbour ids (PAD_ID padded),
  * ``nnorms`` [N, R] f32                   - neighbour squared norms.

Traversal distances are d = ||x||^2 - 2<q, x> with the query rounded to
the record dtype, the products exact and summed in f32 (``f32_dots``),
and the norm exact; callers re-rank exactly with ``rerank_exact``. The
layout is derived state: the compact adjacency stays the source of truth.

The JAX package selects the frontier at the start of each hop and merges
with ``merge_into_retset``; here each hop merges and selects the next
frontier in one ``fused_merge_select`` (bit for bit that composition), on
the expand-first skeleton of ``beam.beam_search_chunked``. The returned
(dists, ids, hops, evals) are the same; converged queries are compacted
out between chunks, which changes no result. Not carried over: the
``lax.scan`` chunk program and the donated chunked fill.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.distance import (PAD_DIST, PAD_ID, f32_dots, gathered_dists,
                            squared_norms)
from ..ops.topk import topk_smallest
from .beam import BeamResult, _start, run_chunks


class InlineGraph(NamedTuple):
    """Derived search-time layout (see module docstring)."""

    recs: torch.Tensor     # [N, R, d] rec dtype - neighbour vectors
    nids: torch.Tensor     # [N, R] int32 - neighbour ids (PAD_ID padded)
    nnorms: torch.Tensor   # [N, R] f32 - neighbour norms (pads: PAD_DIST)

    @property
    def n(self) -> int:
        return self.recs.shape[0]

    @property
    def degree(self) -> int:
        return self.recs.shape[1]

    def nbytes(self) -> int:
        return (self.recs.numel() * self.recs.element_size()
                + self.nids.numel() * 4 + self.nnorms.numel() * 4)


def build_inline_graph(
    data: torch.Tensor,
    adj: torch.Tensor,
    norms: torch.Tensor | None = None,
    rec_dtype=torch.bfloat16,
    chunk: int = 1 << 17,
) -> InlineGraph:
    """Derive the inline record layout from (data, padded adjacency), on
    the data's device, ``chunk`` nodes at a time."""
    n, r = adj.shape
    adj = adj.to(device=data.device, dtype=torch.int32)
    data_c = data.to(rec_dtype)
    if norms is None:
        norms = squared_norms(data)
    ok = adj >= 0
    safe = torch.where(ok, adj, 0).long()
    recs = torch.empty((n, r, data.shape[1]), dtype=rec_dtype,
                       device=data.device)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        recs[s:e] = data_c[safe[s:e]].masked_fill(~ok[s:e, :, None], 0)
    nnorms = torch.where(ok, norms[safe], PAD_DIST)
    return InlineGraph(recs=recs, nids=adj, nnorms=nnorms)


def beam_search_inline(
    queries: torch.Tensor,
    data: torch.Tensor,
    norms: torch.Tensor,
    g: InlineGraph,
    init_ids: torch.Tensor,
    width: int,
    metric: str = "l2",
    max_hops: int = 512,
    expand: int = 1,
    chunk_hops: int = 16,
    min_compact: int = 256,
) -> BeamResult:
    """Lockstep best-first search over the inline record layout.

    Semantics match ``beam.beam_search_chunked``; init_ids [Q, I] are
    scored exactly. Hop distances are FastL2-form f32 from the record
    dtype's products; callers needing exact values re-rank with
    ``rerank_exact``."""
    init_ids = init_ids.to(torch.int32)
    state = _start(queries, data, norms, init_ids, width, metric, expand)[1:]

    def hop(q_lo, sel_ids, sel_valid):
        safe = sel_ids.clamp(min=0).long()
        vr = g.recs[safe]                             # [Q, E, R, d]
        n_q, e, r, d = vr.shape
        dots = f32_dots(vr.reshape(n_q, e * r, d), q_lo[:, None, :])[..., 0]
        if metric in ("ip", "cosine"):
            cd = 1.0 - dots
        else:
            cd = g.nnorms[safe].reshape(n_q, -1) - 2.0 * dots
        ci = torch.where(sel_valid[:, :, None], g.nids[safe],
                         PAD_ID).reshape(n_q, -1)
        return torch.where(ci >= 0, cd, PAD_DIST), ci

    return run_chunks(queries.to(g.recs.dtype), state, hop, width, max_hops,
                      expand, chunk_hops, min_compact)


def rerank_exact(q, data, norms, ids, k: int, metric: str = "l2"):
    """Exact f32 re-distance of candidate ids + top-k (ties in position
    order). The int8 and bf16 traversals can misorder near-ties; one exact
    gathered distance block over the final retset head restores the exact
    ranking (the reference's exact re-distance in the CNNS search,
    cluster_hnsw_nsg_search.cpp:210-235, plays the same role). Returns
    (dists [Q, k] exact metric values, ids [Q, k])."""
    d = gathered_dists(q, data, ids, metric, norms, exact=True)
    return topk_smallest(d, ids, k)
