"""Batched graph traversal: the lockstep best-first beam
(counterpart of hnsw_nsg_tpu/models/beam.py).

Q queries advance together. Each hop gathers the frontier nodes'
padded adjacency rows, computes the gathered distances (f32 products,
TF32 off) and merges them into per-query sorted retsets with
``fused_merge_select`` (``ops/merge_select.py``): the CUDA kernel on a
card, its plain composition on the CPU. A sorted top-L retset only
improves its L-th distance, so an evicted node never re-enters, and the
expanded flags keep each occupant from being expanded twice: retset
dedup replaces the reference's visited list (NSG ``Search``,
CNNS/src/nsg/index_nsg.cpp:506-568; hnswlib ``searchBaseLayerST``).

Hops run in chunks of ``chunk_hops`` with one host convergence check
per chunk, as in the JAX package. ``beam_search_chunked`` compacts
converged queries out between chunks and scatters their results back;
it compacts to exactly the live rows, where the TPU padded the batch to
a power of two to bound recompiles (no result depends on it).

``greedy_descent`` (hnswlib's upper-level walk) and
``beam_search_filtered`` (in-traversal filtering) are plain functions on
tensors, as in the JAX package, where neither reaches the kernel: the
filtered beam kills frontier slots between its merge and its select, and
its width can grow to N. Their loops test for convergence on the host
every few hops; a hop after convergence changes nothing, so the results
are those of a test every hop.

The JAX package's while-loop ``beam_search`` (for callers inside one
compiled program) runs here on the same chunked loop: its fused
merge+select is ``merge_into_retset`` then ``_select_frontier`` bit for
bit, so select-expand-merge hops equal the expand-first chunked ones,
and only its stopping rule (the largest per-query hop count, not the
count of loop turns) is its own. ``random_fill_ids`` draws from a
``torch.Generator``. The while-loop ``beam_search_collect`` runs on the
same loop with its pool folded in each hop and no compaction.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.distance import PAD_DIST, PAD_ID, gathered_dists
from ..ops.merge_select import fused_merge_select
from ..ops.topk import init_retset, merge_into_retset

_CHECK_EVERY = 4   # hops between host convergence tests of the plain loops


class BeamResult(NamedTuple):
    dists: torch.Tensor   # [Q, L] ascending (FastL2 values for metric="l2")
    ids: torch.Tensor     # [Q, L] PAD_ID-padded
    hops: torch.Tensor    # [Q] int32: frontier expansions performed
    evals: torch.Tensor   # [Q] int32: distance computations performed


def _select_frontier(ids, expanded, expand: int):
    """Pick the first `expand` unexpanded slots per query (the retset is
    sorted, so these are the closest unexpanded candidates). Returns
    (sel_ids [Q, expand] with PAD_ID where invalid, sel_valid, the new
    expanded flags)."""
    width = ids.shape[1]
    unexp = ~expanded
    slot = torch.arange(width, dtype=torch.int32, device=ids.device)
    key = torch.where(unexp, slot, width)
    # smallest keys first, ties (the invalid picks) in slot order
    idxs = torch.sort(key, dim=1, stable=True).indices[:, :expand]
    sel_valid = torch.gather(unexp, 1, idxs)
    sel_ids = torch.where(sel_valid, torch.gather(ids, 1, idxs), PAD_ID)
    new_expanded = expanded.scatter(
        1, idxs, torch.gather(expanded, 1, idxs) | sel_valid)
    return sel_ids, sel_valid, new_expanded


def _expand(adj, sel_ids, sel_valid):
    """Neighbor ids of the frontier, [Q, expand * R], PAD where invalid."""
    nbrs = adj[sel_ids.clamp(min=0).long()]
    nbrs = torch.where(sel_valid[:, :, None], nbrs, PAD_ID)
    return nbrs.reshape(sel_ids.shape[0], -1)


def _hop_counts(hops, evals, sel_valid, nbrs):
    hops += sel_valid.sum(1, dtype=torch.int32)
    evals += (nbrs >= 0).sum(1, dtype=torch.int32)


def _start(q, data, norms, init_ids, width, metric, expand):
    init_d = gathered_dists(q, data, init_ids, metric, norms)
    r_d, r_i, r_e = init_retset(init_d, init_ids, width)
    qn = q.shape[0]
    hops = torch.zeros(qn, dtype=torch.int32, device=q.device)
    evals = (init_ids >= 0).sum(1, dtype=torch.int32)
    sel_ids, sel_valid, r_e = _select_frontier(r_i, r_e, expand)
    return init_d, r_d, r_i, r_e, sel_ids, sel_valid, hops, evals


def beam_search_chunked(
    queries: torch.Tensor,
    data: torch.Tensor,
    norms: torch.Tensor,
    adj: torch.Tensor,
    init_ids: torch.Tensor,
    width: int,
    metric: str = "l2",
    max_hops: int = 512,
    expand: int = 1,
    chunk_hops: int = 32,
    min_compact: int = 256,
) -> BeamResult:
    """Lockstep best-first search over a padded-adjacency graph.

    queries [Q, d]; data [N, d]; norms [N] (l2); adj [N, R] int32
    PAD_ID-padded; init_ids [Q, I] int32; width = retset width L. All on
    one device. Returns distances in FastL2 form for metric="l2" (exact =
    + ||q||^2). At most ``max_hops`` hops; converged queries leave the
    batch between chunks once the live count (at least ``min_compact``)
    is at most half the batch."""
    return _adj_beam(queries, data, norms, adj, init_ids, width, metric,
                     max_hops, expand, chunk_hops, min_compact, None)


def beam_search(
    queries: torch.Tensor,
    data: torch.Tensor,
    norms: torch.Tensor,
    adj: torch.Tensor,
    init_ids: torch.Tensor,
    width: int,
    metric: str = "l2",
    max_hops: int = 512,
    expand: int = 1,
) -> BeamResult:
    """The JAX package's while-loop beam (beam.py:73-127): arguments and
    results as ``beam_search_chunked``. Its loop turns while some query
    has an unexpanded retset slot and the LARGEST per-query hop count is
    below ``max_hops``; with ``expand`` = 1 that is the chunked beam's
    count of hops, above 1 it can stop sooner. Ids, distances, hops and
    evaluations equal the JAX function's."""
    return _adj_beam(queries, data, norms, adj, init_ids, width, metric,
                     max_hops, expand, 32, 256, max_hops)


def _adj_beam(queries, data, norms, adj, init_ids, width, metric, max_hops,
              expand, chunk_hops, min_compact, hop_limit):
    init_ids = init_ids.to(torch.int32)
    state = _start(queries, data, norms, init_ids, width, metric, expand)[1:]

    def hop(q, sel_ids, sel_valid):
        nbrs = _expand(adj, sel_ids, sel_valid)
        return gathered_dists(q, data, nbrs, metric, norms), nbrs

    return run_chunks(queries, state, hop, width, max_hops, expand,
                      chunk_hops, min_compact, hop_limit)


def run_chunks(q, state, hop, width: int, max_hops: int, expand: int,
               chunk_hops: int, min_compact: int,
               hop_limit: int | None = None) -> BeamResult:
    """The expand-first hop loop of the chunked beams, with compaction.

    ``state`` = (r_d, r_i, r_e, sel_ids, sel_valid, hops, evals) after the
    first frontier pick; ``hop(q, sel_ids, sel_valid)`` returns the
    frontier's candidates (dists [Q', C], ids [Q', C], PAD where invalid)
    for the rows of ``q``, a per-query tensor that is compacted with the
    state. Each hop folds them in with ``fused_merge_select``. One host
    check a chunk; converged rows leave the batch once the live count (at
    least ``min_compact``) is at most half of it, and are scattered back
    to their slots at the end. ``hop_limit``: a hop expands nothing once
    the largest hop count of any query, compacted ones included, has
    reached it (the while-loop beam's rule)."""
    r_d, r_i, r_e, sel_ids, sel_valid, hops, evals = state
    qn = q.shape[0]
    dev = q.device
    final = None
    orig = torch.arange(qn, device=dev)
    cur_q = qn
    hops_left = max_hops
    top = torch.zeros((), dtype=torch.int32, device=dev)  # largest hop count
    while hops_left > 0:
        n_hops = min(chunk_hops, hops_left)
        for _ in range(n_hops):
            if hop_limit is not None:
                sel_valid = sel_valid & (top < hop_limit)
            cd, ci = hop(q, sel_ids, sel_valid)
            _hop_counts(hops, evals, sel_valid, ci)
            if hop_limit is not None:
                top = torch.maximum(top, hops.max())
            r_d, r_i, r_e, sel_ids, sel_valid = fused_merge_select(
                r_d, r_i, r_e, cd, ci, expand)
        hops_left -= n_hops
        act = sel_valid.any(1)
        n_act = int(act.sum())
        if n_act == 0 or (hop_limit is not None
                          and int(top) >= hop_limit):
            break
        if max(min_compact, n_act) <= cur_q // 2 and hops_left > 0:
            if final is None:
                final = (torch.zeros((qn, width), device=dev),
                         torch.full((qn, width), PAD_ID, dtype=torch.int32,
                                    device=dev),
                         torch.zeros(qn, dtype=torch.int32, device=dev),
                         torch.zeros(qn, dtype=torch.int32, device=dev))
            for buf, val in zip(final, (r_d, r_i, hops, evals)):
                buf[orig] = val
            keep = act.nonzero()[:, 0]
            q, r_d, r_i, r_e, sel_ids, sel_valid, hops, evals, orig = (
                t[keep] for t in (q, r_d, r_i, r_e, sel_ids, sel_valid,
                                  hops, evals, orig))
            cur_q = n_act
    if final is None:
        return BeamResult(r_d, r_i, hops, evals)
    for buf, val in zip(final, (r_d, r_i, hops, evals)):
        buf[orig] = val
    return BeamResult(*final)


def beam_search_collect_chunked(
    queries: torch.Tensor,
    data: torch.Tensor,
    norms: torch.Tensor,
    adj: torch.Tensor,
    init_ids: torch.Tensor,
    width: int,
    collect: int,
    metric: str = "l2",
    max_hops: int = 512,
    expand: int = 1,
    chunk_hops: int = 32,
):
    """beam_search_chunked that also keeps the closest ``collect``
    evaluated (id, dist) pairs: the reference's ``get_neighbors`` fullset
    feeding ``sync_prune`` (index_nsg.cpp:150-285), bounded to a sorted
    top-``collect`` pool. The pool folds every hop's candidates with the
    same fused merge and a throwaway selection (its expanded flags are
    reset to False every hop). No compaction: build-time only.

    Returns (BeamResult, pool_ids [Q, collect], pool_dists [Q, collect])."""
    q = queries
    init_ids = init_ids.to(torch.int32)
    (init_d, r_d, r_i, r_e, sel_ids, sel_valid, hops,
     evals) = _start(q, data, norms, init_ids, width, metric, expand)
    p_d, p_i, _ = init_retset(init_d, init_ids, collect)
    p_e0 = torch.zeros(p_d.shape, dtype=torch.bool, device=q.device)
    hops_left = max_hops
    while hops_left > 0:
        n_hops = min(chunk_hops, hops_left)
        for _ in range(n_hops):
            nbrs = _expand(adj, sel_ids, sel_valid)
            cd = gathered_dists(q, data, nbrs, metric, norms)
            _hop_counts(hops, evals, sel_valid, nbrs)
            p_d, p_i, _, _, _ = fused_merge_select(p_d, p_i, p_e0, cd, nbrs,
                                                   1)
            r_d, r_i, r_e, sel_ids, sel_valid = fused_merge_select(
                r_d, r_i, r_e, cd, nbrs, expand)
        hops_left -= n_hops
        if not bool(sel_valid.any()):
            break
    return BeamResult(r_d, r_i, hops, evals), p_i, p_d


def greedy_descent(
    queries: torch.Tensor,
    data: torch.Tensor,
    norms: torch.Tensor,
    adj: torch.Tensor,
    start_ids: torch.Tensor,
    metric: str = "l2",
    max_hops: int = 256,
):
    """Batched 1-best greedy walk (hnswlib upper-level descent,
    hnswalg.h:1278-1303): move to the closest neighbor while it improves;
    among equally close neighbors the first in the row wins.

    queries [Q, d]; start_ids [Q] int32. Returns (ids [Q] int32, dists [Q])
    with dists in FastL2 form for l2."""
    cur = start_ids.to(torch.int32)
    cur_d = gathered_dists(queries, data, cur[:, None], metric, norms)[:, 0]
    for it in range(max_hops):
        nbrs = adj[cur.clamp(min=0).long()]                  # [Q, R]
        nd = gathered_dists(queries, data, nbrs, metric, norms)
        best = nd.argmin(1, keepdim=True)     # the first of equal minima
        best_d = torch.gather(nd, 1, best)[:, 0]
        best_id = torch.gather(nbrs, 1, best)[:, 0]
        moved = best_d < cur_d
        cur = torch.where(moved, best_id, cur)
        cur_d = torch.where(moved, best_d, cur_d)
        if it % _CHECK_EVERY == _CHECK_EVERY - 1 and not bool(moved.any()):
            break
    return cur, cur_d


def beam_search_filtered(
    queries: torch.Tensor,
    data: torch.Tensor,
    norms: torch.Tensor,
    adj: torch.Tensor,
    init_ids: torch.Tensor,
    width: int,
    accept: torch.Tensor,
    metric: str = "l2",
    max_hops: int = 512,
    expand: int = 1,
) -> BeamResult:
    """Lockstep beam with in-traversal filtering.

    ``accept``: bool [N], the nodes allowed in results (filter pass and
    not deleted). Rejected nodes are still traversed but never enter the
    result pool, and exploration goes on until ``width`` accepted results
    exist or the frontier is exhausted: hnswlib's searchBaseLayerST<false>
    (hnswalg.h:309-440). A query is live while it has an unexpanded
    candidate closer than the accepted pool's ``width``-th distance
    (PAD_DIST while the pool is not full); frontier slots at or beyond
    that bound are killed before each selection.

    Returns the ACCEPTED pool (dists FastL2-form for l2, ids PAD-padded);
    hops and evals count as in beam_search_chunked."""
    q = queries
    init_ids = init_ids.to(torch.int32)
    init_d = gathered_dists(q, data, init_ids, metric, norms)
    r_d, r_i, r_e = init_retset(init_d, init_ids, width)
    acc = accept.to(device=q.device, dtype=torch.bool)

    def accepted_only(d, i):
        ok = acc[i.clamp(min=0).long()] & (i >= 0)
        return torch.where(ok, d, PAD_DIST), torch.where(ok, i, PAD_ID)

    p_d, p_i, _ = init_retset(*accepted_only(init_d, init_ids), width)
    p_e = torch.zeros_like(p_i, dtype=torch.bool)
    hops = torch.zeros(q.shape[0], dtype=torch.int32, device=q.device)
    evals = (init_ids >= 0).sum(1, dtype=torch.int32)
    for it in range(max_hops):
        bound = p_d[:, -1:]
        if it % _CHECK_EVERY == 0 and not bool((~r_e & (r_d < bound)).any()):
            break
        r_e = r_e | (r_d >= bound)
        sel_ids, sel_valid, r_e = _select_frontier(r_i, r_e, expand)
        nbrs = _expand(adj, sel_ids, sel_valid)
        cd = gathered_dists(q, data, nbrs, metric, norms)
        r_d, r_i, r_e = merge_into_retset(r_d, r_i, r_e, cd, nbrs)
        p_d, p_i, _ = merge_into_retset(p_d, p_i, p_e,
                                        *accepted_only(cd, nbrs))
        _hop_counts(hops, evals, sel_valid, nbrs)
    return BeamResult(p_d, p_i, hops, evals)


def beam_search_collect(
    queries: torch.Tensor,
    data: torch.Tensor,
    norms: torch.Tensor,
    adj: torch.Tensor,
    init_ids: torch.Tensor,
    width: int,
    collect: int,
    metric: str = "l2",
    max_hops: int = 512,
    expand: int = 1,
):
    """The JAX package's while-loop collect beam (beam.py:414-470):
    ``beam_search`` that also keeps the closest ``collect`` evaluated (id,
    dist) pairs, the sorted, deduplicated top-``collect`` pool of the
    reference's ``get_neighbors`` fullset (index_nsg.cpp:150-285). The
    pool starts from the init candidates and folds every hop's candidates
    with a throwaway selection, as in ``beam_search_collect_chunked``; the
    hops run on ``run_chunks`` with the while-loop's stopping rule and no
    compaction (the pool is indexed by the batch's rows).

    Returns (BeamResult, pool_ids [Q, collect], pool_dists [Q, collect]);
    ids, distances, hops and evals equal the JAX function's."""
    init_ids = init_ids.to(torch.int32)
    init_d, *state = _start(queries, data, norms, init_ids, width, metric,
                            expand)
    p_d, p_i, _ = init_retset(init_d, init_ids, collect)
    pool = [p_d, p_i]
    p_e0 = torch.zeros(p_d.shape, dtype=torch.bool, device=queries.device)

    def hop(q, sel_ids, sel_valid):
        nbrs = _expand(adj, sel_ids, sel_valid)
        cd = gathered_dists(q, data, nbrs, metric, norms)
        pool[0], pool[1], _, _, _ = fused_merge_select(
            pool[0], pool[1], p_e0, cd, nbrs, 1)
        return cd, nbrs

    res = run_chunks(queries, state, hop, width, max_hops, expand, 32,
                     queries.shape[0] + 1, max_hops)
    return res, pool[1], pool[0]


def random_fill_ids(gen: torch.Generator, n: int, shape, forbid=None):
    """Uniform random node ids in [0, n), int32, on the generator's device:
    the reference's random init fill (index_nsg.cpp:522-528; the JAX
    package's beam.py:558). ``forbid`` is not used: duplicates of ids
    already held are dropped by the retset dedup downstream."""
    return torch.randint(0, n, tuple(shape), generator=gen,
                         device=gen.device, dtype=torch.int32)
