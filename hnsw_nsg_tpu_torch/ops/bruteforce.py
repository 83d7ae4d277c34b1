"""Exact top-k search: one GEMM + running top-k per database tile
(counterpart of hnsw_nsg_tpu/ops/bruteforce.py: brute_force_topk,
brute_force_topk_approx, knn_graph_exact, recall).

It is the recall oracle of the port: f32 products with TF32 off.
"""

from __future__ import annotations

import numpy as np
import torch

from .distance import (PAD_DIST, PAD_ID, f32_dots, pairwise_dists,
                       squared_norms)
from .topk import topk_smallest, topk_smallest_wide

_Q_BLOCK = 4096


def brute_force_topk(
    q: torch.Tensor,
    x: torch.Tensor,
    k: int,
    metric: str = "l2",
    x_norms: torch.Tensor | None = None,
    valid_n: int | None = None,
    tile: int = 65536,
    exact: bool = True,
):
    """Exact k nearest of each query row. Returns (dists [Q, k] f32,
    ids [Q, k] int64). q: [Q, d]; x: [N, d] on the same device. Rows
    ``>= valid_n`` of x are ignored. Queries run in blocks of _Q_BLOCK
    rows to bound the [_Q_BLOCK, tile] distance tile; rows are
    independent, so blocking changes no result. Each tile's top-k is a
    selection, not a sort of the tile (``topk_smallest_wide``), merged
    into the running top-k: the same pairs in the same order as a stable
    sort of all distances, ties to the lower id."""
    n = x.shape[0]
    k = min(k, n)
    limit = n if valid_n is None else int(valid_n)
    if metric == "l2" and x_norms is None:
        x_norms = squared_norms(x)
    out_d, out_i = [], []
    for qs in range(0, q.shape[0], _Q_BLOCK):
        qb = q[qs : qs + _Q_BLOCK]
        nq = qb.shape[0]
        qn = squared_norms(qb) if (metric == "l2" and exact) else None
        best_d = torch.full((nq, k), float(PAD_DIST), device=q.device)
        best_i = torch.full((nq, k), PAD_ID, dtype=torch.int64,
                            device=q.device)
        for s in range(0, n, tile):
            e = min(s + tile, n)
            d = pairwise_dists(
                qb, x[s:e], metric,
                x_norms=x_norms[s:e] if metric == "l2" else None,
                exact=False,
            )
            if qn is not None:
                d = d + qn[:, None]
            if limit < e:
                d[:, max(limit - s, 0):] = float(PAD_DIST)
            # the tile's own top-k, then a merge of 2k: the top-k of
            # [best, tile] in (value, position) order keeps exactly these
            td, tpos = topk_smallest_wide(d, min(k, e - s))
            tid = tpos + s
            best_d, best_i = topk_smallest(
                torch.cat([best_d, td], 1),
                torch.cat([best_i, torch.where(tid < limit, tid, PAD_ID)], 1),
                k,
            )
        out_d.append(best_d)
        out_i.append(best_i)
    return torch.cat(out_d), torch.cat(out_i)


def brute_force_topk_approx(
    q: torch.Tensor,
    x: torch.Tensor,
    k: int,
    metric: str = "l2",
    x_norms: torch.Tensor | None = None,
    tile: int = 262144,
    recall_target: float = 0.95,
    use_bf16: bool = True,
):
    """The throughput form of the exact scan: with ``use_bf16`` the
    operands are rounded to bf16 (products and sums stay f32), and each
    database tile's top-k is merged into a running top-k. Returns
    (dists [Q, k] exact-form, ids [Q, k] int64).

    The JAX function takes each tile's top-k with ``jax.lax.approx_max_k``,
    a TPU partial reduce whose per-query recall is about
    ``recall_target``. That is TPU scaffolding: here every top-k is exact
    (a stable sort, ties to the lower id), so ``recall_target`` is taken
    for the signature and ignored."""
    n = x.shape[0]
    k = min(k, n)
    if metric == "l2" and x_norms is None:
        x_norms = squared_norms(x)
    dt = torch.bfloat16 if use_bf16 else torch.float32
    qc = q.to(dt)
    best_s = torch.full((q.shape[0], k), float("inf"), device=q.device)
    best_i = torch.full((q.shape[0], k), PAD_ID, dtype=torch.int64,
                        device=q.device)
    for s in range(0, n, tile):
        e = min(s + tile, n)
        dots = f32_dots(qc, x[s:e].to(dt))
        # the negated score, so that the smallest is the closest
        neg = 0.5 * x_norms[None, s:e] - dots if metric == "l2" else -dots
        ids = torch.arange(s, e, device=q.device).expand(q.shape[0], -1)
        best_s, best_i = topk_smallest(torch.cat([best_s, neg], 1),
                                       torch.cat([best_i, ids], 1), k)
    if metric == "l2":
        return squared_norms(q)[:, None] + 2.0 * best_s, best_i
    return 1.0 + best_s, best_i


def knn_graph_exact(x: torch.Tensor, k: int, metric: str = "l2",
                    tile: int = 65536, query_block: int = 4096):
    """Exact kNN graph (self edge removed) as a padded adjacency int32
    [N, k] on the device of ``x``: the oracle for graph quality."""
    n = x.shape[0]
    rows = []
    for s in range(0, n, query_block):
        q = x[s : s + query_block]
        _, ids = brute_force_topk(q, x, min(k + 1, n), metric=metric,
                                  tile=tile)
        self_col = torch.arange(s, s + q.shape[0], device=x.device)[:, None]
        not_self = ids != self_col
        # stable-compact the non-self entries to the left, keep k
        order = torch.sort((~not_self).to(torch.uint8), dim=1,
                           stable=True).indices
        ids = torch.gather(ids, 1, order)[:, :k]
        keep = torch.gather(not_self, 1, order)[:, :k]
        rows.append(torch.where(keep, ids, PAD_ID).to(torch.int32))
    return torch.cat(rows)


def recall(found_ids, gt_ids, k: int | None = None) -> float:
    """|found ∩ gt| / |gt| per query, averaged (the reference's recall
    accounting). Accepts tensors or numpy arrays."""
    found, gt = (t.cpu().long() if isinstance(t, torch.Tensor)
                 else torch.from_numpy(np.array(t, np.int64))
                 for t in (found_ids, gt_ids))
    if k is not None:
        found = found[:, :k]
        gt = gt[:, :k]
    hits = (found[:, :, None] == gt[:, None, :]) & (gt[:, None, :] >= 0)
    per_q = hits.any(1).sum(-1) / (gt >= 0).sum(-1).clamp(min=1)
    return float(per_q.double().mean())
