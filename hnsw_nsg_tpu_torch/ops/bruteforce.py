"""Exact top-k search: one GEMM + running top-k per database tile
(counterpart of hnsw_nsg_tpu/ops/bruteforce.py:brute_force_topk, recall).

It is the recall oracle of the port: f32 products with TF32 off.
"""

from __future__ import annotations

import numpy as np
import torch

from .distance import PAD_DIST, PAD_ID, pairwise_dists, squared_norms
from .topk import topk_smallest

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
    independent, so blocking changes no result."""
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
            ids = torch.arange(s, e, device=q.device)[None, :]
            valid = ids < limit
            d = torch.where(valid, d, PAD_DIST)
            ids = torch.where(valid, ids, PAD_ID).expand(nq, -1)
            best_d, best_i = topk_smallest(
                torch.cat([best_d, d], 1), torch.cat([best_i, ids], 1), k
            )
        out_d.append(best_d)
        out_i.append(best_i)
    return torch.cat(out_d), torch.cat(out_i)


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
